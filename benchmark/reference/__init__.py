"""The plain reference the benchmark holds the program to: frozen copies of
the published CIPS-3D generator, discriminator, losses and R1 in plain
PyTorch float32, with its own training step.  It imports nothing of the
program (`cips3d_tpu_torch`) or of the JAX package."""
