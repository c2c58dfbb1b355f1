"""PyTorch + CUDA port of the CIPS-3D generator's serving render.

Counterpart of the JAX package `cips3d_tpu`: the same modules, parameter
layouts and numerics, written with `torch` and numpy only.  The two Pallas
forwards on the render path are hand-written CUDA kernels for Hopper
(`csrc/`), each beside a plain PyTorch version of the same function
(`ops/ray_tile.py`, `ops/inr_tile.py`).  A wrapper runs the plain version
for tensors on the CPU and launches its kernel for tensors on a CUDA device.
"""
