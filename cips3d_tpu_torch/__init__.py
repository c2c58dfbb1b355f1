"""PyTorch + CUDA port of the CIPS-3D system: the serving render, the
training of the flagship and its variants (step, host loop, data, eval,
checkpoints, CLI), and the evaluation CLI with its apps (videos, the HTML
viewer, interpolation, shapes, inversion, FID).

Counterpart of the JAX package `cips3d_tpu`: the same modules, parameter
layouts and numerics, written with `torch` and numpy only.  The Pallas
kernels are hand-written CUDA kernels for Hopper (`csrc/`), each beside a
plain PyTorch version of the same function (`ops/ray_tile.py`,
`ops/inr_tile.py`).  A wrapper runs the plain version for tensors on the
CPU and launches its kernel for tensors on a CUDA device.
"""
