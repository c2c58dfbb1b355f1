"""PyTorch + CUDA port of the CIPS-3D system: the serving render and the
flagship's training (step, host loop, data, eval, checkpoints, CLI).

Counterpart of the JAX package `cips3d_tpu`: the same modules, parameter
layouts and numerics, written with `torch` and numpy only.  The Pallas
kernels are hand-written CUDA kernels for Hopper (`csrc/`), each beside a
plain PyTorch version of the same function (`ops/ray_tile.py`,
`ops/inr_tile.py`).  A wrapper runs the plain version for tensors on the
CPU and launches its kernel for tensors on a CUDA device.
"""
