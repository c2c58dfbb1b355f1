"""upfirdn2d (FIR filter, then downsample): counterpart of
`cips3d_tpu/ops/upfirdn2d.py`, NCHW only, for the separable kernels the
discriminator blurs with.

The JAX package computes this outside any Pallas kernel, and so does the
port, in plain PyTorch, with the JAX package's lowering of a separable
kernel: one small banded (out, in) matrix per axis (pad, correlate with
the flipped taps, stride by ``down``) and two matrix products.  They are
differentiable to any order, which R1's gradient of a gradient needs, and
keep that double backward fast: cuDNN runs the double backward of a
single-channel `F.conv2d` over N*C images as a slow implicit GEMM, which
took most of a training step's device time on the GPU.  The port has no
upsampling blur (the transposed convolution upsamples), so no ``up``.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple, Union

import numpy as np
import torch


def make_kernel(k: Union[Sequence[float], np.ndarray]) -> np.ndarray:
    """A normalised 2-D FIR kernel from a 1-D (outer product) or 2-D spec."""
    k = np.asarray(k, np.float32)
    if k.ndim == 1:
        k = k[None, :] * k[:, None]
    return k / np.sum(k)


def upfirdn2d(x: torch.Tensor, kernel, down: int = 1,
              pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """x (N, C, H, W), a separable 2-D ``kernel``; the same ``pad``
    (before, after) on both axes (negative pads crop).  Output size per
    axis: ``(in + pad0 + pad1 - k) // down + 1``."""
    _, _, h, w = x.shape
    u, s, vt = np.linalg.svd(np.asarray(kernel, np.float32))
    if not (s[0] > 0 and s[1:].max(initial=0.0) < 1e-6 * s[0]):
        raise NotImplementedError("upfirdn2d: only separable kernels are ported")
    p0, p1 = pad
    my = _axis_matrix(h, tuple((u[:, 0] * s[0]).tolist()), down, p0, p1)
    mx = _axis_matrix(w, tuple(vt[0].tolist()), down, p0, p1)
    my = torch.as_tensor(my, dtype=x.dtype, device=x.device)
    mx = torch.as_tensor(mx, dtype=x.dtype, device=x.device)
    return torch.einsum("ncow,pw->ncop", torch.einsum("oh,nchw->ncow", my, x), mx)


@functools.lru_cache(maxsize=None)
def _axis_matrix(in_size: int, k1d: Tuple[float, ...], down: int, pad0: int,
                 pad1: int) -> np.ndarray:
    """(out, in) matrix of the 1-D upfirdn on one axis: pad, correlate with
    the flipped taps, stride by ``down``."""
    kflip = k1d[::-1]
    out_size = (in_size + pad0 + pad1 - len(k1d)) // down + 1
    m = np.zeros((out_size, in_size), np.float32)
    for o in range(out_size):
        for t, tap in enumerate(kflip):
            j = o * down + t - pad0
            if 0 <= j < in_size:
                m[o, j] += tap
    return m


def blur_pad_down(kernel_1d: Sequence[float], kernel_size: int, factor: int = 2):
    """Padding before a stride-2 conv."""
    p = (len(kernel_1d) - factor) + (kernel_size - 1)
    return ((p + 1) // 2, p // 2)


def blur_pad_up(kernel_1d: Sequence[float], kernel_size: int, factor: int = 2):
    """Padding after a stride-2 transposed conv."""
    p = (len(kernel_1d) - factor) - (kernel_size - 1)
    return ((p + 1) // 2 + factor - 1, p // 2 + 1)
