"""upfirdn2d (zero-stuff by ``up``, pad, FIR filter, stride by ``down``):
counterpart of `cips3d_tpu/ops/upfirdn2d.py`, NCHW only.

The JAX package computes this outside any Pallas kernel, and so does the
port, in plain PyTorch, with the JAX package's two lowerings:
  * a separable kernel (every blur of the discriminator) becomes one small
    banded (out, in) matrix per axis (zero-stuff, pad, correlate with the
    flipped taps, stride) and two matrix products.  The matrices are in the
    input's dtype and the products accumulate in f32, each rounded back to
    the input's dtype, as the JAX einsums with ``preferred_element_type``
    do.  They are differentiable to any order, which R1's gradient of a
    gradient needs, and keep that double backward fast: cuDNN runs the
    double backward of a single-channel `F.conv2d` over N*C images as a
    slow implicit GEMM, which took most of a training step's device time on
    the GPU;
  * any other kernel runs as a depthwise convolution of the zero-stuffed,
    padded input.
The matrices and taps are made once per shape, kernel, dtype and device
(`on_device`): a copy from host memory on every call would cost a
transfer a call and is refused inside a CUDA-graph capture.
The JAX function's ``data_format="NHWC"`` is not ported: its only users
are the JAX discriminator's layout option and a TPU layout A/B tool.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F


def make_kernel(k: Union[Sequence[float], np.ndarray]) -> np.ndarray:
    """A normalised 2-D FIR kernel from a 1-D (outer product) or 2-D spec."""
    k = np.asarray(k, np.float32)
    if k.ndim == 1:
        k = k[None, :] * k[:, None]
    return k / np.sum(k)


def upfirdn2d(x: torch.Tensor, kernel, down: int = 1,
              pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """x (N, C, H, W); the same ``down`` and ``pad`` (before, after;
    negative pads crop) on both axes.  Output size per axis:
    ``(in + pad0 + pad1 - k) // down + 1``."""
    return upfirdn2d_general(x, kernel, 1, 1, down, down, pad[0], pad[1], pad[0], pad[1])


_ON_DEVICE = {}


def on_device(key, make, dtype: torch.dtype, device) -> torch.Tensor:
    """``make()`` (a numpy array) as a ``dtype`` tensor on ``device``, made at
    the first call for ``key`` and reused after."""
    full = (key, dtype, torch.device(device))
    t = _ON_DEVICE.get(full)
    if t is None:
        t = _ON_DEVICE[full] = torch.as_tensor(make(), dtype=dtype, device=device)
    return t


@functools.lru_cache(maxsize=None)
def _separable(shape: Tuple[int, int], data: bytes):
    """The (column, row) taps of a rank-1 kernel (its SVD's first pair),
    or None."""
    k = np.frombuffer(data, np.float32).reshape(shape)
    u, s, vt = np.linalg.svd(k)
    if s[0] > 0 and s[1:].max(initial=0.0) < 1e-6 * s[0]:
        return tuple((u[:, 0] * s[0]).tolist()), tuple(vt[0].tolist())
    return None


def upfirdn2d_general(x: torch.Tensor, kernel, up_x: int, up_y: int, down_x: int, down_y: int,
                      pad_x0: int, pad_x1: int, pad_y0: int, pad_y1: int) -> torch.Tensor:
    """x (N, C, H, W); the 2-D ``kernel`` (kh, kw) applies to every
    channel."""
    n, c, h, w = x.shape
    k = np.ascontiguousarray(kernel, np.float32)
    kid = (k.shape, k.tobytes())
    taps = _separable(*kid)
    if taps is not None:
        ay, ax = (h, taps[0], up_y, down_y, pad_y0, pad_y1), (w, taps[1], up_x, down_x, pad_x0,
                                                               pad_x1)
        my, mx = (on_device(("axis",) + a, lambda a=a: _axis_matrix(*a), x.dtype, x.device)
                  .float() for a in (ay, ax))
        t = torch.einsum("oh,nchw->ncow", my, x.float()).to(x.dtype)
        return torch.einsum("ncow,pw->ncop", t.float(), mx).to(x.dtype)
    if up_x > 1 or up_y > 1:   # zero-stuff to (h * up_y, w * up_x), trailing zeros included
        stuffed = x.new_zeros((n, c, h * up_y, w * up_x))
        stuffed[:, :, ::up_y, ::up_x] = x
        x = stuffed
    x = F.pad(x, (pad_x0, pad_x1, pad_y0, pad_y1))   # negative pads crop
    weight = on_device(("taps",) + kid, lambda: np.ascontiguousarray(k[::-1, ::-1]), x.dtype,
                       x.device)
    return F.conv2d(x, weight.expand(c, 1, *k.shape), stride=(down_y, down_x), groups=c)


@functools.lru_cache(maxsize=None)
def _axis_matrix(in_size: int, k1d: Tuple[float, ...], up: int, down: int, pad0: int,
                 pad1: int) -> np.ndarray:
    """(out, in) matrix of the 1-D upfirdn on one axis: zero-stuff by ``up``
    (to in * up, trailing zeros included), pad, correlate with the flipped
    taps, stride by ``down``."""
    kflip = k1d[::-1]
    out_size = (in_size * up + pad0 + pad1 - len(k1d)) // down + 1
    m = np.zeros((out_size, in_size), np.float32)
    for o in range(out_size):
        for t, tap in enumerate(kflip):
            j = o * down + t - pad0
            if 0 <= j < in_size * up and j % up == 0:
                m[o, j // up] += tap
    return m


def blur_pad_down(kernel_1d: Sequence[float], kernel_size: int, factor: int = 2):
    """Padding before a stride-2 conv."""
    p = (len(kernel_1d) - factor) + (kernel_size - 1)
    return ((p + 1) // 2, p // 2)


def blur_pad_up(kernel_1d: Sequence[float], kernel_size: int, factor: int = 2):
    """Padding after a stride-2 transposed conv."""
    p = (len(kernel_1d) - factor) - (kernel_size - 1)
    return ((p + 1) // 2 + factor - 1, p // 2 + 1)
