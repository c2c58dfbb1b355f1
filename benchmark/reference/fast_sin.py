"""Range-reduced polynomial sine for the SIREN hot path.

Counterpart of `cips3d_tpu/ops/fast_sin.py` (same constants, same f32
internals):

    y = x / 2pi;  r = y - round(y)  in [-0.5, 0.5];  sin(x) = r * P(r^2)

with P the degree-9 odd least-squares fit (max abs error 1.7e-5), and
its derivative `fast_sin_grad` (of the polynomial, not cos), which the
ray-tile backward uses under ``fast_sin``.  The
internals stay float32 for every input dtype: in bf16 the reduction
`y - round(y)` would quantize the reduced argument to y's ULP.  `round` is
half-to-even (`torch.round`, `jnp.round`; `rintf` in `csrc/fast_sin.cuh`).
"""

from __future__ import annotations

import torch

_INV_2PI = 0.15915494309189535
_C1 = 6.283088463027395
_C3 = -41.33324754221887
_C5 = 81.40008976706686
_C7 = -74.67588386951022
_C9 = 33.16809461334938


def fast_sin(x: torch.Tensor) -> torch.Tensor:
    """Approximate elementwise sine, computed in float32 and cast back to
    ``x.dtype``."""
    y = x.float() * _INV_2PI
    r = y - torch.round(y)
    r2 = r * r
    p = torch.full_like(r2, _C9)
    p = p * r2 + _C7
    p = p * r2 + _C5
    p = p * r2 + _C3
    p = p * r2 + _C1
    return (r * p).to(x.dtype)


def fast_sin_grad(x: torch.Tensor) -> torch.Tensor:
    """d fast_sin / dx, the derivative of the polynomial itself (what
    autograd gives for `fast_sin`, not cos): with r the reduced argument,
    (1/2pi) * (P(r^2) + 2 r^2 P'(r^2)).  float32 internals, cast back to
    ``x.dtype``."""
    y = x.float() * _INV_2PI
    r = y - torch.round(y)
    r2 = r * r
    p = torch.full_like(r2, _C9)
    p = p * r2 + _C7
    p = p * r2 + _C5
    p = p * r2 + _C3
    p = p * r2 + _C1
    dp = torch.full_like(r2, 4.0 * _C9)
    dp = dp * r2 + 3.0 * _C7
    dp = dp * r2 + 2.0 * _C5
    dp = dp * r2 + _C3
    return (_INV_2PI * (p + 2.0 * r2 * dp)).to(x.dtype)
