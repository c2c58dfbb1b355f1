"""Fused bias + leaky-ReLU: counterpart of `cips3d_tpu/ops/fused_act.py`.

``out = leaky_relu(x + bias, 0.2) * sqrt(2)``.  Plain PyTorch, as the JAX
package leaves it to XLA; differentiable to any order (R1 takes a gradient
of a gradient through it).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

SQRT2 = math.sqrt(2.0)


def fused_leaky_relu(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     negative_slope: float = 0.2, scale: float = SQRT2) -> torch.Tensor:
    """``leaky_relu(x + bias) * scale``; ``bias`` (C,) broadcasts over dim 1
    of an NCHW tensor and over the last dim of a (..., C) one."""
    if bias is not None:
        if x.dim() >= 3:
            x = x + bias.reshape((1, -1) + (1,) * (x.dim() - 2))
        else:
            x = x + bias
    return F.leaky_relu(x, negative_slope) * scale


def scaled_leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """``leaky_relu(x) * sqrt(2)``."""
    return F.leaky_relu(x, negative_slope) * SQRT2
