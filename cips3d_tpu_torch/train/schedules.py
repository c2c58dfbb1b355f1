"""Training schedules: counterpart of `cips3d_tpu/train/schedules.py`.

As the JAX forms take a traced step, these take the step as a tensor (an
int also works) and return float32 scalars on its device, so that a CUDA
graph of a training step replays with each step's own values.  They round
as XLA compiles the JAX forms, so that the two agree bit for bit: a
division by the constant is a product with its float32 reciprocal, and
``1 - step * r`` is one fused multiply-add (here in float64, exact for
steps below 2^29, rounded to float32 once).
"""

from __future__ import annotations

import numpy as np
import torch


def _recip(x: float) -> float:
    """The float32 reciprocal of ``x``, as a Python float."""
    return float(np.float32(1.0 / x))


def nerf_noise_schedule(step, disable: bool = False) -> torch.Tensor:
    """max(0, 1 - step / 5000): the NeRF density noise (0 under ``disable``)."""
    step = torch.as_tensor(step)
    if disable:
        return torch.zeros((), device=step.device)
    return torch.clamp((1.0 - step.double() * _recip(5000.0)).float(), min=0.0)


def alpha_schedule(step, warmup_d: bool, fade_steps: int = 10000) -> torch.Tensor:
    """min(1, step / fade_steps) under warmup_d, else 1: the D fade-in."""
    step = torch.as_tensor(step)
    if not warmup_d:
        return torch.ones((), device=step.device)
    return torch.clamp((step.double() * _recip(fade_steps)).float(), max=1.0)
