"""Generator EMA: counterpart of `cips3d_tpu/core/ema.py`.

The EMA copy starts as a copy of the generator and stays frozen until
``start_itr``; afterwards ``ema = ema * decay + param * (1 - decay)``.  As
in JAX, the gate is a select on the step (``torch.where(step >=
start_itr, lerp, ema)``), so a step on the device decides it inside a CUDA
graph; the result is written in place.
"""

from __future__ import annotations

import copy

import torch
from torch import nn


def ema_copy(model: nn.Module) -> nn.Module:
    """A detached deep copy of ``model`` (its parameters need no grad)."""
    ema = copy.deepcopy(model)
    ema.requires_grad_(False)
    return ema


@torch.no_grad()
def ema_update(ema: nn.Module, model: nn.Module, step, decay: float = 0.999,
               start_itr: int = 1000) -> None:
    """One EMA step at ``step`` (an int or a tensor on the modules' device):
    the lerp from ``start_itr`` on, the EMA unchanged before."""
    on = None
    for e, p in zip(ema.parameters(), model.parameters()):
        if on is None:
            on = torch.as_tensor(step, device=e.device) >= start_itr
        e.copy_(torch.where(on, e * decay + p.to(e.dtype) * (1.0 - decay), e))
