"""Generator EMA: counterpart of `cips3d_tpu/core/ema.py`.

The EMA copy starts as a copy of the generator and stays frozen until
``start_itr``; afterwards ``ema = ema * decay + param * (1 - decay)``, in
place.
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
def ema_update(ema: nn.Module, model: nn.Module, step: int, decay: float = 0.999,
               start_itr: int = 1000) -> None:
    """One EMA step: a no-op before ``start_itr``, then the lerp."""
    if step < start_itr:
        return
    for e, p in zip(ema.parameters(), model.parameters()):
        e.copy_(e * decay + p.to(e.dtype) * (1.0 - decay))
