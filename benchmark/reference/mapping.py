"""The multi-head style mapping network of the CIPS-3D generator.

PixelNorm → ``base_layers`` x [Linear(kaiming-leaky) (+LayerNorm if
add_norm) → LeakyReLU(0.2)], where the last base layer gets neither, then a
final LayerNorm with ``norm_out``.  Every head shares the base feature; the
``base_net`` Sequential keeps the reference's state-dict slot indices.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch import nn

from . import init as winit
from .layers import (EqualLinear, LayerNormTorch, PixelNorm, TorchLinear,
                                            leaky_relu)


class MultiHeadMappingNetwork(nn.Module):
    """z → {head_name: style vector}."""

    def __init__(self, z_dim: int, hidden_dim: int, base_layers: int,
                 head_dim_dict: Mapping[str, int], add_norm: bool = False, norm_out: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pixel_norm = PixelNorm()
        seq = []
        in_dim = z_dim
        for i in range(base_layers):
            seq.append(TorchLinear(in_dim, hidden_dim, kernel_init=winit.kaiming_leaky_kernel,
                                   generator=generator, dtype=dtype))
            in_dim = hidden_dim
            if i != base_layers - 1:
                if add_norm:
                    seq.append(LayerNormTorch(hidden_dim))
                seq.append(nn.LeakyReLU(0.2))
        if base_layers > 0 and norm_out:
            seq.append(LayerNormTorch(hidden_dim))
        self.base_net = nn.Sequential(*seq)
        self.head_names = tuple(head_dim_dict)
        self.dtype = dtype

    def forward(self, z: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.base_net(self.pixel_norm(z.to(self.dtype)))
        return {name: x for name in self.head_names}
