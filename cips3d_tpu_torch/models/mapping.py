"""Multi-head style mapping network: counterpart of
`cips3d_tpu/models/mapping.py::MultiHeadMappingNetwork`.

PixelNorm → ``base_layers`` x [Linear(kaiming-leaky) (+LayerNorm if
add_norm) → LeakyReLU(0.2)], where the last base layer gets neither, then a
final LayerNorm with ``norm_out``.  Only ``head_layers == 0`` is ported (the
flagship uses it for both nets): every head shares the base feature.  The
``base_net`` Sequential reproduces the reference's state-dict slot indices.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch import nn

from cips3d_tpu_torch.models import init as winit
from cips3d_tpu_torch.models.layers import PixelNorm, TorchLinear


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
                    seq.append(nn.LayerNorm(hidden_dim, eps=1e-5))
                seq.append(nn.LeakyReLU(0.2))
        if base_layers > 0 and norm_out:
            seq.append(nn.LayerNorm(hidden_dim, eps=1e-5))
        self.base_net = nn.Sequential(*seq)
        self.head_names = tuple(head_dim_dict)
        self.dtype = dtype

    def forward(self, z: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.base_net(self.pixel_norm(z.to(self.dtype)))
        return {name: x for name in self.head_names}
