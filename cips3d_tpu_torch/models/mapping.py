"""Multi-head style mapping networks: counterparts of
`cips3d_tpu/models/mapping.py::MultiHeadMappingNetwork` and
`MultiHeadMappingNetworkEqualLR`.

PixelNorm → ``base_layers`` x [Linear(kaiming-leaky) (+LayerNorm if
add_norm) → LeakyReLU(0.2)], where the last base layer gets neither, then a
final LayerNorm with ``norm_out`` (`LayerNormTorch`: in f32, then back to
the compute dtype, as flax's; CUDA's layer norm refuses a bf16 input with
f32 parameters).  Only ``head_layers == 0`` is ported (the
flagship uses it for both nets): every head shares the base feature.  The
``base_net`` Sequential reproduces the reference's state-dict slot indices.
The equalised-lr variant keeps the JAX package's layer names (``base.{i}``
for ``base_{i}``, ``heads.{name}.{i}`` for ``head_{name}_{i}``), into which
`utils/convert.py::mapping_equal_lr_state_dict` loads its parameters.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch import nn

from cips3d_tpu_torch.models import init as winit
from cips3d_tpu_torch.models.layers import (EqualLinear, LayerNormTorch, PixelNorm, TorchLinear,
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


class MultiHeadMappingNetworkEqualLR(nn.Module):
    """The equalised-lr mapping of the reference's
    ``MultiHeadMappingNetwork_EqualLR``: PixelNorm → ``base_layers``
    EqualLinear (lr_mul ``lr_mlp``, forward scale ``scale``, which overrides
    EqualLinear's lr_mul / sqrt(in) as the reference's default 1.0 does), a
    leaky ReLU 0.2 after each but the last when there are no heads → per head
    ``head_layers`` EqualLinear (lr_mul ``lr_mlp``) with a leaky ReLU between
    them.  With ``base_layers == 0`` ``z`` carries one latent a head on its
    leading axis, each pixel-normed."""

    def __init__(self, z_dim: int, hidden_dim: int, base_layers: int, head_layers: int,
                 head_dim_dict: Mapping[str, int], lr_mlp: float = 1.0, scale: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pixel_norm = PixelNorm()
        self.base = nn.ModuleList(
            EqualLinear(z_dim if i == 0 else hidden_dim, hidden_dim, lr_mul=lr_mlp, scale=scale,
                        generator=generator, dtype=dtype) for i in range(base_layers))
        in_dim = hidden_dim if base_layers > 0 else z_dim
        self.heads = nn.ModuleDict({
            name: nn.ModuleList(
                EqualLinear(in_dim if i == 0 else hidden_dim,
                            head_dim if i == head_layers - 1 else hidden_dim, lr_mul=lr_mlp,
                            generator=generator, dtype=dtype) for i in range(head_layers))
            for name, head_dim in head_dim_dict.items()})
        self.head_names, self.head_layers, self.dtype = tuple(head_dim_dict), head_layers, dtype

    def forward(self, z: torch.Tensor) -> Dict[str, torch.Tensor]:
        if len(self.base):
            x = self.pixel_norm(z.to(self.dtype))
            for i, layer in enumerate(self.base):
                x = layer(x)
                if self.head_layers > 0 or i != len(self.base) - 1:
                    x = leaky_relu(x)
            inputs = {name: x for name in self.head_names}
        else:
            inputs = {name: self.pixel_norm(z[i].to(self.dtype))
                      for i, name in enumerate(self.head_names)}
        out = {}
        for name in self.head_names:
            h = inputs[name]
            for i, layer in enumerate(self.heads[name]):
                h = layer(h)
                if i != self.head_layers - 1:
                    h = leaky_relu(h)
            out[name] = h
        return out
