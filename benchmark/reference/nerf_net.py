"""FiLM-SIREN NeRF backbone: counterpart of
`cips3d_tpu/models/nerf_net.py::NeRFNetwork`.

UniformBoxWarp(0.24) → ``hidden_layers`` FiLM-SIREN layers (0 allowed) →
sigma linear;
colour branch: FiLM-SIREN (hidden → ``color_hidden_dim``, default
hidden/2) → linear(kaiming-leaky) → ``rgb_dim`` feature.  Style keys ``nerf_w{i}`` per hidden layer and
``nerf_rgb`` for the colour FiLM.  With ``fused_ray`` this module only
holds the weights (`ops/ray_tile.py` runs its math inside the ray-tile
kernel); the unfused NeRF stage calls `forward`.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

from . import init as winit
from .layers import FiLMSineLayer, TorchLinear, uniform_box_warp


class NeRFNetwork(nn.Module):
    """Style-modulated SIREN with a sigma head and an rgb-feature head."""

    def __init__(self, hidden_dim: int = 128, hidden_layers: int = 2, rgb_dim: int = 32,
                 style_dim: int = 128, box_sidelength: float = 0.24,
                 name_prefix: str = "nerf", fast_sin: bool = False,
                 color_hidden_dim: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.network = nn.ModuleList(
            FiLMSineLayer(3 if i == 0 else hidden_dim, hidden_dim, style_dim,
                          fast_sin=fast_sin, generator=generator, dtype=dtype)
            for i in range(hidden_layers)
        )
        trunk_dim = hidden_dim if hidden_layers else 3   # depth 0: the heads read the points
        self.final_layer = TorchLinear(trunk_dim, 1, generator=generator, dtype=dtype)
        # NeRFNetworkL (models/nerf_variants.py) keeps the full hidden width
        color_dim = hidden_dim // 2 if color_hidden_dim is None else color_hidden_dim
        self.color_layer_sine = FiLMSineLayer(trunk_dim, color_dim, style_dim,
                                              fast_sin=fast_sin, generator=generator,
                                              dtype=dtype)
        self.color_layer_linear = nn.Sequential(
            TorchLinear(color_dim, rgb_dim, kernel_init=winit.kaiming_leaky_kernel,
                        generator=generator, dtype=dtype)
        )
        self.box_sidelength = box_sidelength
        self.name_prefix = name_prefix
        self.dtype = dtype

    def forward(self, points: torch.Tensor, style_dict: Mapping[str, torch.Tensor]):
        """points (b, n, 3) → (rgb (b, n, rgb_dim), sigma (b, n, 1))."""
        p = self.name_prefix
        x = uniform_box_warp(points.to(self.dtype), self.box_sidelength)
        for i, layer in enumerate(self.network):
            x = layer(x, style_dict[f"{p}_w{i}"].to(self.dtype))
        sigma = self.final_layer(x)
        c = self.color_layer_sine(x, style_dict[f"{p}_rgb"].to(self.dtype))
        return self.color_layer_linear(c), sigma
