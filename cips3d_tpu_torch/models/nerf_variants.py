"""Alternative NeRF backbones: counterparts of
`cips3d_tpu/models/nerf_variants.py` (the reference's dev variants).

  * `NeRFNetworkCLN`: the FiLM-sine layers replaced by Linear → conditional
    LayerNorm → LeakyReLU (`CLNLayer`), the same sigma / rgb-feature heads;
  * `FreqPhaseFiLM`, `NeRFNetworkFreqPhase`: one style vector a layer
    carries raw (frequency, phase) halves, frequency = raw * 15 + 30; an
    optional positional embedding of xyz;
  * `NeRFNetworkSmall`, `NeRFNetworkL`: `NeRFNetwork` with one hidden layer
    of 64, and with a colour FiLM of full hidden width;
  * `LinearSinAct`, `NeRFNetworkSigma`: only the sigma path is
    style-conditioned; the colour branch is an unconditioned Linear → sin
    on the warped input.

Every backbone but Small and L returns ``cat([rgb, sigma], -1)`` (b, n,
rgb_dim + 1), as the JAX modules do; those two are `NeRFNetwork`s, which
return ``(rgb, sigma)`` and carry the reference's state-dict layout
(`utils/convert.py::siren_state_dict`).  The others carry the JAX names
(`utils/convert.py::tree_state_dict`).
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

from cips3d_tpu_torch.models import init as winit
from cips3d_tpu_torch.models.layers import FiLMSineLayer, TorchLinear, uniform_box_warp
from cips3d_tpu_torch.models.legacy import CLNLayer, PosEmbedding
from cips3d_tpu_torch.models.nerf_net import NeRFNetwork


class NeRFNetworkCLN(nn.Module):
    """CLN-conditioned NeRF backbone; style keys ``{prefix}_w{i}`` and
    ``{prefix}_rgb``."""

    def __init__(self, hidden_dim: int = 128, hidden_layers: int = 2, rgb_dim: int = 32,
                 style_dim: int = 128, box_sidelength: float = 0.24, name_prefix: str = "nerf",
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i in range(hidden_layers):
            self.add_module(f"cln_{i}", CLNLayer(3 if i == 0 else hidden_dim, hidden_dim,
                                                 style_dim, generator=generator, dtype=dtype))
        trunk = hidden_dim if hidden_layers else 3
        self.sigma = TorchLinear(trunk, 1, generator=generator, dtype=dtype)
        self.color_cln = CLNLayer(trunk, hidden_dim // 2, style_dim, generator=generator,
                                  dtype=dtype)
        self.color_linear = TorchLinear(hidden_dim // 2, rgb_dim,
                                        kernel_init=winit.kaiming_leaky_kernel,
                                        generator=generator, dtype=dtype)
        self.hidden_layers = hidden_layers
        self.box_sidelength = box_sidelength
        self.name_prefix = name_prefix
        self.dtype = dtype

    def forward(self, points: torch.Tensor, style_dict: Mapping[str, torch.Tensor]):
        p = self.name_prefix
        x = uniform_box_warp(points.to(self.dtype), self.box_sidelength)
        for i in range(self.hidden_layers):
            x = getattr(self, f"cln_{i}")(x, style_dict[f"{p}_w{i}"].to(self.dtype))
        sigma = self.sigma(x)
        rgb = self.color_linear(self.color_cln(x, style_dict[f"{p}_rgb"].to(self.dtype)))
        return torch.cat([rgb, sigma], -1)


class FreqPhaseFiLM(nn.Module):
    """``sin(freq * Wx + phase)``, the (freq, phase) halves packed in one
    style vector, freq = raw * 15 + 30."""

    def __init__(self, in_dim: int, out_dim: int, freq_init: float = 25.0,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.linear = TorchLinear(in_dim, out_dim, kernel_init=winit.frequency_kernel(freq_init),
                                  generator=generator, dtype=dtype)

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        h = self.linear(x)
        freq_raw, phase = torch.chunk(style, 2, -1)
        freq = freq_raw * 15.0 + 30.0
        if x.dim() == 3:
            freq, phase = freq[:, None, :], phase[:, None, :]
        return torch.sin(freq * h + phase)


class NeRFNetworkFreqPhase(nn.Module):
    """Freq/phase-styled backbone with an optional positional embedding;
    style keys ``{prefix}_w{i}`` (2 * hidden) and ``{prefix}_rgb``
    (2 * (hidden // 2))."""

    def __init__(self, hidden_dim: int = 128, hidden_layers: int = 2, rgb_dim: int = 32,
                 use_pos_embed: bool = False, box_sidelength: float = 0.24,
                 name_prefix: str = "nerf", generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pos_embed = PosEmbedding(max_logscale=9, n_freqs=10) if use_pos_embed else None
        in_dim = self.pos_embed.out_dim if use_pos_embed else 3
        for i in range(hidden_layers):
            self.add_module(f"film_{i}", FreqPhaseFiLM(in_dim if i == 0 else hidden_dim,
                                                       hidden_dim, generator=generator,
                                                       dtype=dtype))
        trunk = hidden_dim if hidden_layers else in_dim
        self.sigma = TorchLinear(trunk, 1, generator=generator, dtype=dtype)
        self.color_film = FreqPhaseFiLM(trunk, hidden_dim // 2, generator=generator, dtype=dtype)
        self.color_linear = TorchLinear(hidden_dim // 2, rgb_dim,
                                        kernel_init=winit.kaiming_leaky_kernel,
                                        generator=generator, dtype=dtype)
        self.hidden_layers = hidden_layers
        self.box_sidelength = box_sidelength
        self.name_prefix = name_prefix
        self.dtype = dtype

    def forward(self, points: torch.Tensor, style_dict: Mapping[str, torch.Tensor]):
        p = self.name_prefix
        x = uniform_box_warp(points.to(self.dtype), self.box_sidelength)
        if self.pos_embed is not None:
            x = self.pos_embed(x)
        for i in range(self.hidden_layers):
            x = getattr(self, f"film_{i}")(x, style_dict[f"{p}_w{i}"].to(self.dtype))
        sigma = self.sigma(x)
        rgb = self.color_linear(self.color_film(x, style_dict[f"{p}_rgb"].to(self.dtype)))
        return torch.cat([rgb, sigma], -1)


def NeRFNetworkSmall(**kwargs) -> NeRFNetwork:
    """The one-hidden-layer budget variant."""
    kwargs.setdefault("hidden_layers", 1)
    kwargs.setdefault("hidden_dim", 64)
    return NeRFNetwork(**kwargs)


def NeRFNetworkL(**kwargs) -> NeRFNetwork:
    """The wide-colour variant: the colour FiLM keeps the full hidden width
    instead of hidden_dim // 2."""
    kwargs.setdefault("hidden_dim", 128)
    kwargs.setdefault("color_hidden_dim", kwargs["hidden_dim"])
    return NeRFNetwork(**kwargs)


class LinearSinAct(nn.Module):
    """Linear → sin."""

    def __init__(self, in_dim: int, out_dim: int, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.linear = TorchLinear(in_dim, out_dim, generator=generator, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sin(self.linear(x))


class NeRFNetworkSigma(nn.Module):
    """Only the sigma path is style-conditioned (FiLM-sine stack → Linear
    sigma); the colour branch is an unconditioned `LinearSinAct` on the
    warped input, then a kaiming-leaky Linear.  Style keys ``{prefix}_w{i}``
    only."""

    def __init__(self, hidden_dim: int = 128, hidden_layers: int = 2, rgb_dim: int = 3,
                 style_dim: int = 128, box_sidelength: float = 0.24, name_prefix: str = "nerf",
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i in range(hidden_layers):
            self.add_module(f"film_{i}", FiLMSineLayer(3 if i == 0 else hidden_dim, hidden_dim,
                                                       style_dim, generator=generator,
                                                       dtype=dtype))
        self.sigma = TorchLinear(hidden_dim if hidden_layers else 3, 1, generator=generator,
                                 dtype=dtype)
        self.color_sine = LinearSinAct(3, hidden_dim // 2, generator=generator, dtype=dtype)
        self.color_linear = TorchLinear(hidden_dim // 2, rgb_dim,
                                        kernel_init=winit.kaiming_leaky_kernel,
                                        generator=generator, dtype=dtype)
        self.hidden_layers = hidden_layers
        self.box_sidelength = box_sidelength
        self.name_prefix = name_prefix
        self.dtype = dtype

    def forward(self, points: torch.Tensor, style_dict: Mapping[str, torch.Tensor]):
        warped = uniform_box_warp(points.to(self.dtype), self.box_sidelength)
        x = warped
        for i in range(self.hidden_layers):
            x = getattr(self, f"film_{i}")(x, style_dict[f"{self.name_prefix}_w{i}"].to(self.dtype))
        sigma = self.sigma(x)
        rgb = self.color_linear(self.color_sine(warped))
        return torch.cat([rgb, sigma], -1)
