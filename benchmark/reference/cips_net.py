"""CIPS-style per-pixel INR decoder: counterpart of
`cips3d_tpu/models/cips_net.py` (`CIPSNet`, `SinBlock`).

Nine SinBlocks keyed "4".."1024", each two (SinStyleMod + LeakyReLU) stages
with a residual skip from block index 4; a per-block ToRGB accumulates RGB
from index 3; the loop exits early at ``img_size``; then tanh.  As in the
reference, ``to_rgbs`` holds a head for every block, and the first three
are never used.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
from torch import nn

from . import init as winit
from .layers import SinStyleMod, ToRGB, TorchLinear, leaky_relu

CIPS_RESOLUTIONS = ("4", "8", "16", "32", "64", "128", "256", "512", "1024")
FIRST_RGB = 3    # ToRGB accumulation from this block index
FIRST_SKIP = 4   # residual skip from this block index


class SinBlock(nn.Module):
    """Two modulated-FC stages with an optional residual skip."""

    def __init__(self, in_dim: int, out_dim: int, style_dim: int,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mod1 = SinStyleMod(in_dim, out_dim, style_dim, generator=generator, dtype=dtype)
        self.mod2 = SinStyleMod(out_dim, out_dim, style_dim, generator=generator, dtype=dtype)

    def forward(self, x, style0, style1, skip: bool = False):
        out = leaky_relu(self.mod2(leaky_relu(self.mod1(x, style0)), style1))
        if skip and out.shape[-1] == x.shape[-1]:
            out = out + x
        return out


class CIPSNet(nn.Module):
    """Feature image (b, n, input_dim) + styles → RGB (b, n, 3)."""

    def __init__(self, input_dim: int = 32, hidden_dim: int = 512, style_dim: int = 512,
                 pre_rgb_dim: int = 3, name_prefix: str = "inr",
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.network = nn.ModuleDict({
            res: SinBlock(input_dim if i == 0 else hidden_dim, hidden_dim, style_dim,
                          generator=generator, dtype=dtype)
            for i, res in enumerate(CIPS_RESOLUTIONS)
        })
        self.to_rgbs = nn.ModuleDict({
            res: ToRGB(hidden_dim, pre_rgb_dim, generator=generator, dtype=dtype)
            for res in CIPS_RESOLUTIONS
        })
        if pre_rgb_dim > 3:
            self.tanh = nn.Sequential(TorchLinear(
                pre_rgb_dim, 3, kernel_init=winit.frequency_kernel(100.0),
                generator=generator, dtype=dtype))
        self.pre_rgb_dim = pre_rgb_dim
        self.name_prefix = name_prefix
        self.dtype = dtype

    def forward(self, x: torch.Tensor, style_dict: Mapping[str, torch.Tensor],
                img_size: int = 1024) -> torch.Tensor:
        """Blocks beyond ``img_size`` are skipped; the render path passes
        no img_size, so all nine blocks run."""
        stop = str(2 ** int(math.log2(img_size)))
        p = self.name_prefix
        rgb = None
        for idx, res in enumerate(CIPS_RESOLUTIONS):
            x = self.network[res](
                x,
                style_dict[f"{p}_w{res}_0"].to(self.dtype),
                style_dict[f"{p}_w{res}_1"].to(self.dtype),
                skip=idx >= FIRST_SKIP,
            )
            if idx >= FIRST_RGB:
                rgb = self.to_rgbs[res](x, skip=rgb)
            if res == stop:
                break
        if self.pre_rgb_dim > 3:
            rgb = self.tanh(rgb)
        return torch.tanh(rgb)
