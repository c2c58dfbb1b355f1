"""Model interpolation by INR layer swapping.  Counterpart of
`cips3d_tpu/apps/interpolation.py` (`inr_layer_swapping`,
`exp/comm/comm_utils.py:28-51`, and the web demo that uses it,
`scripts/web_demo.py:30-193`): the INR decoder's per-resolution blocks and
their ToRGB heads of a source generator are lerped toward a target
generator by ``gamma``, e.g. FFHQ geometry with CartoonFaces texture.
"""

from __future__ import annotations

import copy
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch

from cips3d_tpu_torch.apps.render import Draws, render_frame, seed_styles
from cips3d_tpu_torch.models.generator import GeneratorNerfINR, RenderOptions
from cips3d_tpu_torch.utils import image_io


def inr_layer_swapping(source: GeneratorNerfINR, target: GeneratorNerfINR, gamma: float,
                       layers: Sequence[str]) -> GeneratorNerfINR:
    """A copy of ``source`` whose INR blocks ``inr_net.network.{res}`` and
    heads ``inr_net.to_rgbs.{res}`` for each resolution name in ``layers``
    ("4", "8", ...) are p * (1 - gamma) + target * gamma."""
    out = copy.deepcopy(source)
    prefixes = tuple(f"inr_net.{part}.{res}." for res in layers
                     for part in ("network", "to_rgbs"))
    tgt = target.state_dict()
    with torch.no_grad():
        for name, p in out.state_dict().items():
            if name.startswith(prefixes):
                p.copy_(p * (1.0 - gamma) + tgt[name].to(p.device) * gamma)
    return out


def model_interpolation_demo(source: GeneratorNerfINR, target: GeneratorNerfINR, out_dir: str,
                             gamma: float = 1.0,
                             swapped_layers: Sequence[str] = ("4", "8", "16", "32", "64", "128",
                                                              "256", "512", "1024"),
                             seeds: Sequence[int] = (0, 1), img_size: int = 64,
                             num_steps: int = 12,
                             yaw_offsets: Sequence[float] = (-0.3, 0.0, 0.3), psi: float = 1.0,
                             draws: Optional[Draws] = None) -> np.ndarray:
    """Batch version of the web demo (`web_demo.py:84-191`): source, target
    and swapped generators side by side over a small yaw sweep, one grid
    ``interp_seed{seed}.png`` per seed.  Returns every frame, in [-1, 1]."""
    draws = draws or Draws(source.device)
    swapped = inr_layer_swapping(source, target, gamma, swapped_layers)
    os.makedirs(out_dir, exist_ok=True)
    all_rows = []
    for seed in seeds:
        row = []
        for model in (source, target, swapped):
            styles = seed_styles(model, seed, psi, draws)
            for off in yaw_offsets:
                opts = RenderOptions(img_size=img_size, num_steps=num_steps, h_stddev=0.0,
                                     v_stddev=0.0, h_mean=math.pi * 0.5 + off, psi=psi)
                img = render_frame(model, styles, opts, seed + 7, draws)
                row.append(img[0].float().cpu().numpy())
        grid = np.stack(row)
        image_io.save_image_grid(grid, os.path.join(out_dir, f"interp_seed{seed}.png"),
                                 nrow=len(yaw_offsets))
        all_rows.append(grid)
    return np.concatenate(all_rows)
