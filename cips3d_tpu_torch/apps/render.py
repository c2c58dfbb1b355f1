"""Chunked rendering: counterpart of `cips3d_tpu/apps/render.py`
(`render_chunked`, `render_chunked_traced`, `compute_styles`).

The pixel axis is cut into chunks of ``forward_points`` rays rendered one
after another, so only one chunk's activations are live at a time.  The
JAX package's multi-chip `render_sharded`, multiview grids and trajectory
videos are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from cips3d_tpu_torch.core import rays as rays_lib
from cips3d_tpu_torch.models.generator import (
    GeneratorNerfINR,
    RenderOptions,
    generate_avg_styles,
    sample_zs,
    truncate_styles,
)
from cips3d_tpu_torch.ops.ray_tile import RayDraws


def chunk_size(num_points: int, forward_points: int) -> int:
    """The largest divisor of ``num_points`` not above ``forward_points``."""
    chunk = min(forward_points, num_points)
    while num_points % chunk:
        chunk -= 1
    return chunk


@torch.no_grad()
def render_chunked(model: GeneratorNerfINR, style_dict, opts: RenderOptions,
                   generator: Optional[torch.Generator] = None,
                   forward_points: int = 256 ** 2, camera_pos=None, camera_lookup=None,
                   up_vector=None, return_depth: bool = False, perturb_uniform=None,
                   chunk_draws: Optional[Sequence[RayDraws]] = None):
    """Render one batch at ``opts.img_size`` in pixel chunks.

    Returns (b, 3, H, W) images in [-1, 1]; with ``return_depth`` also the
    expected ray depth (b, 1, H, W).  ``camera_lookup`` is a view DIRECTION,
    not a look-at point.  Random draws come from ``generator``, or as
    tensors: ``perturb_uniform`` (b, HW, S, 1) for the depth jitter and
    ``chunk_draws`` (one `RayDraws` per chunk) for the ray-tile stage."""
    h = w = opts.img_size
    num_points = h * w
    chunk = chunk_size(num_points, forward_points)
    b = next(iter(style_dict.values())).shape[0]
    world = model.sample_world(b, opts, generator, camera_pos, camera_lookup, up_vector,
                               perturb_uniform)
    imgs, depths = [], []
    for ci, lo in enumerate(range(0, num_points, chunk)):
        sl = slice(lo, lo + chunk)
        sub = rays_lib.WorldRays(world.points[:, sl], world.dirs_expanded[:, sl],
                                 world.origins[:, sl], world.dirs[:, sl], world.z_vals[:, sl],
                                 world.pitch, world.yaw)
        img, _, depth = model.points_forward(
            style_dict, sub, opts, generator,
            draws=None if chunk_draws is None else chunk_draws[ci], return_depth=True)
        imgs.append(img)
        depths.append(depth)
    img = torch.cat(imgs, 1).transpose(1, 2).reshape(b, 3, h, w)
    if not return_depth:
        return img
    return img, torch.cat(depths, 1).transpose(1, 2).reshape(b, 1, h, w)


@torch.no_grad()
def compute_styles(model: GeneratorNerfINR, zs, psi: float = 1.0,
                   avg_generator: Optional[torch.Generator] = None, avg_samples: int = 2000,
                   avg_zs=None):
    """Mapping + optional truncation toward the mean style of
    ``avg_samples`` draws (from ``avg_generator``, or given as ``avg_zs``)."""
    styles = model.mapping(zs["z_nerf"], zs["z_inr"])
    if psi < 1.0:
        if avg_zs is None:
            if avg_generator is None:
                avg_generator = torch.Generator(model.device).manual_seed(0)
            avg_zs = sample_zs(avg_samples, model.cfg, avg_generator, device=model.device)
        styles = truncate_styles(styles, generate_avg_styles(model, zs=avg_zs), psi)
    return styles
