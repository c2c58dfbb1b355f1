"""Rendering apps: chunked rendering, multiview grids and trajectory
videos.  Counterpart of `cips3d_tpu/apps/render.py` (`render_chunked`,
`compute_styles`, `render_multiview`, `build_trajectory`,
`render_trajectory_video`).

The pixel axis is cut into chunks of ``forward_points`` rays rendered one
after another, so only one chunk's activations are live at a time.  Every
random draw of an app comes from a `Draws`: by default a `torch.Generator`
seeded with the integer the JAX package gives `jax.random.PRNGKey` at the
same place, so a seed picks the same kind of draw in both packages (the
values differ).  Frames are PNGs from the port's own encoder; videos are
MJPEG-AVI (`utils/video.py`).  `render_sharded` renders one image with its
pixels split over the ranks of a process group, one program a call in an
NCCL group.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch

from cips3d_tpu_torch.core import rays as rays_lib
from cips3d_tpu_torch.core import trajectories
from cips3d_tpu_torch.models.generator import (
    GeneratorNerfINR,
    RenderOptions,
    generate_avg_styles,
    sample_zs,
    truncate_styles,
)
from cips3d_tpu_torch.ops.ray_tile import RayDraws, draw_ray_randoms
from cips3d_tpu_torch.utils import graphs, image_io
from cips3d_tpu_torch.utils.video import write_video


def chunk_size(num_points: int, forward_points: int) -> int:
    """The largest divisor of ``num_points`` not above ``forward_points``."""
    chunk = min(forward_points, num_points)
    while num_points % chunk:
        chunk -= 1
    return chunk


@torch.no_grad()
def _render(model: GeneratorNerfINR, style_dict, opts: RenderOptions, generator, chunk: int,
            camera_pos=None, camera_lookup=None, up_vector=None, return_depth: bool = False,
            perturb_uniform=None, chunk_draws: Optional[Sequence[RayDraws]] = None):
    """The body of `render_chunked`, in pixel chunks of ``chunk`` rays, on
    device tensors."""
    h = w = opts.img_size
    num_points = h * w
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


def _on(x, device):
    """A camera vector (a tensor, or a numpy (b, 3) array) as a tensor on
    ``device`` (float32 from numpy)."""
    if x is None:
        return None
    if torch.is_tensor(x):
        return x.to(device)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


@torch.no_grad()
def render_chunked(model: GeneratorNerfINR, style_dict, opts: RenderOptions,
                   generator: Optional[torch.Generator] = None,
                   forward_points: int = 256 ** 2, camera_pos=None, camera_lookup=None,
                   up_vector=None, return_depth: bool = False, perturb_uniform=None,
                   chunk_draws: Optional[Sequence[RayDraws]] = None, *,
                   dispatch: str = "program",
                   programs: Optional[graphs.ProgramCache] = None):
    """Render one batch at ``opts.img_size`` in pixel chunks.

    Returns (b, 3, H, W) images in [-1, 1]; with ``return_depth`` also the
    expected ray depth (b, 1, H, W).  ``camera_lookup`` is a view DIRECTION,
    not a look-at point; camera vectors are (b, 3) tensors or numpy arrays.
    Random draws come from ``generator``, or as tensors: ``perturb_uniform``
    (b, HW, S, 1) for the depth jitter and ``chunk_draws`` (one `RayDraws`
    per chunk) for the ray-tile stage.

    The call is one program, as the JAX package jits `render_chunked_traced`:
    on the card a CUDA graph keyed by the model, ``opts``, the batch, the
    chunk, ``return_depth`` and which inputs are given (`graphs.program_for`,
    in ``programs`` or the shared `graphs.PROGRAMS`), captured at its first call
    and replayed after, its inputs copied into its buffers and its outputs
    copied out; with ``generator`` it draws what the eager call would and
    leaves ``generator`` where the eager call leaves it.  On the CPU the same
    program runs op by op.  ``dispatch="eager"`` runs `_render` directly."""
    chunk = chunk_size(opts.img_size ** 2, forward_points)
    if graphs.eager(dispatch):
        dev = model.device
        return _render(model, style_dict, opts, generator, chunk, _on(camera_pos, dev),
                       _on(camera_lookup, dev), _on(up_vector, dev), return_depth,
                       perturb_uniform, chunk_draws)
    inputs = {"styles": dict(style_dict), "camera": (camera_pos, camera_lookup, up_vector),
              "perturb": perturb_uniform,
              "draws": None if chunk_draws is None else list(chunk_draws)}

    def body(m, x, rng):
        return _render(m, x["styles"], opts, rng, chunk, *x["camera"], return_depth,
                       x["perturb"], x["draws"])

    b = next(iter(style_dict.values())).shape[0]
    prog = graphs.program_for(model, ("render_chunked", opts, chunk, return_depth), inputs,
                              body, f"render_chunked r{opts.img_size} x{opts.num_steps} b={b}",
                              uses_generator=generator is not None, programs=programs)
    return prog(inputs, generator)


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


class Draws:
    """The random draws of the apps, each named by the integer the JAX
    package seeds a `jax.random.PRNGKey` with at the same place: `zs`
    draws latents, `render` the draws of one `render_chunked` call.  This
    class makes them from a `torch.Generator` seeded with that integer on
    ``device``; tests substitute the JAX package's draws."""

    def __init__(self, device):
        self.device = torch.device(device)

    def zs(self, seed: int, n: int, cfg):
        return sample_zs(n, cfg, torch.Generator(self.device).manual_seed(int(seed)),
                         device=self.device)

    def render(self, key: int, batch_size: int, opts: RenderOptions, chunk: int) -> dict:
        """Keyword arguments of `render_chunked` that carry its draws (its
        pixel chunks hold ``chunk`` rays)."""
        return {"generator": torch.Generator(self.device).manual_seed(int(key))}


def seed_styles(model: GeneratorNerfINR, seed: int, psi: float, draws: Draws,
                avg_samples: int = 2000):
    """`compute_styles` of seed ``seed``'s latents, truncated toward the
    mean style of ``avg_samples`` latents of seed 0 when psi < 1."""
    zs = draws.zs(seed, 1, model.cfg)
    avg_zs = draws.zs(0, avg_samples, model.cfg) if psi < 1.0 else None
    return compute_styles(model, zs, psi=psi, avg_zs=avg_zs)


def render_frame(model: GeneratorNerfINR, styles, opts: RenderOptions, key: int, draws: Draws,
                 forward_points: int = 256 ** 2, camera_pos=None, camera_lookup=None,
                 up_vector=None, return_depth: bool = False, **kwargs):
    """`render_chunked` of one batch with the draws of ``key``; the camera,
    if given, as numpy (b, 3) arrays (copied into the program's buffers
    through pinned memory).  ``kwargs`` go to `render_chunked`
    (``dispatch``, ``programs``)."""
    b = next(iter(styles.values())).shape[0]
    chunk = chunk_size(opts.img_size ** 2, forward_points)
    return render_chunked(model, styles, opts, forward_points=forward_points,
                          camera_pos=camera_pos, camera_lookup=camera_lookup, up_vector=up_vector,
                          return_depth=return_depth, **draws.render(key, b, opts, chunk), **kwargs)


@torch.no_grad()
def render_sharded(model: GeneratorNerfINR, styles, opts: RenderOptions, key: int, draws: Draws,
                   mesh, camera_pos=None, camera_lookup=None, up_vector=None,
                   return_depth: bool = False, *, dispatch: str = "program",
                   programs: Optional[graphs.ProgramCache] = None):
    """Whole-image render with the pixel axis split over the ranks of
    ``mesh`` (its ray groups, or every rank when ``ray_shards`` is 1): the
    counterpart of the JAX package's ``render_sharded``.  Every rank draws
    the draws of `render_frame`'s one-chunk render of ``key``, renders its
    slice of the H x W pixels with them, and the slices are all-gathered.
    Returns (b, 3, H, W) images (with ``return_depth`` also (b, 1, H, W)) on
    every rank.  Raises when H x W does not divide by the shard count.

    The call is one program, as the JAX package jits it over the
    pixel-sharded mesh: in an NCCL group a CUDA graph with the all-gather
    inside (keyed by the model, ``opts``, the mesh and which inputs are
    given, in ``programs`` or the shared `graphs.PROGRAMS`); on the CPU the
    same program op by op.  In a gloo group on the card, and with
    ``dispatch="eager"``, it runs op by op: gloo's collectives go through
    host memory and cannot be captured, as the training chunks find."""
    from cips3d_tpu_torch.parallel.mesh import gather_pixels

    h = w = opts.img_size
    n = h * w
    lo, hi = mesh.pixel_range(n)
    b = next(iter(styles.values())).shape[0]
    kw = draws.render(key, b, opts, n)
    chunk_draws = kw.get("chunk_draws")
    inputs = {"styles": dict(styles), "camera": (camera_pos, camera_lookup, up_vector),
              "perturb": kw.get("perturb_uniform"),
              "draws": None if chunk_draws is None else chunk_draws[0]}

    def body(m, x, g):
        world = m.sample_world(b, opts, g, *x["camera"], x["perturb"])
        rd = x["draws"]
        if rd is None:   # as `points_forward` draws them for one chunk of every pixel
            rd = draw_ray_randoms(b, n, opts.num_steps, float(opts.nerf_noise) != 0, g,
                                  m.device, hierarchical=opts.hierarchical_sample)
        sl = slice(lo, hi)
        sub = rays_lib.WorldRays(world.points[:, sl], world.dirs_expanded[:, sl],
                                 world.origins[:, sl], world.dirs[:, sl], world.z_vals[:, sl],
                                 world.pitch, world.yaw)
        img, _, depth = m.points_forward(x["styles"], sub, opts, g,
                                         draws=RayDraws(*(t[:, sl].contiguous() for t in rd)),
                                         return_depth=True)
        full = gather_pixels(torch.cat([img, depth.to(img.dtype)], -1), mesh)
        return (full[..., :3].transpose(1, 2).reshape(b, 3, h, w),
                full[..., 3:].transpose(1, 2).reshape(b, 1, h, w))

    gen = kw.get("generator")
    group = mesh.pixel_shards[2]
    if graphs.eager(dispatch) or (model.device.type == "cuda"
                                  and torch.distributed.get_backend(group) != "nccl"):
        dev = model.device
        inputs["camera"] = tuple(_on(v, dev) for v in inputs["camera"])
        img, depth = body(model, inputs, gen)
    else:
        prog = graphs.program_for(model, ("render_sharded", opts, mesh), inputs, body,
                                  f"render_sharded r{h} x{opts.num_steps} b={b} "
                                  f"pixels {lo}:{hi}", uses_generator=gen is not None,
                                  programs=programs)
        img, depth = prog(inputs, gen)
    return (img, depth) if return_depth else img


def depth_to_uint8(dmap, opts: RenderOptions) -> np.ndarray:
    """(H, W) depth → (H, W, 3) uint8 grey, normalised over the ray interval
    (the reference expands depth to 3 channels, `st_web.py:275`)."""
    d = (np.asarray(dmap, np.float32) - opts.ray_start) / (opts.ray_end - opts.ray_start)
    d8 = (np.clip(d, 0.0, 1.0) * 255).astype(np.uint8)
    return np.stack([d8] * 3, axis=-1)


def render_multiview(model: GeneratorNerfINR, out_path: str,
                     seeds: Sequence[int] = (0, 1, 2, 3),
                     yaw_offsets: Sequence[float] = (-0.5, -0.25, 0.0, 0.25, 0.5),
                     img_size: int = 64, num_steps: int = 12, psi: float = 0.7,
                     ray_step_multiplier: int = 2, fov: float = 12.0,
                     draws: Optional[Draws] = None) -> np.ndarray:
    """pi-GAN's multiview grid (`render_multiview_images.py:67-86`): each
    seed's latents at several yaws, one grid row per seed.  Returns the
    (seeds x yaws, 3, H, W) frames in [-1, 1]."""
    draws = draws or Draws(model.device)
    base = RenderOptions(img_size=img_size, num_steps=num_steps * ray_step_multiplier, fov=fov,
                         h_stddev=0.0, v_stddev=0.0, psi=psi)
    rows = []
    for seed in seeds:
        styles = seed_styles(model, seed, psi, draws)
        for off in yaw_offsets:
            opts = dataclasses.replace(base, h_mean=math.pi * 0.5 + off)
            img = render_frame(model, styles, opts, seed * 997 + 13, draws)
            rows.append(img[0].float().cpu().numpy())
    grid = np.stack(rows)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        image_io.save_image_grid(grid, out_path, nrow=len(yaw_offsets))
    return grid


TRAJECTORY_MODES = ("circle", "circle_near_far", "yaw", "translate_circle_near_far",
                    "translate_rotate")


def build_trajectory(mode: str, num_frames: int, periods: int = 2, alpha_pidiv: float = 15.0):
    """Camera path of a demo video (`st_web.py` trajectory_mode options):
    (xyz, lookup, up or None) arrays, about ``num_frames`` long (the
    translate modes round to whole quarter sweeps; a video renders at most
    ``num_frames``)."""
    alpha = math.pi / alpha_pidiv
    if mode in ("circle", "circle_near_far"):
        per_period = max(1, -(-num_frames // max(1, periods)))  # ceil
        xyz, lookup, _, _ = trajectories.get_circle_camera_pos_and_lookup(
            alpha=alpha, num_samples=per_period, periods=periods)
        return xyz, lookup, None
    if mode == "yaw":
        xyz, lookup, _, _ = trajectories.get_yaw_camera_pos_and_lookup(num_samples=num_frames)
        return xyz, lookup, None
    if mode == "translate_circle_near_far":
        xyz, lookup, _, _, _ = trajectories.get_translate_circle_camera_pos_and_lookup(
            num_samples_translate=num_frames // 3, alpha=alpha,
            num_samples=num_frames // max(1, periods), periods=periods)
        return xyz, lookup, None
    if mode == "translate_rotate":
        xyz, lookup, up, _, _, _ = trajectories.get_translate_rotate(
            num_samples_translate=num_frames // 3, alpha=alpha, num_samples=num_frames,
            periods=1)
        return xyz, lookup, up
    raise ValueError(f"unknown trajectory mode {mode!r}; options: {TRAJECTORY_MODES}")


def render_trajectory_video(model: GeneratorNerfINR, out_dir: str, seed: int = 0,
                            mode: str = "circle", num_frames: int = 30, img_size: int = 128,
                            num_steps: int = 24, psi: float = 1.0, fov: float = 12.0,
                            max_fov: Optional[float] = None, fps: int = 40,
                            forward_points: int = 256 ** 2, depth: bool = False,
                            draws: Optional[Draws] = None) -> list:
    """A camera-trajectory video of one seed (`st_web.py:289-486`,
    `web_demo.py:94-191`): PNG frames ``frame_{i:04d}.png`` (with ``depth``
    also ``depth_{i:04d}.png``) and their MJPEG-AVI.  Returns the frame
    paths."""
    draws = draws or Draws(model.device)
    os.makedirs(out_dir, exist_ok=True)
    xyz, lookup, up = build_trajectory(mode, num_frames)
    styles = seed_styles(model, seed, psi, draws)
    if max_fov is not None and mode.endswith("near_far"):   # fov ramp (`web_demo.py:110-127`)
        half = len(xyz) // 2
        fovs = np.concatenate([np.linspace(fov, max_fov, half),
                               np.linspace(max_fov, fov, len(xyz) - half)])
    else:
        fovs = np.full(len(xyz), fov)
    paths, frames, depth_frames = [], [], []
    for i in range(min(num_frames, len(xyz))):
        opts = RenderOptions(img_size=img_size, num_steps=num_steps, fov=float(fovs[i]),
                             h_stddev=0.0, v_stddev=0.0, psi=psi)
        img, dmap = render_frame(model, styles, opts, seed * 31 + i, draws, forward_points,
                                 xyz[i:i + 1], lookup[i:i + 1],
                                 None if up is None else up[i:i + 1], return_depth=True)
        frames.append(image_io.to_uint8(img[0].float().cpu().numpy()))
        paths.append(os.path.join(out_dir, f"frame_{i:04d}.png"))
        image_io.write_png(paths[-1], frames[-1])
        if depth:
            depth_frames.append(depth_to_uint8(dmap[0, 0].float().cpu().numpy(), opts))
            image_io.write_png(os.path.join(out_dir, f"depth_{i:04d}.png"), depth_frames[-1])
    write_video(frames, os.path.join(out_dir, "video.mp4"), fps)
    if depth_frames:
        write_video(depth_frames, os.path.join(out_dir, "depth.mp4"), fps)
    return paths
