"""The plain NeRF + INR generator: mapping nets, camera and rays, the
unfused NeRF stage (coarse FiLM-SIREN, detached resample, fine SIREN,
compositing) and the CIPS INR decode, in float32 autograd only.

Written from the published CIPS-3D generator with the reference's
state-dict layout (``siren``, ``mapping_network_nerf``, ``inr_net``,
``mapping_network_inr``, ``aux_to_rbg``), so the benchmark's weights load
into it and into the program alike.  Every random draw comes from one
`torch.Generator`, in the order the published forward draws them: the
camera and the depth jitter (`rays.get_world_points_and_direction`), the
pixel permutation of ``grad_points``, then each ray set's resample
uniforms and density noise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Mapping, NamedTuple, Optional

import torch
from torch import nn

from . import init as winit
from . import points as points_lib
from . import rays as rays_lib
from . import volume
from .cips_net import CIPS_RESOLUTIONS, CIPSNet
from .layers import TorchLinear
from .mapping import MultiHeadMappingNetwork
from .nerf_net import NeRFNetwork


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    z_dim_nerf: int = 256
    z_dim_inr: int = 512
    nerf_hidden_dim: int = 128
    nerf_hidden_layers: int = 2
    nerf_rgb_dim: int = 32
    nerf_style_dim: int = 128
    nerf_mapping_layers: int = 4
    inr_hidden_dim: int = 512
    inr_style_dim: int = 512
    inr_mapping_layers: int = 8
    inr_pre_rgb_dim: int = 3
    freeze_nerf: bool = False
    fast_sin: bool = False


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    img_size: int = 64
    fov: float = 12.0
    ray_start: float = 0.88
    ray_end: float = 1.12
    num_steps: int = 12
    h_stddev: float = 0.3
    v_stddev: float = 0.155
    h_mean: float = math.pi * 0.5
    v_mean: float = math.pi * 0.5
    hierarchical_sample: bool = True
    sample_dist: str = "gaussian"
    lock_view_dependence: bool = False
    clamp_mode: str = "relu"
    white_back: bool = False
    last_back: bool = False
    nerf_noise: Any = 0.0
    psi: float = 1.0


class RayDraws(NamedTuple):
    u: torch.Tensor    # (b, n, S) resample uniforms
    nc: torch.Tensor   # (b, n, S) resample density noise
    nf: torch.Tensor   # (b, n, 2S) compositing density noise


def uses_noise(noise_std) -> bool:
    """Density noise applies to a tensor schedule always, to a number
    unless it is 0 (adding 0 * noise is exact)."""
    return not (isinstance(noise_std, (int, float)) and noise_std == 0)


def draw_ray_randoms(b, n, S, use_noise, generator, device, hierarchical=True) -> RayDraws:
    m = 2 * S if hierarchical else S
    u = torch.rand((b, n, S), generator=generator, device=device)
    if use_noise:
        nc = torch.randn((b, n, S), generator=generator, device=device)
        nf = torch.randn((b, n, m), generator=generator, device=device)
    else:
        nc = torch.zeros((b, n, S), device=device)
        nf = torch.zeros((b, n, m), device=device)
    return RayDraws(u, nc, nf)


def sample_zs(batch_size: int, cfg: GeneratorConfig, generator=None, device=None):
    z_nerf = torch.randn((batch_size, cfg.z_dim_nerf), generator=generator, device=device)
    z_inr = torch.randn((batch_size, cfg.z_dim_inr), generator=generator, device=device)
    return {"z_nerf": z_nerf, "z_inr": z_inr}


def to_nchw(img_flat: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b, _, c = img_flat.shape
    return img_flat.transpose(1, 2).reshape(b, c, h, w)


class Generator(nn.Module):
    def __init__(self, cfg: GeneratorConfig, generator: Optional[torch.Generator] = None,
                 dtype=torch.float32):
        super().__init__()
        c, g = cfg, generator
        self.cfg = cfg
        self.siren = NeRFNetwork(hidden_dim=c.nerf_hidden_dim, hidden_layers=c.nerf_hidden_layers,
                                 rgb_dim=c.nerf_rgb_dim, style_dim=c.nerf_style_dim,
                                 fast_sin=c.fast_sin, generator=g, dtype=dtype)
        nerf_heads = {f"nerf_w{i}": c.nerf_style_dim for i in range(c.nerf_hidden_layers)}
        nerf_heads["nerf_rgb"] = c.nerf_style_dim
        self.mapping_network_nerf = MultiHeadMappingNetwork(
            c.z_dim_nerf, c.nerf_style_dim, c.nerf_mapping_layers, nerf_heads,
            generator=g, dtype=dtype)
        self.inr_net = CIPSNet(input_dim=c.nerf_rgb_dim, hidden_dim=c.inr_hidden_dim,
                               style_dim=c.inr_style_dim, pre_rgb_dim=c.inr_pre_rgb_dim,
                               generator=g, dtype=dtype)
        inr_heads = {}
        for res in CIPS_RESOLUTIONS:
            inr_heads[f"inr_w{res}_0"] = c.inr_style_dim
            inr_heads[f"inr_w{res}_1"] = c.inr_style_dim
        self.mapping_network_inr = MultiHeadMappingNetwork(
            c.z_dim_inr, c.inr_style_dim, c.inr_mapping_layers, inr_heads,
            add_norm=True, norm_out=True, generator=g, dtype=dtype)
        self.aux_to_rbg = nn.Sequential(TorchLinear(
            c.nerf_rgb_dim, 3, kernel_init=winit.frequency_kernel(25.0), generator=g,
            dtype=dtype))

    @property
    def device(self):
        return next(self.parameters()).device

    def mapping(self, z_nerf, z_inr) -> Dict[str, torch.Tensor]:
        nerf_styles = self.mapping_network_nerf(z_nerf)
        if self.cfg.freeze_nerf:
            nerf_styles = {k: v.detach() for k, v in nerf_styles.items()}
        style_dict = dict(nerf_styles)
        style_dict.update(self.mapping_network_inr(z_inr))
        return style_dict

    def nerf(self, style_dict, pts, origins, dirs, z_vals, opts: RenderOptions, generator,
             draws: Optional[RayDraws] = None):
        """Coarse SIREN, the detached resample, fine SIREN and compositing of
        [fine, coarse]: (features (b, n, R), depth (b, n, 1)).  The ray draws
        are ``draws``, or drawn from ``generator``."""
        b, n, s, _ = pts.shape
        noise_std = opts.nerf_noise
        noise = uses_noise(noise_std)
        if draws is None:
            draws = draw_ray_randoms(b, n, s, noise, generator, pts.device,
                                     hierarchical=opts.hierarchical_sample)

        def siren(p):
            rgb, sigma = self.siren(p.reshape(b, n * s, 3), style_dict)
            return rgb.reshape(b, n, s, -1), sigma.reshape(b, n, s, 1)

        with torch.no_grad() if self.cfg.freeze_nerf else contextlib.nullcontext():
            coarse_rgb, coarse_sigma = siren(pts)
            if opts.hierarchical_sample:
                fine_pts, fine_z = volume.get_fine_points_from_sigma(
                    draws.u.reshape(b * n, s), coarse_sigma, z_vals, opts.clamp_mode, noise_std,
                    s, origins, dirs, noise=draws.nc[..., None] if noise else None)
                fine_rgb, fine_sigma = siren(fine_pts.to(pts.dtype))
                all_rgb = torch.cat([fine_rgb, coarse_rgb], -2)
                all_sigma = torch.cat([fine_sigma, coarse_sigma], -2)
                all_z = torch.cat([fine_z.to(z_vals.dtype), z_vals], -2)
                render = volume.volume_render_unsorted
            else:
                all_rgb, all_sigma, all_z = coarse_rgb, coarse_sigma, z_vals
                render = volume.volume_render_split
            fea, depth, _ = render(all_rgb, all_sigma, all_z,
                                   noise=draws.nf[..., None] if noise else None,
                                   noise_std=noise_std, last_back=opts.last_back,
                                   white_back=opts.white_back, clamp_mode=opts.clamp_mode)
        return fea, depth

    def points_forward(self, style_dict, world: rays_lib.WorldRays, opts: RenderOptions,
                       generator, idx=None, draws: Optional[RayDraws] = None):
        """(inr_img (b, n, 3), aux_img (b, n, 3), depth (b, n, 1)) of the rays
        (of the pixels ``idx``)."""
        pts, origins, dirs, z_vals = world.points, world.origins, world.dirs, world.z_vals
        if idx is not None:
            pts, origins, dirs, z_vals = (points_lib.gather_points(t, idx)
                                          for t in (pts, origins, dirs, z_vals))
        fea, depth = self.nerf(style_dict, pts, origins, dirs, z_vals, opts, generator, draws)
        inr_img = self.inr_net(fea, style_dict)
        aux = self.aux_to_rbg(fea)
        if self.cfg.freeze_nerf:
            aux = aux.detach()
        return inr_img, torch.tanh(aux), depth.detach()

    def sample_world(self, b, opts: RenderOptions, generator, camera_pos=None,
                     camera_lookup=None, perturb=None, camera=None):
        return rays_lib.get_world_points_and_direction(
            b, opts.num_steps, opts.img_size, opts.fov, opts.ray_start, opts.ray_end,
            opts.h_stddev, opts.v_stddev, opts.h_mean, opts.v_mean, opts.sample_dist,
            opts.lock_view_dependence, camera_pos, camera_lookup, None, generator, self.device,
            perturb, camera)

    def forward(self, zs, opts: RenderOptions, generator, return_aux_img=False,
                grad_points: Optional[int] = None, draws: Optional[dict] = None):
        """Images (B, 3, H, W), B doubled to [inr | aux] with ``return_aux_img``.
        ``draws`` ({perturb, camera, rays}, all pixels) replace the draws from
        ``generator``."""
        b = zs["z_nerf"].shape[0]
        style_dict = self.mapping(zs["z_nerf"], zs["z_inr"])
        if draws is not None:
            inr_img, aux_img, _ = self.points_forward(
                style_dict, self.sample_world(b, opts, None, perturb=draws["perturb"],
                                              camera=draws["camera"]),
                opts, None, draws=draws["rays"])
            h = w = opts.img_size
            imgs = to_nchw(inr_img, h, w)
            return torch.cat([imgs, to_nchw(aux_img, h, w)], 0) if return_aux_img else imgs
        world = self.sample_world(b, opts, generator)
        num_points = opts.img_size ** 2
        if grad_points is not None and grad_points < num_points:
            perm = torch.randperm(num_points, generator=generator, device=self.device)
            idx_g, idx_n = perm[:grad_points], perm[grad_points:]
            inr_g, aux_g, _ = self.points_forward(style_dict, world, opts, generator, idx_g)
            with torch.no_grad():
                inr_n, aux_n, _ = self.points_forward(style_dict, world, opts, generator, idx_n)
            inr_img = points_lib.scatter_points(idx_g, inr_g, idx_n, inr_n, num_points)
            aux_img = points_lib.scatter_points(idx_g, aux_g, idx_n, aux_n, num_points)
        else:
            inr_img, aux_img, _ = self.points_forward(style_dict, world, opts, generator)
        h = w = opts.img_size
        imgs = to_nchw(inr_img, h, w)
        if return_aux_img:
            imgs = torch.cat([imgs, to_nchw(aux_img, h, w)], 0)
        return imgs


@torch.no_grad()
def truncated_styles(model: Generator, zs, psi: float, avg_zs) -> Dict[str, torch.Tensor]:
    """The mapping of ``zs``, moved toward the mean style of ``avg_zs`` by psi."""
    styles = model.mapping(zs["z_nerf"], zs["z_inr"])
    if psi >= 1.0:
        return styles
    avg = model.mapping(avg_zs["z_nerf"], avg_zs["z_inr"])
    avg = {k: v.mean(0, keepdim=True) for k, v in avg.items()}
    return {k: avg[k] + psi * (s - avg[k]) for k, s in styles.items()}


@torch.no_grad()
def render_frame(model: Generator, styles: Mapping[str, torch.Tensor], opts: RenderOptions,
                 generator, camera_pos, camera_lookup, chunk: int):
    """One explicit-camera frame in pixel chunks of ``chunk`` rays:
    (image (1, 3, H, W) in [-1, 1], depth (1, 1, H, W))."""
    h = w = opts.img_size
    world = model.sample_world(1, opts, generator, camera_pos, camera_lookup)
    imgs, depths = [], []
    for lo in range(0, h * w, chunk):
        sl = slice(lo, lo + chunk)
        sub = rays_lib.WorldRays(world.points[:, sl], world.dirs_expanded[:, sl],
                                 world.origins[:, sl], world.dirs[:, sl], world.z_vals[:, sl],
                                 world.pitch, world.yaw)
        img, _, depth = model.points_forward(styles, sub, opts, generator)
        imgs.append(img)
        depths.append(depth)
    img = torch.cat(imgs, 1).transpose(1, 2).reshape(1, 3, h, w)
    return img, torch.cat(depths, 1).transpose(1, 2).reshape(1, 1, h, w)
