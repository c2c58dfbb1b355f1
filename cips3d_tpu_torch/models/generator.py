"""Full NeRF+INR generator: counterpart of `cips3d_tpu/models/generator.py`.

Dual latents (z_nerf, z_inr) → two mapping networks → style dict; camera
and rays → the NeRF stage (coarse SIREN → hierarchical resample → fine
SIREN → compositing) → 32-dim feature per pixel → CIPS INR decode, plus
the aux RGB head.

The NeRF stage runs through `ops/ray_tile.py` (``fused_ray``, hierarchical
sampling), forward and backward, or unfused: the SIREN under autograd and
`core/volume.py` for the resample and the compositing.  The INR decode
runs through `ops/inr_tile.py` (``fused_inr``, forward only: the serving
render and the D phase) or through `CIPSNet` under autograd (the G phase).  Randomness comes from
explicit `torch.Generator`s or as injected draws (`ForwardDraws`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch
from torch import nn

from cips3d_tpu_torch.core import points as points_lib
from cips3d_tpu_torch.core import rays as rays_lib
from cips3d_tpu_torch.core import volume
from cips3d_tpu_torch.models import init as winit
from cips3d_tpu_torch.models.cips_net import CIPS_RESOLUTIONS, CIPSNet
from cips3d_tpu_torch.models.layers import TorchLinear
from cips3d_tpu_torch.models.mapping import MultiHeadMappingNetwork
from cips3d_tpu_torch.models.nerf_net import NeRFNetwork
from cips3d_tpu_torch.ops.inr_tile import fused_inr_decode
from cips3d_tpu_torch.ops.ray_tile import VJP_IMPLS, RayDraws, draw_ray_randoms, fused_ray_render


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    """Architecture hyperparameters; defaults and validation as in the JAX
    package (the FFHQ flagship).  ``fused_ray`` selects the ray-tile
    kernels for the NeRF stage, ``fused_ray_vjp`` their backward ('pallas':
    recompute, 'pallas_residual': the forward saves residuals, 'jnp':
    autograd through the plain version), ``fused_inr`` the forward-only
    INR-tile kernel.  Depth 0 (``nerf_hidden_layers == 0``) is refused only
    with ``fused_ray``: the kernel has no depth-0 form."""

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
    fused_ray: bool = False
    fused_ray_vjp: str = "pallas"
    fused_inr: bool = False

    def __post_init__(self):
        if self.fused_ray and self.nerf_hidden_layers < 1:
            raise ValueError("fused_ray=True requires nerf_hidden_layers >= 1; got "
                             f"nerf_hidden_layers={self.nerf_hidden_layers}.")
        if self.fused_inr and self.inr_pre_rgb_dim != 3:
            raise ValueError("fused_inr=True: the INR-tile kernel needs inr_pre_rgb_dim == 3; "
                             f"got inr_pre_rgb_dim={self.inr_pre_rgb_dim}.")
        if self.fused_ray_vjp not in VJP_IMPLS:
            raise ValueError(f"fused_ray_vjp must be one of {VJP_IMPLS}; "
                             f"got {self.fused_ray_vjp!r}.")


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    """Camera + volume-rendering options (reference ``G_kwargs``)."""

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
    nerf_noise: float = 0.0
    psi: float = 1.0


class ForwardDraws(NamedTuple):
    """Every random draw of one `GeneratorNerfINR.forward` (float32)."""

    perturb: torch.Tensor                       # (b, HW, S, 1) depth-jitter uniforms
    camera: Tuple[torch.Tensor, torch.Tensor]   # (theta, phi) standard normals, (b, 1) each
    rays: RayDraws                              # ray-tile draws of the (gradient) pixels
    perm: Optional[torch.Tensor] = None         # (HW,) pixel permutation of grad_points
    rays_no_grad: Optional[RayDraws] = None     # ray-tile draws of the other pixels


class GeneratorNerfINR(nn.Module):
    """The flagship generator, with the reference's state-dict layout
    (``siren``, ``mapping_network_nerf``, ``inr_net``,
    ``mapping_network_inr``, ``aux_to_rbg``)."""

    def __init__(self, cfg: GeneratorConfig = GeneratorConfig(), dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.dtype = dtype
        g = generator
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
        # aux branch: Linear(rgb_dim → 3, frequency_init(25)) + tanh ("rbg" is the reference's)
        self.aux_to_rbg = nn.Sequential(TorchLinear(
            c.nerf_rgb_dim, 3, kernel_init=winit.frequency_kernel(25.0), generator=g,
            dtype=dtype))

    # ------------------------------------------------------------------ #

    def mapping(self, z_nerf: torch.Tensor, z_inr: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Both mapping nets; with ``freeze_nerf`` the NeRF styles are
        detached."""
        nerf_styles = self.mapping_network_nerf(z_nerf)
        if self.cfg.freeze_nerf:
            nerf_styles = {k: v.detach() for k, v in nerf_styles.items()}
        style_dict = dict(nerf_styles)
        style_dict.update(self.mapping_network_inr(z_inr))
        return style_dict

    def points_forward(self, style_dict: Mapping[str, torch.Tensor],
                       world: rays_lib.WorldRays, opts: RenderOptions,
                       generator: Optional[torch.Generator] = None,
                       draws: Optional[RayDraws] = None, return_depth: bool = False,
                       idx_grad: Optional[torch.Tensor] = None,
                       cfg: Optional[GeneratorConfig] = None):
        """Coarse→fine NeRF + INR decode for a set of rays (differentiable).

        Returns (inr_img (b, n, 3), aux_img (b, n, 3)) and, with
        ``return_depth``, the expected ray depth (b, n, 1), detached.  With
        ``idx_grad`` only those pixels are rendered.  The ray-tile draws
        come from ``draws`` or ``generator``.  ``cfg`` overrides the
        module's config for this call (the D phase's kernel choice).  With
        ``fused_ray`` and hierarchical sampling the NeRF stage is the ray
        tile; otherwise it is unfused (`_unfused_nerf`), on the same draws."""
        c = cfg or self.cfg
        pts, origins, dirs, z_vals = world.points, world.origins, world.dirs, world.z_vals
        if idx_grad is not None:
            pts, origins, dirs, z_vals = (points_lib.gather_points(t, idx_grad)
                                          for t in (pts, origins, dirs, z_vals))
        if not (c.fused_ray and opts.hierarchical_sample):
            fea, depth = self._unfused_nerf(style_dict, pts, origins, dirs, z_vals, opts,
                                            generator, draws, c)
            return self._decode_pixels(fea, depth, style_dict, return_depth, c)
        fea, depth = fused_ray_render(
            self.siren, style_dict, pts, origins, dirs, z_vals,
            draws=draws, generator=generator, noise_std=float(opts.nerf_noise),
            clamp_mode=opts.clamp_mode, white_back=opts.white_back,
            last_back=opts.last_back, dtype=self.dtype, fast_sin=c.fast_sin,
            vjp_impl=c.fused_ray_vjp)
        if c.freeze_nerf:
            fea, depth = fea.detach(), depth.detach()
        return self._decode_pixels(fea, depth, style_dict, return_depth, c)

    def _unfused_nerf(self, style_dict, pts, origins, dirs, z_vals, opts, generator, draws, c):
        """The NeRF stage outside the kernel: coarse SIREN (rgb and sigma
        apart), the detached resample from the coarse density, fine SIREN,
        and compositing of [fine, coarse] in arrival order; without
        hierarchical sampling, compositing of the coarse samples.  ``u``,
        ``nc`` and ``nf`` of the draws are the resample's uniforms, its
        density noise and the compositing's density noise (nf (b, n, S)
        without hierarchical sampling).  Under ``freeze_nerf`` the stage
        runs without gradient.  Returns (features, depth)."""
        b, n, s, _ = pts.shape
        noise_std = float(opts.nerf_noise)
        if draws is None:
            draws = draw_ray_randoms(b, n, s, noise_std != 0, generator, pts.device,
                                     hierarchical=opts.hierarchical_sample)

        noise = noise_std != 0

        def siren(p):
            rgb, sigma = self.siren(p.reshape(b, n * s, 3), style_dict)
            return rgb.reshape(b, n, s, -1), sigma.reshape(b, n, s, 1)

        # freeze_nerf: the whole stage without gradient, as the reference runs it
        with torch.no_grad() if c.freeze_nerf else contextlib.nullcontext():
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

    def _decode_pixels(self, pixels_fea, pixels_depth, style_dict, return_depth, c):
        """INR decode (all nine blocks, as the reference's render path) and
        the aux head on composited ray features."""
        if c.fused_inr:
            inr_img = fused_inr_decode(self.inr_net, style_dict, pixels_fea, dtype=self.dtype)
        else:
            inr_img = self.inr_net(pixels_fea, style_dict)
        aux = self.aux_to_rbg(pixels_fea)
        if c.freeze_nerf:
            aux = aux.detach()
        aux_img = torch.tanh(aux)
        if return_depth:
            return inr_img, aux_img, pixels_depth.detach()
        return inr_img, aux_img

    def sample_world(self, batch_size: int, opts: RenderOptions,
                     generator: Optional[torch.Generator] = None, camera_pos=None,
                     camera_lookup=None, up_vector=None, perturb_uniform=None,
                     camera_draws=None) -> rays_lib.WorldRays:
        """Camera, rays and jittered sample points (no gradient flows here)."""
        return rays_lib.get_world_points_and_direction(
            batch_size, opts.num_steps, opts.img_size, opts.fov, opts.ray_start,
            opts.ray_end, opts.h_stddev, opts.v_stddev, opts.h_mean, opts.v_mean,
            opts.sample_dist, opts.lock_view_dependence, camera_pos, camera_lookup,
            up_vector, generator, self.device, perturb_uniform, camera_draws)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, zs: Mapping[str, torch.Tensor], opts: RenderOptions,
                generator: Optional[torch.Generator] = None, return_aux_img: bool = False,
                avg_styles: Optional[Mapping[str, torch.Tensor]] = None,
                camera_pos=None, camera_lookup=None, up_vector=None,
                grad_points: Optional[int] = None, draws: Optional[ForwardDraws] = None,
                cfg: Optional[GeneratorConfig] = None):
        """Generate images: (imgs (B, 3, H, W), pitch_yaw (B, 2)); B doubles
        with ``return_aux_img``.  Truncation toward ``avg_styles`` by
        ``opts.psi``.  With ``grad_points`` below the pixel count, only a
        random subset of that many pixels carries gradient; the rest render
        without it and are scattered back.  ``draws`` supplies every random
        draw, else they come from ``generator``."""
        b = zs["z_nerf"].shape[0]
        style_dict = self.mapping(zs["z_nerf"], zs["z_inr"])
        if avg_styles is not None:
            style_dict = truncate_styles(style_dict, avg_styles, opts.psi)
        world = self.sample_world(b, opts, generator, camera_pos, camera_lookup, up_vector,
                                  draws.perturb if draws else None,
                                  draws.camera if draws else None)
        rays = draws.rays if draws else None
        num_points = opts.img_size ** 2
        if grad_points is not None and grad_points < num_points:
            perm = (draws.perm if draws else
                    torch.randperm(num_points, generator=generator, device=self.device))
            idx_grad, idx_no_grad = perm[:grad_points], perm[grad_points:]
            inr_g, aux_g = self.points_forward(style_dict, world, opts, generator, rays,
                                               idx_grad=idx_grad, cfg=cfg)
            with torch.no_grad():
                inr_n, aux_n = self.points_forward(
                    style_dict, world, opts, generator, draws.rays_no_grad if draws else None,
                    idx_grad=idx_no_grad, cfg=cfg)
            inr_img = points_lib.scatter_points(idx_grad, inr_g, idx_no_grad, inr_n, num_points)
            aux_img = points_lib.scatter_points(idx_grad, aux_g, idx_no_grad, aux_n, num_points)
        else:
            inr_img, aux_img = self.points_forward(style_dict, world, opts, generator, rays,
                                                   cfg=cfg)
        h = w = opts.img_size
        imgs = to_nchw(inr_img, h, w)
        pitch_yaw = torch.cat([world.pitch, world.yaw], -1)
        if return_aux_img:
            imgs = torch.cat([imgs, to_nchw(aux_img, h, w)], 0)
            pitch_yaw = torch.cat([pitch_yaw, pitch_yaw], 0)
        return imgs, pitch_yaw

    def forward_with_rays(self, style_dict, world: rays_lib.WorldRays, opts: RenderOptions,
                          generator: Optional[torch.Generator] = None,
                          draws: Optional[RayDraws] = None, return_aux_img: bool = False):
        """Render from precomputed styles + rays."""
        h = w = opts.img_size
        inr_img, aux_img = self.points_forward(style_dict, world, opts, generator, draws)
        return to_nchw(inr_img, h, w), (to_nchw(aux_img, h, w) if return_aux_img else None)


def to_nchw(img_flat: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(b, h*w, c) → (b, c, h, w)."""
    b, _, c = img_flat.shape
    return img_flat.transpose(1, 2).reshape(b, c, h, w)


def truncate_styles(style_dict, avg_styles, psi):
    """avg + psi * (style - avg)."""
    return {name: avg_styles[name] + psi * (style - avg_styles[name])
            for name, style in style_dict.items()}


def sample_zs(batch_size: int, cfg: GeneratorConfig, generator: Optional[torch.Generator] = None,
              dist: str = "gaussian", device=None) -> Dict[str, torch.Tensor]:
    """Draw the dual latents."""
    if dist == "gaussian":
        z_nerf = torch.randn((batch_size, cfg.z_dim_nerf), generator=generator, device=device)
        z_inr = torch.randn((batch_size, cfg.z_dim_inr), generator=generator, device=device)
    elif dist == "uniform":
        z_nerf = torch.rand((batch_size, cfg.z_dim_nerf), generator=generator, device=device) * 2 - 1
        z_inr = torch.rand((batch_size, cfg.z_dim_inr), generator=generator, device=device) * 2 - 1
    else:
        raise ValueError(dist)
    return {"z_nerf": z_nerf, "z_inr": z_inr}


@torch.no_grad()
def generate_avg_styles(model: GeneratorNerfINR, num_samples: int = 10000,
                        generator: Optional[torch.Generator] = None,
                        zs: Optional[Mapping[str, torch.Tensor]] = None):
    """Mean style vectors over ``num_samples`` random z draws (or over the
    given ``zs``); used for truncation."""
    if zs is None:
        zs = sample_zs(num_samples, model.cfg, generator, device=model.device)
    styles = model.mapping(zs["z_nerf"], zs["z_inr"])
    return {name: s.mean(0, keepdim=True) for name, s in styles.items()}
