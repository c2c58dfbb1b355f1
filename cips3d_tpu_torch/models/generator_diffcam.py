"""Differentiable-camera generator of the diffcam pipeline: counterpart of
`cips3d_tpu/models/generator_diffcam.py`.

`GeneratorDiffcam` is the flagship `GeneratorNerfINR` (same modules, same
state dict) with an explicit-ray forward: rays ``rays_o``/``rays_d`` (b, h,
w, 3) from a learnable `CamParams` and the rendering options `NerfKwargs`
go through the SIREN under autograd, the detached inverse-CDF resample, the
fine SIREN and sort-free compositing (`core/volume.py`), then `CIPSNet`.
Gradients reach the camera through the rays.  No kernel runs here, as in
the JAX package.  The random draws come in as `DiffcamDraws` or from a
`torch.Generator`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from cips3d_tpu_torch.core import volume
from cips3d_tpu_torch.models.generator import GeneratorNerfINR, truncate_styles


@dataclasses.dataclass(frozen=True)
class NerfKwargs:
    """Rendering options of the diffcam pipeline (the reference's
    ``nerf_kwargs``)."""

    near: float = 0.88
    far: float = 1.12
    n_samples: int = 12
    n_importance: int = 12
    perturb: bool = True
    clamp_mode: str = "relu"
    white_back: bool = False
    last_back: bool = False
    raw_noise_std: Any = 0.0


class DiffcamDraws(NamedTuple):
    """Every random draw of one `GeneratorDiffcam.forward_rays` (float32)."""

    perturb: torch.Tensor   # (b, n, S, 1) depth-jitter uniforms
    u: torch.Tensor         # (b * n, I) importance-sample uniforms
    nc: torch.Tensor        # (b, n, S, 1) resample density noise, standard normal
    nf: torch.Tensor        # (b, n, I + S, 1) compositing density noise ((b, n, S, 1) if I = 0)


def draw_diffcam(b: int, n: int, nk: NerfKwargs, generator: Optional[torch.Generator] = None,
                 device=None) -> DiffcamDraws:
    s, i = nk.n_samples, nk.n_importance
    return DiffcamDraws(torch.rand((b, n, s, 1), generator=generator, device=device),
                        torch.rand((b * n, i), generator=generator, device=device),
                        torch.randn((b, n, s, 1), generator=generator, device=device),
                        torch.randn((b, n, i + s, 1), generator=generator, device=device))


class GeneratorDiffcam(GeneratorNerfINR):
    """`GeneratorNerfINR` with the explicit-ray forward."""

    def forward_rays(self, zs: Mapping[str, torch.Tensor], rays_o: torch.Tensor,
                     rays_d: torch.Tensor, nerf_kwargs: NerfKwargs = NerfKwargs(),
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[DiffcamDraws] = None, return_aux_img: bool = False,
                     avg_styles: Optional[Mapping[str, torch.Tensor]] = None,
                     psi: float = 1.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """rays (b, h, w, 3) → (imgs (b, 3, h, w), ret_maps: depth and
        weights_sum (b, 1, h, w), and aux_img with ``return_aux_img``)."""
        nk = nerf_kwargs
        b, h, w, _ = rays_o.shape
        n, s = h * w, nk.n_samples
        rays_o_f, rays_d_f = rays_o.reshape(b, n, 3), rays_d.reshape(b, n, 3)
        style_dict = self.mapping(zs["z_nerf"], zs["z_inr"])
        if avg_styles is not None:
            style_dict = truncate_styles(style_dict, avg_styles, psi)
        if draws is None:
            draws = draw_diffcam(b, n, nk, generator, rays_o.device)
        noise = float(nk.raw_noise_std)

        z_vals = torch.linspace(nk.near, nk.far, s, dtype=rays_o.dtype, device=rays_o.device)
        z_vals = z_vals[None, None, :, None].expand(b, n, s, 1)
        if nk.perturb:
            z_vals = z_vals + (draws.perturb - 0.5) * ((nk.far - nk.near) / (s - 1))
        points = rays_o_f[:, :, None, :] + rays_d_f[:, :, None, :] * z_vals

        def siren(p, m):
            rgb, sigma = self.siren(p.reshape(b, n * m, 3), style_dict)
            return rgb.reshape(b, n, m, -1), sigma.reshape(b, n, m, 1)

        coarse_rgb, coarse_sigma = siren(points, s)
        if nk.n_importance > 0:
            fine_pts, fine_z = volume.get_fine_points_from_sigma(
                draws.u, coarse_sigma, z_vals, nk.clamp_mode, noise, nk.n_importance,
                rays_o_f, rays_d_f, noise=draws.nc)
            fine_rgb, fine_sigma = siren(fine_pts, nk.n_importance)
            # sort-free compositing of [fine, coarse] in arrival order
            fea, depth, weights = volume.volume_render_unsorted(
                torch.cat([fine_rgb, coarse_rgb], -2), torch.cat([fine_sigma, coarse_sigma], -2),
                torch.cat([fine_z, z_vals], -2), noise=draws.nf, noise_std=noise,
                last_back=nk.last_back, white_back=nk.white_back, clamp_mode=nk.clamp_mode)
        else:
            fea, depth, weights = volume.volume_render_split(
                coarse_rgb, coarse_sigma, z_vals, noise=draws.nf[:, :, :s], noise_std=noise,
                last_back=nk.last_back, white_back=nk.white_back, clamp_mode=nk.clamp_mode)
        imgs = self.inr_net(fea, style_dict).transpose(1, 2).reshape(b, 3, h, w)
        ret = {"depth": depth.transpose(1, 2).reshape(b, 1, h, w),
               "weights_sum": weights.sum(2).transpose(1, 2).reshape(b, 1, h, w)}
        # the aux head always runs, as in the JAX package (its tree stays stable)
        aux = torch.tanh(self.aux_to_rbg(fea))
        if return_aux_img:
            ret["aux_img"] = aux.transpose(1, 2).reshape(b, 3, h, w)
        return imgs, ret
