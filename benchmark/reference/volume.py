"""Volume rendering and hierarchical importance sampling: counterpart of
`cips3d_tpu/core/volume.py`.

Every random draw comes in as a tensor: the density noise of a call as a
standard normal tensor shaped like its sigmas (``noise``), the inverse-CDF
uniforms of `sample_pdf` as ``u`` (R, I).  Where the JAX package contracts
one-hot matrices on the TPU's matrix unit, this module uses PyTorch's own
idiom (`torch.searchsorted`, `cumsum`, gathers) with the same numerics:

  * the insertion index is `searchsorted(cdf, u, side='left')`, the count of
    cdf entries below ``u``;
  * the floor of the transmittance's log is ``max(1 - alpha, 1e-10)``,
    never ``1 - alpha + eps``;
  * a CDF bin narrower than ``eps`` gets denominator 1;
  * samples in arbitrary depth order are ranked with the stable [fine,
    coarse] tie-break, and that ordering runs in f32 even under bf16;
  * the coarse-to-fine resample is detached, as the reference runs it under
    ``no_grad``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _density(sigmas, noise, noise_std, clamp_mode):
    if noise is not None and not (isinstance(noise_std, (int, float)) and noise_std == 0):
        sigmas = sigmas + noise.to(sigmas.dtype) * noise_std
    if clamp_mode == "softplus":
        return F.softplus(sigmas)
    if clamp_mode == "relu":
        return torch.relu(sigmas)
    raise ValueError(f"clamp_mode must be 'relu' or 'softplus', got {clamp_mode!r}")


def _finish(weights_sum, rgb_final, white_back, fill_mode):
    if white_back:
        rgb_final = rgb_final + 1.0 - weights_sum
    if fill_mode == "debug":
        red = torch.zeros_like(rgb_final)
        red[..., 0] = 1.0
        rgb_final = torch.where(weights_sum < 0.9, red, rgb_final)
    elif fill_mode == "weight":
        rgb_final = weights_sum.expand(rgb_final.shape)
    return rgb_final


def render_weights(sigmas: torch.Tensor, z_vals: torch.Tensor,
                   noise: Optional[torch.Tensor] = None, noise_std: float = 0.5,
                   clamp_mode: str = "relu") -> torch.Tensor:
    """Compositing weights (b, n, s, 1) from the density alone."""
    deltas = z_vals[:, :, 1:] - z_vals[:, :, :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[:, :, :1], 1e10)], -2)
    alphas = 1.0 - torch.exp(-deltas * _density(sigmas, noise, noise_std, clamp_mode))
    logx = torch.log(torch.clamp(1.0 - alphas[..., 0], min=1e-10))
    # exclusive prefix sum of the logs: T_i = prod_{j<i} (1 - alpha_j)
    excl = torch.cumsum(logx, -1) - logx
    return alphas * torch.exp(excl)[..., None]


def volume_render_split(rgbs: torch.Tensor, sigmas: torch.Tensor, z_vals: torch.Tensor,
                        noise: Optional[torch.Tensor] = None, noise_std: float = 0.5,
                        last_back: bool = False, white_back: bool = False,
                        clamp_mode: str = "relu", fill_mode: Optional[str] = None):
    """`volume_render` with rgb (b, n, s, c) and sigma (b, n, s, 1) apart."""
    weights = render_weights(sigmas, z_vals, noise, noise_std, clamp_mode)
    weights_sum = weights.sum(2)
    if last_back:
        last = torch.zeros_like(weights)
        last[:, :, -1] = 1.0
        weights = weights + last * (1.0 - weights_sum)[:, :, None]
    rgb_final = (weights * rgbs).sum(-2)
    depth_final = (weights * z_vals).sum(-2)
    return _finish(weights_sum, rgb_final, white_back, fill_mode), depth_final, weights


def sample_pdf(u: Optional[torch.Tensor], bins: torch.Tensor, weights: torch.Tensor,
               n_importance: int, det: bool = False, eps: float = 1e-5) -> torch.Tensor:
    """Inverse-CDF importance sampling: bins (R, B) edges, weights (R, B-1),
    ``u`` (R, n_importance) uniforms (unused with ``det``, which takes an
    even grid in [0, 1]).  Returns samples (R, n_importance)."""
    n_rays = weights.shape[0]
    weights = weights + eps
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)], -1)   # (R, B)
    if det:
        u = torch.linspace(0.0, 1.0, n_importance, dtype=bins.dtype, device=bins.device)
        u = u[None].expand(n_rays, n_importance)
    elif u is None:
        raise ValueError("sample_pdf with det=False needs its uniforms u")
    u = u.to(cdf.dtype).contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, side="left")
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=weights.shape[1])
    cdf_b, cdf_a = torch.gather(cdf, 1, below), torch.gather(cdf, 1, above)
    bins_b, bins_a = torch.gather(bins, 1, below), torch.gather(bins, 1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bins_b + (u - cdf_b) / denom * (bins_a - bins_b)


@torch.no_grad()
def get_fine_points_from_sigma(u, sigmas, z_vals, clamp_mode: str, noise_std: float,
                               num_steps: int, ray_origins, ray_directions, noise=None,
                               det: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fine points (b, n, num_steps, 3) and depths (b, n, num_steps, 1),
    detached, from the coarse density (b, n, s, 1).  ``u`` (b * n,
    num_steps) are the resample's uniforms, ``noise`` (b, n, s, 1) its
    density noise."""
    b, n, s, _ = sigmas.shape
    weights = render_weights(sigmas, z_vals, noise, noise_std, clamp_mode)
    w = weights.reshape(b * n, s) + 1e-5
    z = z_vals.reshape(b * n, s)
    z_mid = 0.5 * (z[:, :-1] + z[:, 1:])
    fine_z = sample_pdf(u, z_mid, w[:, 1:-1], num_steps, det=det).reshape(b, n, num_steps, 1)
    fine_points = ray_origins[:, :, None, :] + ray_directions[:, :, None, :] * fine_z
    return fine_points, fine_z


def _order(z_vals: torch.Tensor):
    """Stable depth order of samples in arrival order (ties: the earlier
    sample first): (before[j, k] = k precedes j, rank), both f32 at least."""
    z = z_vals[..., 0]
    cf = torch.float32 if z.element_size() < 4 else z.dtype
    m = z.shape[-1]
    ar = torch.arange(m, device=z.device)
    less = z[..., None, :] < z[..., :, None]
    equal = z[..., None, :] == z[..., :, None]
    before = (less | (equal & (ar[None, :] < ar[:, None]))).to(cf)
    return before, before.sum(-1)


def volume_render_unsorted(rgbs: torch.Tensor, sigmas: torch.Tensor, z_vals: torch.Tensor,
                           noise: Optional[torch.Tensor] = None, noise_std: float = 0.5,
                           last_back: bool = False, white_back: bool = False,
                           clamp_mode: str = "relu", fill_mode: Optional[str] = None):
    """Alpha compositing over samples in any depth order (rgbs (b, n, m, c),
    sigmas/z_vals (b, n, m, 1)): each sample's transmittance sums the log
    survivals of the samples before it in the stable depth order, its delta
    reaches the next sample in that order, and the depth-last sample gets
    1e10.  Returns (rgb, depth, weights in ARRIVAL order)."""
    f = rgbs.dtype
    before, rank = _order(z_vals)
    cf = before.dtype
    m = rank.shape[-1]
    density = _density(sigmas, noise, noise_std, clamp_mode)
    z = z_vals[..., 0].to(cf)
    succ = (rank[..., :, None] + 1.0 == rank[..., None, :]).to(cf)
    z_next = (succ * z[..., None, :]).sum(-1)
    is_last = rank == (m - 1)
    deltas = torch.where(is_last, torch.full_like(z, 1e10), z_next - z)[..., None].to(f)
    alphas = 1.0 - torch.exp(-deltas * density)
    logx = torch.log(torch.clamp(1.0 - alphas[..., 0], min=1e-10)).to(cf)
    transmittance = torch.exp((before * logx[..., None, :]).sum(-1)).to(f)[..., None]
    weights = alphas * transmittance
    weights_sum = weights.sum(2)
    if last_back:
        weights = weights + (1.0 - weights_sum)[:, :, None, :] * is_last[..., None].to(f)
    rgb_final = (weights * rgbs).sum(-2)
    depth_final = (weights * z_vals).sum(-2)
    return _finish(weights_sum, rgb_final, white_back, fill_mode), depth_final, weights
