"""Fused ray-tile renderer: the NeRF stage of `points_forward`, forward only.

Counterpart of `cips3d_tpu/ops/pallas/ray_tile.py` (the forward of
`fused_ray_render`):

    coarse FiLM-SIREN -> resample weights -> inverse-CDF importance sample
        -> fine FiLM-SIREN -> sort-free alpha compositing -> (feature, depth)

Two versions of one function over the same inputs:
  * `ray_tile_plain`, PyTorch ops, ported from the Pallas module's
    `_jnp_core`;
  * `ray_tile_cuda`, the hand-written kernel of `csrc/ray_tile.cu`.
`ray_tile` runs the plain version for tensors on the CPU and the kernel for
tensors on a CUDA device; a failed build or launch raises.

The random draws (importance-sample uniforms ``u``, density noise ``nc`` and
``nf``) are made outside the kernel, as in the JAX package, and can be
passed in: `RayDraws`.  The style FCs that make the FiLM gains and biases
(`compute_films`) are tiny matmuls outside the kernel.

Numerics as in the Pallas kernel: matmul inputs in the mm dtype (f32 or
bf16) with f32 accumulation; sines and all depth/CDF/compositing math in f32.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from cips3d_tpu_torch.ops import build
from cips3d_tpu_torch.ops.fast_sin import fast_sin as _fast_sin

MAX_STEPS = 32     # the kernel gives each of a ray's 2S samples to one lane of a warp pair
MAX_WIDTH = 128    # the kernel's lane tiling covers layer widths up to 128


class RayDraws(NamedTuple):
    """Random draws of one `fused_ray_render` call (all float32)."""

    u: torch.Tensor    # (b, n, S) importance-sample uniforms in [0, 1)
    nc: torch.Tensor   # (b, n, S) resample density noise, standard normal
    nf: torch.Tensor   # (b, n, 2S) compositing density noise, standard normal


def draw_ray_randoms(b: int, n: int, S: int, use_noise: bool,
                     generator: Optional[torch.Generator], device) -> RayDraws:
    """Draw a call's uniforms and (if ``use_noise``) its density noise."""
    u = torch.rand((b, n, S), generator=generator, device=device)
    if use_noise:
        nc = torch.randn((b, n, S), generator=generator, device=device)
        nf = torch.randn((b, n, 2 * S), generator=generator, device=device)
    else:
        nc = torch.zeros((b, n, S), device=device)
        nf = torch.zeros((b, n, 2 * S), device=device)
    return RayDraws(u, nc, nf)


def extract_siren_weights(siren) -> Dict[str, torch.Tensor]:
    """The kernel's weights from a `NeRFNetwork`, in (in, out) layout:
    ``w{i}``/``b{i}`` per hidden layer, ``wc``/``bc`` colour FiLM,
    ``wr``/``br`` rgb head, ``ws`` (H, 1)/``bs`` (1,) sigma head."""
    out = {}
    for i, layer in enumerate(siren.network):
        out[f"w{i}"] = layer.linear.weight.T
        out[f"b{i}"] = layer.linear.bias
    out["wc"] = siren.color_layer_sine.linear.weight.T
    out["bc"] = siren.color_layer_sine.linear.bias
    out["wr"] = siren.color_layer_linear[0].weight.T
    out["br"] = siren.color_layer_linear[0].bias
    out["ws"] = siren.final_layer.weight.T
    out["bs"] = siren.final_layer.bias
    return out


def compute_films(siren, style_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-sample FiLM gains and biases, each (b, dim): gain =
    gain_fc(style) * 15 + 30, bias = bias_fc(style)."""
    p = siren.name_prefix
    out = {}
    for i, layer in enumerate(siren.network):
        out[f"g{i}"], out[f"f{i}"] = layer.films(style_dict[f"{p}_w{i}"])
    out["gc"], out["fc"] = siren.color_layer_sine.films(style_dict[f"{p}_rgb"])
    return out


def flat_weights(siren, style_dict) -> List[torch.Tensor]:
    """The flat f32 weight list both versions take, in the Pallas module's
    order: ``(w_i, b_i, g_i, f_i)`` per hidden layer, then
    ``(wc, bc, gc, fc, wr, br, ws, bs)``."""
    w = extract_siren_weights(siren)
    f = compute_films(siren, style_dict)
    wt = []
    for i in range(len(siren.network)):
        wt += [w[f"w{i}"], w[f"b{i}"], f[f"g{i}"], f[f"f{i}"]]
    wt += [w["wc"], w["bc"], f["gc"], f["fc"], w["wr"], w["br"], w["ws"], w["bs"]]
    return [t.float().contiguous() for t in wt]


def _split(wt: Sequence[torch.Tensor]):
    L = (len(wt) - 8) // 4
    return [tuple(wt[4 * i: 4 * i + 4]) for i in range(L)], tuple(wt[4 * L:])


def _density(x, clamp_mode):
    if clamp_mode == "softplus":
        return F.softplus(x)
    if clamp_mode == "relu":
        return torch.relu(x)
    raise ValueError(f"clamp_mode must be 'relu' or 'softplus', got {clamp_mode!r}")


def _mlp(wt, p, fast_sin, mm_dtype, warp_scale):
    """The FiLM-SIREN on points p (b, N, 3) -> rgb (b, N, R), sigma (b, N)."""
    layers, (wc, bc, gc, fc, wr, br, ws, bs) = _split(wt)
    sin = _fast_sin if fast_sin else torch.sin

    def mm(x):  # round to the matmul-input dtype; products of the rounded values are exact in f32
        return x.to(mm_dtype).to(p.dtype)

    h = mm(p * warp_scale)
    for w_, b_, g_, f_ in layers:
        a = h @ mm(w_) + b_
        h = mm(sin(g_[:, None] * a + f_[:, None]))
    sig = h @ mm(ws) + bs
    ac = h @ mm(wc) + bc
    hc = mm(sin(gc[:, None] * ac + fc[:, None]))
    return hc @ mm(wr) + br, sig[..., 0]


def _fine_depths(sig_c, z, u, nc, noise_std, clamp_mode):
    """Resample weights from the coarse densities, then the inverse-CDF
    importance sample: fine depths (b, n, S)."""
    S = z.shape[-1]
    deltas = torch.cat([z[..., 1:] - z[..., :-1], torch.full_like(z[..., :1], 1e10)], -1)
    sc = sig_c + nc * noise_std if noise_std != 0 else sig_c
    alpha = 1.0 - torch.exp(-deltas * _density(sc, clamp_mode))
    logx = torch.log(torch.clamp(1.0 - alpha, min=1e-10))   # max(), never + eps
    excl = torch.triu(torch.ones(S, S, dtype=z.dtype, device=z.device), diagonal=1)
    w_c = alpha * torch.exp(logx @ excl)
    inner = (w_c + 1e-5)[..., 1:-1] + 1e-5
    pdf = inner / inner.sum(-1, keepdim=True)
    nb = S - 2
    cmask = (torch.arange(nb, device=z.device)[:, None]
             < torch.arange(nb + 1, device=z.device)[None, :]).to(z.dtype)
    cdf = pdf @ cmask                                       # (b, n, S-1), cdf[0] = 0
    z_mid = 0.5 * (z[..., :-1] + z[..., 1:])
    inds = (cdf[..., None, :] < u[..., :, None]).sum(-1)    # searchsorted, side='left'
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=nb)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    zm_b = torch.gather(z_mid, -1, below)
    zm_a = torch.gather(z_mid, -1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return zm_b + (u - cdf_b) / denom * (zm_a - zm_b)


def plain_fine_depths(
    wt, pts, z, u, nc, noise_std: float = 0.0, *, clamp_mode: str = "relu",
    fast_sin: bool = False, mm_dtype=torch.float32, warp_scale: float = 2.0 / 0.24,
) -> torch.Tensor:
    """The fine depths (b, n, S) that `ray_tile_plain` samples from the same
    inputs."""
    b, n, S, _ = pts.shape
    _, sig_c = _mlp(wt, pts.reshape(b, n * S, 3), fast_sin, mm_dtype, warp_scale)
    return _fine_depths(sig_c.reshape(b, n, S), z, u, nc, noise_std, clamp_mode)


def ray_tile_plain(
    wt, pts, org, dirs, z, u, nc, nf, noise_std: float = 0.0, *,
    clamp_mode: str = "relu", white_back: bool = False, last_back: bool = False,
    fast_sin: bool = False, mm_dtype=torch.float32, warp_scale: float = 2.0 / 0.24,
    out_dtype=torch.float32, fine_z: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (the Pallas module's `_jnp_core`).

    wt: `flat_weights`.  pts (b, n, S, 3); org, dirs (b, n, 3); z, u, nc
    (b, n, S); nf (b, n, 2S); all f32 (or all f64, with ``mm_dtype`` f64,
    for a float64 witness).  Returns (feature (b, n, R) in ``out_dtype``,
    depth (b, n, 1) in the inputs' dtype).  ``fine_z`` (b, n, S), if given,
    replaces the importance-sampled depths: a witness for diagnosing where
    the kernel and this version part."""
    b, n, S, _ = pts.shape
    m = 2 * S
    use_noise = noise_std != 0
    rgb_c, sig_c = _mlp(wt, pts.reshape(b, n * S, 3), fast_sin, mm_dtype, warp_scale)
    rgb_c = rgb_c.reshape(b, n, S, -1)
    sig_c = sig_c.reshape(b, n, S)
    if fine_z is None:
        with torch.no_grad():   # the reference resamples under no_grad
            fine_z = _fine_depths(sig_c, z, u, nc, noise_std, clamp_mode)
    fine_pts = org[:, :, None] + dirs[:, :, None] * fine_z[..., None]
    rgb_f, sig_f = _mlp(wt, fine_pts.reshape(b, n * S, 3), fast_sin, mm_dtype, warp_scale)

    z_all = torch.cat([fine_z, z], -1)                                  # (b, n, m)
    sig_all = torch.cat([sig_f.reshape(b, n, S), sig_c], -1)
    rgb_all = torch.cat([rgb_f.reshape(b, n, S, -1), rgb_c], -2)
    less = z_all[..., None, :] < z_all[..., :, None]                   # [j, k]: z_k < z_j
    equal = z_all[..., None, :] == z_all[..., :, None]
    ar = torch.arange(m, device=z.device)
    tie = ar[None, :] < ar[:, None]                                     # k < j: fine first
    before = (less | (equal & tie)).to(z.dtype)
    rank = before.sum(-1)
    if use_noise:
        sig_all = sig_all + nf * noise_std
    dens = _density(sig_all, clamp_mode)
    succ = (rank[..., :, None] + 1.0 == rank[..., None, :]).to(z.dtype)
    z_next = (succ * z_all[..., None, :]).sum(-1)
    is_last = rank == float(m - 1)
    deltas_m = torch.where(is_last, torch.full_like(z_all, 1e10), z_next - z_all)
    alpha = 1.0 - torch.exp(-deltas_m * dens)
    logx = torch.log(torch.clamp(1.0 - alpha, min=1e-10))
    trans = torch.exp((before * logx[..., None, :]).sum(-1))
    w = alpha * trans
    w_sum = w.sum(-1, keepdim=True)
    if last_back:
        w = w + (1.0 - w_sum) * is_last.to(z.dtype)
    fea = (w[..., None] * rgb_all).sum(-2)
    depth = (w * z_all).sum(-1, keepdim=True)
    if white_back:
        fea = fea + 1.0 - w_sum
    return fea.to(out_dtype), depth


def _padded(t: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = (-t.shape[-1]) % multiple
    return F.pad(t, (0, pad)) if pad else t


def ray_tile_cuda(
    wt, pts, org, dirs, z, u, nc, nf, noise_std: float = 0.0, *,
    clamp_mode: str = "relu", white_back: bool = False, last_back: bool = False,
    fast_sin: bool = False, mm_dtype=torch.float32, warp_scale: float = 2.0 / 0.24,
    out_dtype=torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel (`csrc/ray_tile.cu`); same arguments and results as
    `ray_tile_plain`.  Raises if the library cannot be built or the launch
    fails; never falls back to the plain version."""
    layers, (wc, bc, gc, fc, wr, br, ws, bs) = _split(wt)
    b, n, S, _ = pts.shape
    L, H, C, R = len(layers), layers[0][0].shape[1], wc.shape[1], wr.shape[1]
    dev = pts.device
    if dev.type != "cuda":
        raise ValueError(f"ray_tile_cuda needs CUDA tensors, got {dev}")
    if not 3 <= S <= MAX_STEPS or max(H, C, R) > MAX_WIDTH or L < 1:
        raise ValueError(f"unsupported shape: S={S} (3..{MAX_STEPS}), H={H}, C={C}, R={R} "
                         f"(<= {MAX_WIDTH}), L={L}")
    if clamp_mode not in ("relu", "softplus"):
        raise ValueError(f"clamp_mode must be 'relu' or 'softplus', got {clamp_mode!r}")
    if mm_dtype not in (torch.float32, torch.bfloat16) or out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mm/out dtype must be float32 or bfloat16, got {mm_dtype}, {out_dtype}")
    expect = {"pts": (pts, (b, n, S, 3)), "org": (org, (b, n, 3)), "dirs": (dirs, (b, n, 3)),
              "z": (z, (b, n, S)), "u": (u, (b, n, S)), "nc": (nc, (b, n, S)),
              "nf": (nf, (b, n, 2 * S))}
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"{name}: expected float32 {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    for t in wt:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError("weights and films must be float32 on the inputs' device")
    pts, org, dirs, z, u, nc, nf = (t.contiguous() for t in (pts, org, dirs, z, u, nc, nf))

    mats = [layers[0][0]] + [l[0] for l in layers[1:]] + [wc, wr, ws]
    wbuf = _padded(torch.cat([w.reshape(-1) for w in mats]).to(mm_dtype), 8).contiguous()
    pbuf = _padded(torch.cat([l[1].reshape(-1) for l in layers] + [bc.reshape(-1), br.reshape(-1),
                                                                  bs.reshape(-1)]), 4).contiguous()
    films = _padded(torch.cat([torch.cat([l[2], l[3]], 1) for l in layers] + [gc, fc], 1),
                    4).contiguous()
    if films.shape[0] != b:
        raise ValueError(f"films have batch {films.shape[0]}, points {b}")
    fea = torch.empty((b, n, R), dtype=out_dtype, device=dev)
    depth = torch.empty((b, n, 1), dtype=torch.float32, device=dev)
    use_noise = noise_std != 0
    flags = (int(use_noise) | int(fast_sin) << 1 | int(mm_dtype == torch.bfloat16) << 2
             | int(out_dtype == torch.bfloat16) << 3)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cips_ray_tile_forward(
            pts.data_ptr(), org.data_ptr(), dirs.data_ptr(), z.data_ptr(), u.data_ptr(),
            nc.data_ptr(), nf.data_ptr(), wbuf.data_ptr(), pbuf.data_ptr(), films.data_ptr(),
            fea.data_ptr(), depth.data_ptr(),
            b, n, S, L, H, C, R, float(noise_std), float(warp_scale),
            wbuf.numel(), pbuf.numel(), films.shape[1],
            int(clamp_mode == "softplus"), int(white_back), int(last_back), flags, stream)
    build.check(lib, err, "ray_tile")
    ray_tile_cuda.launches += 1
    return fea, depth


ray_tile_cuda.launches = 0


def ray_tile(wt, pts, *args, **kwargs):
    """`ray_tile_plain` for CPU tensors, `ray_tile_cuda` otherwise."""
    if pts.device.type == "cpu":
        return ray_tile_plain(wt, pts, *args, **kwargs)
    return ray_tile_cuda(wt, pts, *args, **kwargs)


@torch.no_grad()
def fused_ray_render(
    siren, style_dict: Mapping[str, torch.Tensor],
    pts: torch.Tensor,       # (b, n, S, 3)
    origins: torch.Tensor,   # (b, n, 3)
    dirs: torch.Tensor,      # (b, n, 3)
    z_vals: torch.Tensor,    # (b, n, S, 1)
    *,
    draws: Optional[RayDraws] = None,
    generator: Optional[torch.Generator] = None,
    noise_std: float = 0.0,
    clamp_mode: str = "relu",
    white_back: bool = False,
    last_back: bool = False,
    dtype=torch.float32,
    fast_sin: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused NeRF stage of `GeneratorNerfINR.points_forward` (hierarchical):
    returns (pixels_fea (b, n, R) in ``dtype``, depth (b, n, 1) f32).

    ``draws`` supplies the random draws (see `RayDraws`); without it they are
    drawn from ``generator``.  Forward only: the resample is detached as in
    the reference, and no backward kernel is ported yet."""
    b, n, S, _ = pts.shape
    if draws is None:
        draws = draw_ray_randoms(b, n, S, noise_std != 0, generator, pts.device)
    mm_dtype = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
    wt = flat_weights(siren, style_dict)
    return ray_tile(
        wt, pts.float(), origins.float(), dirs.float(), z_vals[..., 0].float(),
        draws.u.float(), draws.nc.float(), draws.nf.float(), float(noise_std),
        clamp_mode=clamp_mode, white_back=white_back, last_back=last_back,
        fast_sin=fast_sin, mm_dtype=mm_dtype, warp_scale=2.0 / siren.box_sidelength,
        out_dtype=dtype,
    )
