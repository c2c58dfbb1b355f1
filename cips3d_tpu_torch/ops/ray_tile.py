"""Fused ray-tile renderer: the NeRF stage of `points_forward`, forward and
backward.

Counterpart of `cips3d_tpu/ops/pallas/ray_tile.py` (`fused_ray_render`
and its custom VJP):

    coarse FiLM-SIREN -> resample weights -> inverse-CDF importance sample
        -> fine FiLM-SIREN -> sort-free alpha compositing -> (feature, depth)

Two versions of each function over the same inputs:
  * forward: `ray_tile_plain` (PyTorch ops, ported from the Pallas module's
    `_jnp_core`) and `ray_tile_cuda` (`csrc/ray_tile.cu`), both optionally
    with the residuals of the residual-mode backward;
  * backward: `ray_tile_bwd_plain` (a mirror of the Pallas backward's
    stages) and `ray_tile_bwd_cuda` (`csrc/ray_tile_bwd.cu`), each in
    recompute or residual mode.
`ray_tile` and `ray_tile_bwd` run the plain version for tensors on the CPU
and the kernel for tensors on a CUDA device; a failed build or launch
raises.  `RayTileFunction` puts them under autograd.

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
from cips3d_tpu_torch.ops.fast_sin import fast_sin_grad

MAX_STEPS = 32     # the kernel gives each of a ray's 2S samples to one lane of a warp pair
MAX_WIDTH = 128    # the kernels' MMA tiling covers layer widths up to 128 ...
WIDTH_STEP = 16    # ... in multiples of 16 (one bf16 k-step)
BLOCK_RAYS = 16    # rays per block of the forward and of the backward's cotangent kernel
SPLIT_ROWS = 2048  # points per block of the backward's weight-grad kernel (a multiple of 32)
POINT_WIDTH = 8    # row of the backward's point scratch (3 used)


class RayDraws(NamedTuple):
    """Random draws of one `fused_ray_render` call (all float32)."""

    u: torch.Tensor    # (b, n, S) importance-sample uniforms in [0, 1)
    nc: torch.Tensor   # (b, n, S) resample density noise, standard normal
    nf: torch.Tensor   # (b, n, 2S) compositing density noise, standard normal


def draw_ray_randoms(b: int, n: int, S: int, use_noise: bool,
                     generator: Optional[torch.Generator], device,
                     hierarchical: bool = True) -> RayDraws:
    """Draw a call's uniforms and (if ``use_noise``) its density noise;
    without ``hierarchical`` (the unfused stage's coarse-only compositing)
    nf is (b, n, S)."""
    m = 2 * S if hierarchical else S
    u = torch.rand((b, n, S), generator=generator, device=device)
    if use_noise:
        nc = torch.randn((b, n, S), generator=generator, device=device)
        nf = torch.randn((b, n, m), generator=generator, device=device)
    else:
        nc = torch.zeros((b, n, S), device=device)
        nf = torch.zeros((b, n, m), device=device)
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


def _mlp(wt, p, fast_sin, mm_dtype, warp_scale, states: bool = False):
    """The FiLM-SIREN on points p (b, N, 3) -> rgb (b, N, R), sigma (b, N);
    with ``states`` also the dict of what the backward needs: the rounded
    input ``x``, per hidden layer the pre-activation ``a`` (f32) and output
    ``h`` (rounded), the colour FiLM's ``ac`` and ``hc``."""
    layers, (wc, bc, gc, fc, wr, br, ws, bs) = _split(wt)
    sin = _fast_sin if fast_sin else torch.sin

    def mm(x):  # round to the matmul-input dtype; products of the rounded values are exact in f32
        return x.to(mm_dtype).to(p.dtype)

    h = x = mm(p * warp_scale)
    acts, hids = [], []
    for w_, b_, g_, f_ in layers:
        a = h @ mm(w_) + b_
        h = mm(sin(g_[:, None] * a + f_[:, None]))
        acts.append(a)
        hids.append(h)
    sig = h @ mm(ws) + bs
    ac = h @ mm(wc) + bc
    hc = mm(sin(gc[:, None] * ac + fc[:, None]))
    rgb = hc @ mm(wr) + br
    if states:
        return rgb, sig[..., 0], dict(x=x, a=acts, h=hids, ac=ac, hc=hc)
    return rgb, sig[..., 0]


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


def _composite(fine_z, z, sig_f, sig_c, nf, noise_std, clamp_mode, last_back):
    """Sort-free compositing weights of the 2S samples in [fine, coarse]
    arrival order, and every intermediate the backward reads."""
    z_all = torch.cat([fine_z, z], -1)                                  # (b, n, m)
    m = z_all.shape[-1]
    sig_all = torch.cat([sig_f, sig_c], -1)
    less = z_all[..., None, :] < z_all[..., :, None]                   # [j, k]: z_k < z_j
    equal = z_all[..., None, :] == z_all[..., :, None]
    ar = torch.arange(m, device=z.device)
    tie = ar[None, :] < ar[:, None]                                     # k < j: fine first
    before = (less | (equal & tie)).to(z.dtype)
    rank = before.sum(-1)
    if noise_std != 0:
        sig_all = sig_all + nf * noise_std
    dens = _density(sig_all, clamp_mode)
    succ = (rank[..., :, None] + 1.0 == rank[..., None, :]).to(z.dtype)
    z_next = (succ * z_all[..., None, :]).sum(-1)
    is_last = (rank == float(m - 1)).to(z.dtype)
    deltas = torch.where(is_last > 0, torch.full_like(z_all, 1e10), z_next - z_all)
    expd = torch.exp(-deltas * dens)
    alpha = 1.0 - expd
    logx = torch.log(torch.clamp(1.0 - alpha, min=1e-10))
    trans = torch.exp((before * logx[..., None, :]).sum(-1))
    w0 = alpha * trans
    w_sum = w0.sum(-1, keepdim=True)
    w = w0 + (1.0 - w_sum) * is_last if last_back else w0
    return dict(z_all=z_all, sig_all=sig_all, before=before, is_last=is_last, deltas=deltas,
                expd=expd, alpha=alpha, trans=trans, w=w, w_sum=w_sum)


def ray_tile_plain(
    wt, pts, org, dirs, z, u, nc, nf, noise_std: float = 0.0, *,
    clamp_mode: str = "relu", white_back: bool = False, last_back: bool = False,
    fast_sin: bool = False, mm_dtype=torch.float32, warp_scale: float = 2.0 / 0.24,
    out_dtype=torch.float32, fine_z: Optional[torch.Tensor] = None,
    with_residuals: bool = False,
):
    """Plain PyTorch version (the Pallas module's `_jnp_core`).

    wt: `flat_weights`.  pts (b, n, S, 3); org, dirs (b, n, 3); z, u, nc
    (b, n, S); nf (b, n, 2S); all f32 (or all f64, with ``mm_dtype`` f64,
    for a float64 witness).  Returns (feature (b, n, R) in ``out_dtype``,
    depth (b, n, 1) in the inputs' dtype).  ``fine_z`` (b, n, S), if given,
    replaces the importance-sampled depths: a witness for diagnosing where
    the kernel and this version part.  The resample and the fine points are
    detached, as in the reference.  ``with_residuals`` also returns the
    residuals of the residual-mode backward, (rh, ra, rhc, rac): per pass
    (0 coarse, 1 fine) and point, the hidden layers' outputs h (mm dtype)
    and pre-activations a (f32), concatenated over the layers, (b, 2, n, S,
    L*H), and the colour FiLM's hc (mm dtype) and ac (f32), (b, 2, n, S, C)."""
    b, n, S, _ = pts.shape
    rgb_c, sig_c, st_c = _mlp(wt, pts.reshape(b, n * S, 3), fast_sin, mm_dtype, warp_scale,
                              states=True)
    rgb_c = rgb_c.reshape(b, n, S, -1)
    sig_c = sig_c.reshape(b, n, S)
    if fine_z is None:
        with torch.no_grad():   # the reference resamples under no_grad
            fine_z = _fine_depths(sig_c, z, u, nc, noise_std, clamp_mode)
    fine_pts = (org[:, :, None] + dirs[:, :, None] * fine_z[..., None]).detach()
    rgb_f, sig_f, st_f = _mlp(wt, fine_pts.reshape(b, n * S, 3), fast_sin, mm_dtype, warp_scale,
                              states=True)
    cp = _composite(fine_z, z, sig_f.reshape(b, n, S), sig_c, nf, noise_std, clamp_mode,
                    last_back)
    rgb_all = torch.cat([rgb_f.reshape(b, n, S, -1), rgb_c], -2)
    fea = (cp["w"][..., None] * rgb_all).sum(-2)
    depth = (cp["w"] * cp["z_all"]).sum(-1, keepdim=True)
    if white_back:
        fea = fea + 1.0 - cp["w_sum"]
    if not with_residuals:
        return fea.to(out_dtype), depth

    def res(key, dtype):
        parts = [torch.cat(st[key], -1) if isinstance(st[key], list) else st[key]
                 for st in (st_c, st_f)]
        return torch.stack([t.reshape(b, n, S, -1) for t in parts], 1).to(dtype).detach()

    residuals = (res("h", mm_dtype), res("a", torch.float32), res("hc", mm_dtype),
                 res("ac", torch.float32))
    return fea.to(out_dtype), depth, residuals


def ray_tile_bwd_plain(
    wt, pts, org, dirs, z, u, nc, nf, noise_std: float, d_fea, d_dep, *,
    residuals=None, clamp_mode: str = "relu", white_back: bool = False,
    last_back: bool = False, fast_sin: bool = False, mm_dtype=torch.float32,
    warp_scale: float = 2.0 / 0.24, fine_z: Optional[torch.Tensor] = None,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Plain PyTorch version of the backward kernel (the Pallas module's
    `_ray_tile_bwd_kernel`), stage by stage: the MLP states (recomputed, or
    read from ``residuals`` as `ray_tile_plain` returns them), the detached
    resample, compositing forward and backward, then `mlp_bwd` for the fine
    pass (weight and FiLM grads only) and the coarse pass (also d pts).
    d_fea (b, n, R), d_dep (b, n, 1).  Returns (grads in the order and
    shapes of ``wt``, d pts (b, n, S, 3)); org, dirs, z, u and the noise get
    no gradient (the resample is detached).  ``fine_z``, if given, replaces
    the resampled depths (recompute mode): a witness, as in
    `ray_tile_plain`."""
    layers, (wc, bc, gc, fc, wr, br, ws, bs) = _split(wt)
    L = len(layers)
    b, n, S, _ = pts.shape
    dt = pts.dtype
    sin_grad = fast_sin_grad if fast_sin else torch.cos

    def mm(x):
        return x.to(mm_dtype).to(dt)

    def states(p, pi):
        """MLP states of pass ``pi`` at points p (b, N, 3), with sig and rgb."""
        if residuals is None:
            rgb, sig, st = _mlp(wt, p, fast_sin, mm_dtype, warp_scale, states=True)
            return dict(st, sig=sig, rgb=rgb)
        rh, ra, rhc, rac = (t[:, pi].reshape(b, n * S, -1).to(dt) for t in residuals)
        H = rh.shape[-1] // L
        st = dict(x=mm(p * warp_scale), a=list(ra.split(H, -1)), h=list(rh.split(H, -1)),
                  ac=rac, hc=rhc)
        st["sig"] = (st["h"][-1] @ mm(ws) + bs)[..., 0]
        st["rgb"] = rhc @ mm(wr) + br
        return st

    g = [torch.zeros_like(t) for t in wt]
    with torch.no_grad():
        st_c = states(pts.reshape(b, n * S, 3), 0)
        if fine_z is None:
            fine_z = _fine_depths(st_c["sig"].reshape(b, n, S), z, u, nc, noise_std, clamp_mode)
        fine_pts = org[:, :, None] + dirs[:, :, None] * fine_z[..., None]
        st_f = states(fine_pts.reshape(b, n * S, 3), 1)
        cp = _composite(fine_z, z, st_f["sig"].reshape(b, n, S), st_c["sig"].reshape(b, n, S),
                        nf, noise_std, clamp_mode, last_back)
        rgb_all = torch.cat([st_f["rgb"].reshape(b, n, S, -1),
                             st_c["rgb"].reshape(b, n, S, -1)], -2)

        # ---- compositing backward ----
        d_fea = d_fea.to(dt)
        d_dep = d_dep.to(dt)
        d_w1 = (rgb_all * d_fea[..., None, :]).sum(-1) + d_dep * cp["z_all"]
        d_wsum = torch.zeros_like(d_dep)
        if white_back:
            d_wsum = d_wsum - d_fea.sum(-1, keepdim=True)
        if last_back:
            d_wsum = d_wsum - (d_w1 * cp["is_last"]).sum(-1, keepdim=True)
        d_w0 = d_w1 + d_wsum
        d_rgb_all = cp["w"][..., None] * d_fea[..., None, :]
        alpha, trans = cp["alpha"], cp["trans"]
        d_acc = trans * (d_w0 * alpha)
        d_logx = (cp["before"] * d_acc[..., :, None]).sum(-2)
        one_m = torch.clamp(1.0 - alpha, min=1e-10)
        d_alpha = d_w0 * trans + torch.where((1.0 - alpha) > 1e-10, -d_logx / one_m,
                                             torch.zeros_like(alpha))
        d_dens = d_alpha * cp["deltas"] * cp["expd"]
        sig_all = cp["sig_all"]
        if clamp_mode == "softplus":
            d_sig_all = d_dens * torch.sigmoid(sig_all)
        else:
            d_sig_all = d_dens * (sig_all > 0).to(dt)

        def mlp_bwd(st, d_rgb, d_sig, need_dx):
            """d_rgb (b, N, R), d_sig (b, N): adds the weight and FiLM grads
            into g; returns d x (b, N, 3) if ``need_dx``."""
            ow = 4 * L
            d_rgbm = mm(d_rgb)
            g[ow + 4] += torch.einsum("bnk,bnc->kc", st["hc"], d_rgbm)
            g[ow + 5] += d_rgb.sum((0, 1)).reshape(g[ow + 5].shape)
            d_hc = d_rgbm @ mm(wr).T
            d_argc = d_hc * sin_grad(gc[:, None] * st["ac"] + fc[:, None])
            g[ow + 2] += (d_argc * st["ac"]).sum(1)
            g[ow + 3] += d_argc.sum(1)
            d_ac = d_argc * gc[:, None]
            d_acm, d_sigm = mm(d_ac), mm(d_sig)
            h_last = st["h"][-1]
            g[ow] += torch.einsum("bnk,bnc->kc", h_last, d_acm)
            g[ow + 1] += d_ac.sum((0, 1)).reshape(g[ow + 1].shape)
            g[ow + 6] += torch.einsum("bnk,bn->k", h_last, d_sigm).reshape(g[ow + 6].shape)
            g[ow + 7] += d_sig.sum().reshape(g[ow + 7].shape)
            d_h = d_acm @ mm(wc).T + d_sigm[..., None] * mm(ws).reshape(1, 1, -1)
            for i in reversed(range(L)):
                w_, _, g_, f_ = layers[i]
                a = st["a"][i]
                d_arg = d_h * sin_grad(g_[:, None] * a + f_[:, None])
                g[4 * i + 2] += (d_arg * a).sum(1)
                g[4 * i + 3] += d_arg.sum(1)
                d_a = d_arg * g_[:, None]
                d_am = mm(d_a)
                inp = st["h"][i - 1] if i > 0 else st["x"]
                g[4 * i] += torch.einsum("bnk,bnc->kc", inp, d_am)
                g[4 * i + 1] += d_a.sum((0, 1)).reshape(g[4 * i + 1].shape)
                if i == 0 and not need_dx:
                    return None
                d_h = d_am @ mm(w_).T
            return d_h

        mlp_bwd(st_f, d_rgb_all[..., :S, :].reshape(b, n * S, -1),
                d_sig_all[..., :S].reshape(b, n * S), need_dx=False)
        d_x = mlp_bwd(st_c, d_rgb_all[..., S:, :].reshape(b, n * S, -1),
                      d_sig_all[..., S:].reshape(b, n * S), need_dx=True)
    return g, (d_x * warp_scale).reshape(b, n, S, 3)


def _padded(t: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = (-t.shape[-1]) % multiple
    return F.pad(t, (0, pad)) if pad else t


def _pack(wt, b: int, mm_dtype):
    """The kernels' weight buffers: wbuf (matrices in the mm dtype: w_0,
    w_1.., wc, wr, ws), pbuf (biases b_0.., bc, br, bs) and films (b,
    nfilm: g_0, f_0, g_1, f_1, .., gc, fc), each padded to 16 bytes."""
    layers, (wc, bc, gc, fc, wr, br, ws, bs) = _split(wt)
    mats = [l[0] for l in layers] + [wc, wr, ws]
    wbuf = _padded(torch.cat([w.reshape(-1) for w in mats]).to(mm_dtype), 8).contiguous()
    pbuf = _padded(torch.cat([l[1].reshape(-1) for l in layers] + [bc.reshape(-1), br.reshape(-1),
                                                                  bs.reshape(-1)]), 4).contiguous()
    films = _padded(torch.cat([torch.cat([l[2], l[3]], 1) for l in layers] + [gc, fc], 1),
                    4).contiguous()
    if films.shape[0] != b:
        raise ValueError(f"films have batch {films.shape[0]}, points {b}")
    return wbuf, pbuf, films


def forward_grid(b: int, n: int, sms: int) -> int:
    """Blocks of the persistent forward: one per SM, or one per ray block
    when there are fewer."""
    return max(1, min(b * -(-n // BLOCK_RAYS), sms))


class BwdPlan(NamedTuple):
    """Grid and scratch sizes of the backward kernels."""

    gx: int          # cotangent-kernel blocks per batch row (grid (gx, b))
    rows: int        # points of the call, both passes: b 2 n S
    nsplit: int      # weight-grad blocks per matrix, SPLIT_ROWS points each
    cot_width: int   # a point's cotangent row: d a_l (L H), d ac (C), d sigma (+7), d rgb (R)
    n_weight: int    # weight-grad elements (wbuf order)
    n_bias: int      # bias-grad elements (pbuf order)
    n_film: int      # FiLM-grad elements of one batch row (films order)


def bwd_plan(b: int, n: int, S: int, L: int, H: int, C: int, R: int, sms: int) -> BwdPlan:
    """The backward's split: about one cotangent block per SM, each walking
    the ray blocks x, x + gx, .. of one batch row; SPLIT_ROWS points per
    weight-grad block, a fixed split, so the sums keep their order."""
    rows = b * 2 * n * S
    return BwdPlan(gx=max(1, min(-(-n // BLOCK_RAYS), -(-sms // b))), rows=rows,
                   nsplit=-(-rows // SPLIT_ROWS), cot_width=L * H + C + 8 + R,
                   n_weight=3 * H + (L - 1) * H * H + H * C + C * R + H,
                   n_bias=L * H + C + R + 1, n_film=2 * L * H + 2 * C)


def _check(name, wt, pts, org, dirs, z, u, nc, nf, clamp_mode, mm_dtype, extra=()):
    """Shapes, dtypes and devices the kernels take; returns (L, H, C, R)."""
    layers, (wc, bc, gc, fc, wr, br, ws, bs) = _split(wt)
    b, n, S, _ = pts.shape
    L, H, C, R = len(layers), layers[0][0].shape[1], wc.shape[1], wr.shape[1]
    if (not 3 <= S <= MAX_STEPS or max(H, C, R) > MAX_WIDTH or L < 1
            or any(w % WIDTH_STEP for w in (H, C, R))):
        raise ValueError(f"unsupported shape: S={S} (3..{MAX_STEPS}), H={H}, C={C}, R={R} "
                         f"(multiples of {WIDTH_STEP} up to {MAX_WIDTH}), L={L}")
    dev = pts.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    if clamp_mode not in ("relu", "softplus"):
        raise ValueError(f"clamp_mode must be 'relu' or 'softplus', got {clamp_mode!r}")
    if mm_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mm dtype must be float32 or bfloat16, got {mm_dtype}")
    expect = {"pts": (pts, (b, n, S, 3), torch.float32), "org": (org, (b, n, 3), torch.float32),
              "dirs": (dirs, (b, n, 3), torch.float32), "z": (z, (b, n, S), torch.float32),
              "u": (u, (b, n, S), torch.float32), "nc": (nc, (b, n, S), torch.float32),
              "nf": (nf, (b, n, 2 * S), torch.float32)}
    expect.update({k: v for k, v in extra})
    for key, (t, shape, dtype) in expect.items():
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev:
            raise ValueError(f"{key}: expected {str(dtype)[6:]} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    for t in wt:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError("weights and films must be float32 on the inputs' device")
    return L, H, C, R


def _residual_shapes(b, n, S, L, H, C, mm_dtype):
    return {"rh": ((b, 2, n, S, L * H), mm_dtype), "ra": ((b, 2, n, S, L * H), torch.float32),
            "rhc": ((b, 2, n, S, C), mm_dtype), "rac": ((b, 2, n, S, C), torch.float32)}


def _flags(noise_std, fast_sin, mm_dtype, out_dtype=torch.float32):
    return (int(noise_std != 0) | int(fast_sin) << 1 | int(mm_dtype == torch.bfloat16) << 2
            | int(out_dtype == torch.bfloat16) << 3)


def _launch_forward(lib, inputs, packed, dims, noise_std, res, *, clamp_mode, white_back,
                    last_back, fast_sin, mm_dtype, warp_scale, out_dtype):
    """One launch of `csrc/ray_tile.cu` on contiguous CUDA ``inputs`` (pts,
    org, dirs, z, u, nc, nf); ``res`` is the four residual tensors or empty.
    Returns (feature, depth)."""
    b, n, S, L, H, C, R = dims
    wbuf, pbuf, films = packed
    dev = inputs[0].device
    if lib.cips_ray_tile_block_rays() != BLOCK_RAYS:
        raise RuntimeError("the kernel library's ray block is not BLOCK_RAYS")
    grid = forward_grid(b, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    fea = torch.empty((b, n, R), dtype=out_dtype, device=dev)
    depth = torch.empty((b, n, 1), dtype=torch.float32, device=dev)
    rgb = torch.empty((grid, BLOCK_RAYS, 2 * S, R), dtype=torch.float32, device=dev)
    res_ptrs = [t.data_ptr() for t in res] if res else [None] * 4
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cips_ray_tile_forward(
            *(t.data_ptr() for t in inputs), wbuf.data_ptr(), pbuf.data_ptr(), films.data_ptr(),
            fea.data_ptr(), depth.data_ptr(), *res_ptrs, rgb.data_ptr(),
            b, n, S, L, H, C, R, grid, float(noise_std), float(warp_scale),
            pbuf.numel(), films.shape[1], int(clamp_mode == "softplus"), int(white_back),
            int(last_back), _flags(noise_std, fast_sin, mm_dtype, out_dtype), stream)
    build.check(lib, err, "ray_tile")
    return fea, depth


def ray_tile_cuda(
    wt, pts, org, dirs, z, u, nc, nf, noise_std: float = 0.0, *,
    clamp_mode: str = "relu", white_back: bool = False, last_back: bool = False,
    fast_sin: bool = False, mm_dtype=torch.float32, warp_scale: float = 2.0 / 0.24,
    out_dtype=torch.float32, with_residuals: bool = False,
):
    """The CUDA kernel (`csrc/ray_tile.cu`); same arguments and results as
    `ray_tile_plain` (residuals in its layout).  Raises if the library
    cannot be built or the launch fails; never falls back to the plain
    version."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out dtype must be float32 or bfloat16, got {out_dtype}")
    L, H, C, R = _check("ray_tile_cuda", wt, pts, org, dirs, z, u, nc, nf, clamp_mode, mm_dtype)
    b, n, S, _ = pts.shape
    inputs = [t.contiguous() for t in (pts, org, dirs, z, u, nc, nf)]
    res = ([torch.empty(shape, dtype=dt, device=pts.device)
            for shape, dt in _residual_shapes(b, n, S, L, H, C, mm_dtype).values()]
           if with_residuals else [])
    fea, depth = _launch_forward(
        build.library(), inputs, _pack(wt, b, mm_dtype), (b, n, S, L, H, C, R), noise_std, res,
        clamp_mode=clamp_mode, white_back=white_back, last_back=last_back, fast_sin=fast_sin,
        mm_dtype=mm_dtype, warp_scale=warp_scale, out_dtype=out_dtype)
    if with_residuals:
        ray_tile_cuda.residual_launches += 1
        return fea, depth, tuple(res)
    ray_tile_cuda.launches += 1
    return fea, depth


ray_tile_cuda.launches = 0            # forward launches without residuals (kernel #2)
ray_tile_cuda.residual_launches = 0   # forward launches with residuals (kernel #2r)


def ray_tile(wt, pts, *args, **kwargs):
    """`ray_tile_plain` for CPU tensors, `ray_tile_cuda` otherwise."""
    if pts.device.type == "cpu":
        return ray_tile_plain(wt, pts, *args, **kwargs)
    return ray_tile_cuda(wt, pts, *args, **kwargs)


def _unpack_grads(wt, out_w, out_f, L, H, C, R):
    """The backward kernel's flat grads (wbuf/pbuf order, films order) in
    the order and shapes of ``wt``."""
    sizes = [3 * H] + [H * H] * (L - 1) + [H * C, C * R, H] + [H] * L + [C, R, 1]
    flat = list(out_w.split(sizes))
    mats, biases = flat[:L + 3], flat[L + 3:]
    films = list(out_f.split([H] * (2 * L) + [C, C], 1))
    g = []
    for i in range(L):
        g += [mats[i], biases[i], films[2 * i], films[2 * i + 1]]
    g += [mats[L], biases[L], films[2 * L], films[2 * L + 1], mats[L + 1], biases[L + 1],
          mats[L + 2], biases[L + 2]]
    return [gi.reshape(t.shape) for gi, t in zip(g, wt)]


def ray_tile_bwd_cuda(
    wt, pts, org, dirs, z, u, nc, nf, noise_std: float, d_fea, d_dep, *,
    residuals=None, clamp_mode: str = "relu", white_back: bool = False,
    last_back: bool = False, fast_sin: bool = False, mm_dtype=torch.float32,
    warp_scale: float = 2.0 / 0.24,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The backward kernels (`csrc/ray_tile_bwd.cu`), recompute mode without
    ``residuals`` (the forward kernel runs again with residuals into
    scratch), residual mode with them; same arguments and results as
    `ray_tile_bwd_plain`.  Deterministic: a fixed split (`bwd_plan`) summed
    in a fixed order.  Raises on a failed build or launch."""
    b, n, S, _ = pts.shape
    extra = [("d_fea", (d_fea, (b, n, wt[-4].shape[1]), torch.float32)),
             ("d_dep", (d_dep, (b, n, 1), torch.float32))]
    layers = _split(wt)[0]
    if residuals is not None:
        L, H, C = len(layers), layers[0][0].shape[1], wt[-8].shape[1]
        extra += [(k, (t, shape, dt)) for (k, (shape, dt)), t in
                  zip(_residual_shapes(b, n, S, L, H, C, mm_dtype).items(), residuals)]
    L, H, C, R = _check("ray_tile_bwd_cuda", wt, pts, org, dirs, z, u, nc, nf, clamp_mode,
                        mm_dtype, extra)
    dev = pts.device
    inputs = [t.contiguous() for t in (pts, org, dirs, z, u, nc, nf)]
    d_fea, d_dep = d_fea.contiguous(), d_dep.contiguous()
    packed = _pack(wt, b, mm_dtype)
    wbuf, pbuf, films = packed
    lib = build.library()
    plan = bwd_plan(b, n, S, L, H, C, R, torch.cuda.get_device_properties(dev).multi_processor_count)
    if lib.cips_ray_tile_backward_cot_width(L, H, C, R) != plan.cot_width:
        raise RuntimeError("the kernel library's cotangent row is not bwd_plan's")
    opts = dict(clamp_mode=clamp_mode, white_back=white_back, last_back=last_back,
                fast_sin=fast_sin, mm_dtype=mm_dtype, warp_scale=warp_scale)
    if residuals is None:   # recompute mode: the MLP states from the forward kernel, again
        res = [torch.empty(shape, dtype=dt, device=dev)
               for shape, dt in _residual_shapes(b, n, S, L, H, C, mm_dtype).values()]
        _launch_forward(lib, inputs, packed, (b, n, S, L, H, C, R), noise_std, res,
                        out_dtype=torch.float32, **opts)
    else:
        res = [t.contiguous() for t in residuals]
    xs = torch.empty((b, 2, n, S, POINT_WIDTH), dtype=mm_dtype, device=dev)
    dq = torch.empty((b, 2, n, S, plan.cot_width), dtype=mm_dtype, device=dev)
    part_b = torch.empty((b, plan.gx, plan.n_bias + plan.n_film), dtype=torch.float32, device=dev)
    part_w = torch.empty((plan.nsplit, plan.n_weight), dtype=torch.float32, device=dev)
    d_pts = torch.empty((b, n, S, 3), dtype=torch.float32, device=dev)
    out_w = torch.empty((plan.n_weight + plan.n_bias,), dtype=torch.float32, device=dev)
    out_f = torch.empty((b, plan.n_film), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cips_ray_tile_backward(
            *(t.data_ptr() for t in inputs), wbuf.data_ptr(), pbuf.data_ptr(), films.data_ptr(),
            d_fea.data_ptr(), d_dep.data_ptr(), *(t.data_ptr() for t in res), xs.data_ptr(),
            dq.data_ptr(), part_b.data_ptr(), part_w.data_ptr(), d_pts.data_ptr(),
            out_w.data_ptr(), out_f.data_ptr(),
            b, n, S, L, H, C, R, plan.gx, plan.nsplit, SPLIT_ROWS, pbuf.numel(), films.shape[1],
            float(noise_std), float(warp_scale), int(clamp_mode == "softplus"), int(white_back),
            int(last_back), _flags(noise_std, fast_sin, mm_dtype), stream)
    build.check(lib, err, "ray_tile_bwd")
    if residuals is None:
        ray_tile_bwd_cuda.launches += 1
    else:
        ray_tile_bwd_cuda.residual_launches += 1
    return _unpack_grads(wt, out_w, out_f, L, H, C, R), d_pts


ray_tile_bwd_cuda.launches = 0            # recompute mode (kernel #3, 'pallas')
ray_tile_bwd_cuda.residual_launches = 0   # residual mode (kernel #3, 'pallas_residual')


def kernel_occupancy(S: int, L: int, H: int, C: int, R: int, mm_dtype=torch.float32):
    """Resident warps per SM, dynamic shared memory (bytes) and threads of
    each ray-tile kernel at these widths, from the CUDA occupancy API:
    {name: (warps, smem, threads)}."""
    import ctypes

    lib = build.library()
    bf16 = int(mm_dtype == torch.bfloat16) << 2
    out = {}
    for name, call in (
            ("ray_tile", lambda o: lib.cips_ray_tile_forward_occupancy(S, L, H, C, R, bf16, o)),
            ("ray_tile_residuals",
             lambda o: lib.cips_ray_tile_forward_occupancy(S, L, H, C, R, bf16 | 16, o)),
            ("ray_tile_bwd_cot",
             lambda o: lib.cips_ray_tile_backward_occupancy(0, S, L, H, C, R, bf16, o)),
            ("ray_tile_bwd_wgrad",
             lambda o: lib.cips_ray_tile_backward_occupancy(1, S, L, H, C, R, bf16, o))):
        buf = (ctypes.c_int * 3)()
        build.check(lib, call(buf), name)
        out[name] = tuple(buf)
    return out


def ray_tile_bwd(wt, pts, *args, **kwargs):
    """`ray_tile_bwd_plain` for CPU tensors, `ray_tile_bwd_cuda` otherwise."""
    if pts.device.type == "cpu":
        return ray_tile_bwd_plain(wt, pts, *args, **kwargs)
    return ray_tile_bwd_cuda(wt, pts, *args, **kwargs)


VJP_IMPLS = ("pallas", "pallas_residual", "jnp")


class RayTileFunction(torch.autograd.Function):
    """The ray tile under autograd (the Pallas module's `_make_core`).

    Forward: the ray-tile kernel (with residuals under 'pallas_residual').
    Backward per ``vjp_impl``: 'pallas', the backward kernel recomputing
    the MLP states; 'pallas_residual', the backward kernel reading the
    residuals; 'jnp', autograd through `ray_tile_plain` (the reference).
    The kernels give grads to the weights, films and coarse points only:
    origins, dirs, z, u and the noise get none (the resample is detached)."""

    @staticmethod
    def forward(ctx, opts, pts, org, dirs, z, u, nc, nf, *wt):
        noise_std, vjp_impl, kw = opts
        inputs = (pts, org, dirs, z, u, nc, nf)
        if vjp_impl == "pallas_residual":
            fea, depth, res = ray_tile(list(wt), *inputs, noise_std, with_residuals=True, **kw)
        else:
            (fea, depth), res = ray_tile(list(wt), *inputs, noise_std, **kw), ()
        ctx.opts = opts
        ctx.n_res = len(res)
        ctx.save_for_backward(*inputs, *res, *wt)
        return fea, depth

    @staticmethod
    def backward(ctx, d_fea, d_dep):
        noise_std, vjp_impl, kw = ctx.opts
        saved = ctx.saved_tensors
        inputs, res, wt = saved[:7], saved[7:7 + ctx.n_res], list(saved[7 + ctx.n_res:])
        d_fea = d_fea.to(kw["out_dtype"]).float()
        d_dep = d_dep.float()
        if vjp_impl == "jnp":
            need = ctx.needs_input_grad[1:]
            leaves = [t.detach().requires_grad_(r) for t, r in zip(list(inputs) + wt, need)]
            with torch.enable_grad():
                fea, depth = ray_tile_plain(leaves[7:], *leaves[:7], noise_std, **kw)
                wanted = [t for t in leaves if t.requires_grad]
                grads = iter(torch.autograd.grad((fea.float(), depth), wanted, (d_fea, d_dep),
                                                 allow_unused=True))
            return (None,) + tuple(next(grads) if t.requires_grad else None for t in leaves)
        kw = {k: v for k, v in kw.items() if k != "out_dtype"}
        d_wt, d_pts = ray_tile_bwd(wt, *inputs, noise_std, d_fea, d_dep,
                                   residuals=tuple(res) or None, **kw)
        return (None, d_pts) + (None,) * 6 + tuple(d_wt)


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
    vjp_impl: str = "pallas",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused NeRF stage of `GeneratorNerfINR.points_forward` (hierarchical):
    returns (pixels_fea (b, n, R) in ``dtype``, depth (b, n, 1) f32).

    ``draws`` supplies the random draws (see `RayDraws`); without it they are
    drawn from ``generator``.  Differentiable when grad is enabled and the
    SIREN's weights or styles (or the points) require it: the backward runs
    per ``vjp_impl`` (see `RayTileFunction`); the resample is detached as in
    the reference.  Without grad only the forward kernel runs."""
    if vjp_impl not in VJP_IMPLS:
        raise ValueError(f"vjp_impl must be one of {VJP_IMPLS}, got {vjp_impl!r}")
    b, n, S, _ = pts.shape
    if draws is None:
        draws = draw_ray_randoms(b, n, S, noise_std != 0, generator, pts.device)
    mm_dtype = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
    wt = flat_weights(siren, style_dict)
    kw = dict(clamp_mode=clamp_mode, white_back=white_back, last_back=last_back,
              fast_sin=fast_sin, mm_dtype=mm_dtype, warp_scale=2.0 / siren.box_sidelength,
              out_dtype=dtype)
    inputs = (pts.float(), origins.float(), dirs.float(), z_vals[..., 0].float(),
              draws.u.float(), draws.nc.float(), draws.nf.float())
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (*wt, inputs[0]))):
        return ray_tile(wt, *inputs, float(noise_std), **kw)
    return RayTileFunction.apply((float(noise_std), vjp_impl, kw), *inputs, *wt)
