"""The ray tile's and the INR tile's plain versions at the shapes past the
resident kernels' limits, and the port's generator at NeRF depth 3, against
JAX.

The Pallas `fused_ray_render` takes any sample count S, SIREN depth and
width; the port's kernels take them too, on the resident or the streamed
path (`tests/test_torch_kernels.py` holds both against the plain version on
the card).  Here the plain version, forward and VJP (weights, FiLM gains and
shifts, coarse points), against the Pallas module's `_jnp_core`, the
reference its kernel and its custom VJP are held to
(`tests/test_pallas_ray.py`), on the same weights and draws: at S = 48, and
at depth 1, depth 3, width 144 and S = 80; rtol 2e-4 / atol 2e-5 for the
outputs, the normalised error max|a-b| / (max|b| + 1) < 1e-4 for the
gradients.  The INR tile's plain version at D = 576 against the Pallas
`fused_inr_decode` in interpret mode (as `tests/test_pallas_inr.py` runs
it), and the serving render of a depth-3 generator (ray tile and INR tile
fused) against JAX's on JAX's draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cips3d_tpu.models.cips_net import CIPSNet as JaxCIPSNet
from cips3d_tpu.models.nerf_net import NeRFNetwork as JaxNeRFNetwork
from cips3d_tpu.ops.pallas import ray_tile as jax_ray_tile
from cips3d_tpu.ops.pallas.inr_tile import fused_inr_decode as jax_fused_inr_decode
from cips3d_tpu_torch.models.cips_net import CIPSNet
from cips3d_tpu_torch.models.nerf_net import NeRFNetwork
from cips3d_tpu_torch.ops import inr_tile, ray_tile
from cips3d_tpu_torch.utils.convert import inr_state_dict, siren_state_dict, to_torch

B, N, S, H, R = 2, 16, 48, 32, 16
KERNEL_TOL = dict(rtol=2e-4, atol=2e-5)


def _grad_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1.0)


def _rays(L=2, H=H, S=S, seed=7):
    """A tiny SIREN of depth L and width H in both packages with the same
    weights; S samples a ray."""
    rng = np.random.default_rng(seed)
    siren = JaxNeRFNetwork(hidden_dim=H, hidden_layers=L, rgb_dim=R)
    styles = {k: rng.standard_normal((B, H)).astype(np.float32)
              for k in [f"nerf_w{i}" for i in range(L)] + ["nerf_rgb"]}
    jstyles = {k: jnp.asarray(v) for k, v in styles.items()}
    params = siren.init(jax.random.PRNGKey(3), jnp.zeros((B, 8, 3)), jstyles)["params"]
    port = NeRFNetwork(hidden_dim=H, hidden_layers=L, rgb_dim=R, style_dim=H)
    port.load_state_dict(to_torch(siren_state_dict(params)))
    origins = rng.standard_normal((B, N, 3)).astype(np.float32) * 0.05
    d = rng.standard_normal((B, N, 3)).astype(np.float32) + np.array([0, 0, -1], np.float32)
    dirs = d / np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.sort(np.linspace(0.88, 1.12, S, dtype=np.float32)
                + rng.uniform(0, 0.24 / S, (B, N, S)).astype(np.float32), -1)
    pts = origins[:, :, None] + dirs[:, :, None] * z[..., None]
    draws = (rng.uniform(0, 1, (B, N, S)).astype(np.float32),
             rng.standard_normal((B, N, S)).astype(np.float32),
             rng.standard_normal((B, N, 2 * S)).astype(np.float32))
    # the flat weights `fused_ray_render` builds (ray_tile.py:967-984)
    w = jax_ray_tile.extract_siren_weights(params)
    f = jax_ray_tile.compute_films(params, jstyles)
    jwt = []
    for i in range(L):
        jwt += [w[f"w{i}"], w[f"b{i}"].reshape(1, -1), f[f"g{i}"], f[f"f{i}"]]
    jwt += [w["wc"], w["bc"].reshape(1, -1), f["gc"], f["fc"], w["wr"], w["br"].reshape(1, -1),
            jnp.pad(w["ws"], ((0, 0), (0, 7))), jnp.pad(w["bs"].reshape(1, 1), ((0, 0), (0, 7)))]
    wt = [t.detach() for t in ray_tile.flat_weights(port, {k: torch.from_numpy(v)
                                                           for k, v in styles.items()})]
    return dict(jwt=tuple(jwt), wt=wt, arrays=(pts, origins, dirs, z) + draws)


@pytest.fixture(scope="module")
def long_rays():
    """48 samples a ray at depth 2, width 32."""
    return _rays()


OPTIONS = [
    dict(noise_std=0.0),
    dict(noise_std=0.4, clamp_mode="softplus", white_back=True, last_back=True, fast_sin=True),
]
OPTION_IDS = ["relu", "noise_softplus_white_last_back_fast_sin"]


@pytest.mark.parametrize("kwargs", OPTIONS, ids=OPTION_IDS)
def test_plain_matches_jax_past_32_steps(long_rays, kwargs):
    _check_against_jax(long_rays, kwargs)


# the SIREN depths and widths past the resident kernels' (depth 3 at width 128 in f32 passes
# their shared memory; the port's wrappers take it on the streamed path), at small sizes
SIRENS = {"L1": dict(L=1), "L3": dict(L=3), "H144": dict(H=144), "S80": dict(S=80),
          "H144_S80": dict(H=144, S=80)}
# where density noise makes an f32 resample take another sample in either package (seen at
# H 144, S 80: one ray of 32), the f32 runs are held through float64 runs of both
CONDITIONED = {"H144_S80"}


@pytest.mark.parametrize("kwargs", OPTIONS, ids=OPTION_IDS)
@pytest.mark.parametrize("siren", list(SIRENS))
def test_plain_matches_jax_at_siren_depth_and_width(siren, kwargs):
    _check_against_jax(_rays(**SIRENS[siren]), kwargs, witness=siren in CONDITIONED)


def _both(long_rays, ns, opts, f64=False):
    """Forward and VJP of the port's plain version and of JAX's `_jnp_core`
    on the same weights, draws and cotangents, in f32 or (both) float64:
    {"port" | "jax": [fea, depth, d w_0, d b_0, .., d pts]} as numpy."""
    arrays = long_rays["arrays"]
    jdt, tdt = (jnp.float64, torch.float64) if f64 else (jnp.float32, torch.float32)
    rng = np.random.default_rng(8)
    d_fea = rng.standard_normal((B, N, R))
    d_dep = rng.standard_normal((B, N, 1))
    with jax.enable_x64(f64):
        jargs = [jnp.asarray(a, jdt) for a in arrays]
        jwt = tuple(jnp.asarray(np.asarray(w), jdt) for w in long_rays["jwt"])

        def core(wt, pts):
            return jax_ray_tile._jnp_core(
                wt, pts, *jargs[1:], jnp.full((1, 1), ns, jdt), use_noise=ns != 0,
                mm_dtype=jdt, warp_scale=2.0 / 0.24, out_dtype=jdt, **opts)

        @jax.jit
        def forward_and_vjp(wt, pts, cot):
            out, vjp = jax.vjp(core, wt, pts)
            return out, vjp(cot)

        (ref_fea, ref_dep), (ref_wt, ref_pts) = forward_and_vjp(
            jwt, jargs[0], (jnp.asarray(d_fea, jdt), jnp.asarray(d_dep, jdt)))
        ref = [np.asarray(ref_fea), np.asarray(ref_dep), *map(np.asarray, ref_wt),
               np.asarray(ref_pts)]
    wt = [w.to(tdt) for w in long_rays["wt"]]
    args = [torch.from_numpy(a).to(tdt) for a in arrays] + [ns]
    fea, dep = ray_tile.ray_tile_plain(wt, *args, mm_dtype=tdt, **opts)
    grads, d_pts = ray_tile.ray_tile_bwd_plain(wt, *args, torch.from_numpy(d_fea).to(tdt),
                                               torch.from_numpy(d_dep).to(tdt), mm_dtype=tdt,
                                               **opts)
    got = [t.numpy() for t in [fea, dep, *grads, d_pts]]
    for i, (g, r) in enumerate(zip(got, ref)):
        if r.shape != g.shape:   # JAX's (1, dim) biases; its lane-padded sigma head
            r = r[:, :1] if r.shape[-1] == 8 and g.shape[-1] == 1 else r
            ref[i] = r.reshape(g.shape)
    return dict(port=got, jax=ref)


def _outside(a, b):
    """Rays (the last axis) with any element outside the kernel tolerance."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (np.abs(a - b) > KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * np.abs(b)).any(-1)


def _check_against_jax(long_rays, kwargs, witness=False):
    kw = dict(kwargs)
    ns = kw.pop("noise_std")
    opts = dict(clamp_mode="relu", white_back=False, last_back=False, fast_sin=False)
    opts.update(kw)
    assert len(long_rays["jwt"]) == len(long_rays["wt"])
    r32 = _both(long_rays, ns, opts)
    got, ref = r32["port"], r32["jax"]
    if witness and ns:
        # Past 24 samples under density noise the f32 resample is ill-conditioned (PERF.md
        # section 7): in either f32 version a ray may take another fine sample.  So the two
        # float64 runs are held to the tolerances, and the f32 runs part by at most what
        # each parts from its own float64 run: rays outside (or 0.1 %), and each gradient
        # by the sum of the two distances (plus the tolerance)
        r64 = _both(long_rays, ns, opts, f64=True)
        a64, b64 = r64["port"], r64["jax"]
        for a, b in zip(a64[:2], b64[:2]):
            np.testing.assert_allclose(a, b, **KERNEL_TOL)
        for i, (a, b) in enumerate(zip(a64[2:], b64[2:])):
            assert _grad_err(a, b) < 1e-4, f"float64 grad {i}"
        share = (_outside(got[0], ref[0]) | _outside(got[1], ref[1])).mean()
        own = (_outside(got[0], a64[0]) | _outside(got[1], a64[1])
               | _outside(ref[0], b64[0]) | _outside(ref[1], b64[1])).mean()
        assert share <= max(1e-3, own), (share, own)
        for i, (a, b, a_, b_) in enumerate(zip(got[2:], ref[2:], a64[2:], b64[2:])):
            assert _grad_err(a, b) < 1e-4 + _grad_err(a, a_) + _grad_err(b, b_), f"grad {i}"
        return
    np.testing.assert_allclose(got[0], ref[0], **KERNEL_TOL)
    np.testing.assert_allclose(got[1], ref[1], **KERNEL_TOL)
    for i, (g, r) in enumerate(zip(got[2:], ref[2:])):
        assert _grad_err(g, r) < 1e-4, f"grad {i}"


def test_inr_plain_matches_jax_past_512():
    """The INR tile's plain version at D = 576 (the streamed path's width)
    against the Pallas `fused_inr_decode` in interpret mode, all nine
    blocks."""
    rng = np.random.default_rng(3)
    b, n, in0, D, style = 1, 40, 16, 576, 24
    net = JaxCIPSNet(hidden_dim=D, pre_rgb_dim=3)
    styles = {k: rng.standard_normal((b, style)).astype(np.float32) for k in sorted(net.style_dims)}
    x = rng.standard_normal((b, n, in0)).astype(np.float32)
    jstyles = {k: jnp.asarray(v) for k, v in styles.items()}
    params = net.init(jax.random.PRNGKey(0), jnp.asarray(x), jstyles)["params"]
    port = CIPSNet(input_dim=in0, hidden_dim=D, style_dim=style)
    port.load_state_dict(to_torch(inr_state_dict(params)))
    ref = jax_fused_inr_decode(params, jstyles, jnp.asarray(x), img_size=1024, tile=32)
    out = inr_tile.fused_inr_decode(port, {k: torch.from_numpy(v) for k, v in styles.items()},
                                    torch.from_numpy(x), img_size=1024)
    assert inr_tile.inr_path(D) == "streamed"
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **KERNEL_TOL)


def test_deep_siren_generator_render_matches_jax():
    """The port's generator with nerf_hidden_layers 3, the ray tile and the
    INR tile fused (fast_sin, as served), against JAX's on the same weights
    and JAX's draws: `render_chunked` at r32, S 6 in two chunks (each
    chunk's `points_forward`), image and depth."""
    from cips3d_tpu.apps.render import render_chunked_traced
    from cips3d_tpu.models.generator import GeneratorConfig as JaxConfig
    from cips3d_tpu.models.generator import GeneratorNerfINR as JaxGenerator
    from cips3d_tpu.models.generator import RenderOptions as JaxOptions
    from cips3d_tpu.models.generator import sample_zs as jax_sample_zs
    from cips3d_tpu_torch.apps.render import render_chunked
    from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR, RenderOptions
    from cips3d_tpu_torch.utils.convert import load_jax_params

    tiny = dict(z_dim_nerf=16, z_dim_inr=32, nerf_hidden_dim=32, nerf_hidden_layers=3,
                nerf_style_dim=32, nerf_rgb_dim=16, nerf_mapping_layers=2, inr_hidden_dim=32,
                inr_style_dim=32, inr_mapping_layers=2, fused_ray=True, fused_inr=True,
                fast_sin=True)
    cfg = JaxConfig(**tiny)
    jgen = JaxGenerator(cfg=cfg)
    zs = jax_sample_zs(jax.random.PRNGKey(0), 1, cfg)
    params = jgen.init(jax.random.PRNGKey(1), zs, jax.random.PRNGKey(2),
                       JaxOptions(img_size=8, num_steps=4))
    params = jax.tree_util.tree_map(np.asarray, params)
    port = GeneratorNerfINR(GeneratorConfig(**tiny))
    load_jax_params(port, params)
    assert len(port.siren.network) == 3

    size, steps, chunk, b = 32, 6, 512, 1
    opts = dict(img_size=size, num_steps=steps, h_stddev=0.0, v_stddev=0.0)
    pos = np.array([[0.25, 0.15, 0.956]], np.float32)
    pos /= np.linalg.norm(pos)
    jst = jgen.apply(params, zs["z_nerf"], zs["z_inr"], method=jgen.mapping)
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    with torch.no_grad():
        st = port.mapping(t(zs["z_nerf"]), t(zs["z_inr"]))
    key = jax.random.PRNGKey(7)
    ref_img, ref_dep = render_chunked_traced(
        params, jgen, jst, JaxOptions(**opts), key, chunk, jnp.asarray(pos), jnp.asarray(-pos),
        None, True)
    # the draws as JAX makes them (render.py:95,134; ray_tile.py:953-965)
    k_rays, k_pts = jax.random.split(key)
    k_perturb, _ = jax.random.split(k_rays)
    uniform = jax.random.uniform(k_perturb, (b, size * size, steps, 1), jnp.float32)
    draws = []
    for k in jax.random.split(k_pts, size * size // chunk):
        k_pdf, _, _ = jax.random.split(k, 3)
        u = jax.random.uniform(k_pdf, (b * chunk, steps), jnp.float32).reshape(b, chunk, steps)
        draws.append(ray_tile.RayDraws(t(u), torch.zeros(b, chunk, steps),
                                       torch.zeros(b, chunk, 2 * steps)))
    img, dep = render_chunked(port, st, RenderOptions(**opts), None, chunk, t(pos), t(-pos),
                              None, return_depth=True, perturb_uniform=t(uniform),
                              chunk_draws=draws)
    assert img.shape == (b, 3, size, size)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref_img), **KERNEL_TOL)
    np.testing.assert_allclose(dep.numpy(), np.asarray(ref_dep), **KERNEL_TOL)
