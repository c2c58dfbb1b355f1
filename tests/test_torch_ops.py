"""Parity of the port's ops (`cips3d_tpu_torch/ops`) with the JAX package.

The same inputs, made from a numpy seed, go through the JAX function and
its port: `fast_sin` and `fast_sin_grad`, and the plain versions of the
ray-tile and INR-tile kernels against `fused_ray_render` /
`fused_inr_decode` in Pallas interpret mode (as `tests/test_pallas_*.py`
run them).  Kernel tolerances are the Pallas tests' rtol 2e-4 / atol 2e-5;
gradients are held by the normalised error max|a-b| / (max|b| + 1) < 1e-4
of `tests/test_pallas_ray.py`.  The CUDA kernels are held against
the plain versions in `tests/test_torch_kernels.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cips3d_tpu.models.cips_net import CIPSNet as JaxCIPSNet
from cips3d_tpu.models.nerf_net import NeRFNetwork as JaxNeRFNetwork
from cips3d_tpu.ops import fast_sin as jax_fast_sin
from cips3d_tpu.ops.pallas.inr_tile import fused_inr_decode as jax_fused_inr_decode
from cips3d_tpu.ops.pallas import ray_tile as jax_ray_tile
from cips3d_tpu.ops.pallas.ray_tile import fused_ray_render as jax_fused_ray_render
from cips3d_tpu_torch.models.cips_net import CIPSNet
from cips3d_tpu_torch.models.nerf_net import NeRFNetwork
from cips3d_tpu_torch.ops import build, inr_tile, ray_tile
from cips3d_tpu_torch.ops.fast_sin import fast_sin, fast_sin_grad
from cips3d_tpu_torch.utils.convert import inr_state_dict, siren_state_dict, to_torch

KERNEL_TOL = dict(rtol=2e-4, atol=2e-5)


def t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


# ---------------------------------------------------------------- fast_sin

def test_fast_sin_matches_jax():
    rng = np.random.default_rng(0)
    k = np.arange(-40, 41)
    x = np.concatenate([
        rng.uniform(-150, 150, 4096),
        (k + 0.5) * 2 * np.pi,          # exact halves: round-half-to-even decides the branch
        k * 2 * np.pi, [0.0, 1e-6, -1e-6],
    ]).astype(np.float32)
    ref = np.asarray(jax_fast_sin.fast_sin(jnp.asarray(x)))
    out = fast_sin(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-6)
    assert np.abs(out - np.sin(x.astype(np.float64))).max() < 5e-5


def test_fast_sin_half_rounds_to_even():
    """y = x/2pi = k + 0.5 exactly: torch.round must pick the even k like
    jnp.round (roundf would move odd halves by one period)."""
    y = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 3.5], np.float32)
    x = torch.from_numpy(y) / np.float32(0.15915494309189535)
    xj = jnp.asarray(x.numpy())
    np.testing.assert_array_equal(fast_sin(x).numpy(), np.asarray(jax_fast_sin.fast_sin(xj)))


def test_fast_sin_bf16_internals_f32():
    rng = np.random.default_rng(1)
    x = rng.uniform(-100, 100, 4096).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    out = fast_sin(xb)
    assert out.dtype == torch.bfloat16
    ref = jax_fast_sin.fast_sin(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=0, atol=8e-3)
    # f32 internals: error vs sin of the same bf16 argument stays ~bf16 output rounding
    exact = np.sin(xb.float().numpy().astype(np.float64))
    assert np.abs(out.float().numpy() - exact).max() < 5e-3


def test_fast_sin_grad_matches_jax():
    """The derivative of the polynomial (not cos), as the Pallas backward
    uses it; within 1e-4 of cos at worst (the fit's slope error)."""
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.uniform(-150, 150, 4096),
                        (np.arange(-20, 21) + 0.5) * 2 * np.pi]).astype(np.float32)
    ref = np.asarray(jax_fast_sin.fast_sin_grad(jnp.asarray(x)))
    out = fast_sin_grad(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-6)
    assert np.abs(out - np.cos(x.astype(np.float64))).max() < 1e-3


# ---------------------------------------------------------------- ray tile

B, N, S, H, R = 2, 40, 8, 32, 16


@pytest.fixture(scope="module")
def ray_setup():
    """A tiny SIREN in both packages with the same weights, rays and styles."""
    rng = np.random.default_rng(2)
    siren = JaxNeRFNetwork(hidden_dim=H, hidden_layers=2, rgb_dim=R)
    styles = {k: rng.standard_normal((B, H)).astype(np.float32)
              for k in ("nerf_w0", "nerf_w1", "nerf_rgb")}
    jstyles = {k: jnp.asarray(v) for k, v in styles.items()}
    params = siren.init(jax.random.PRNGKey(0), jnp.zeros((B, 8, 3)), jstyles)
    port = NeRFNetwork(hidden_dim=H, hidden_layers=2, rgb_dim=R, style_dim=H)
    port.load_state_dict(to_torch(siren_state_dict(params["params"])))
    origins = rng.standard_normal((B, N, 3)).astype(np.float32) * 0.05
    d = rng.standard_normal((B, N, 3)).astype(np.float32) + np.array([0, 0, -1], np.float32)
    dirs = d / np.linalg.norm(d, axis=-1, keepdims=True)
    base = np.linspace(0.88, 1.12, S, dtype=np.float32)
    z = np.sort(base + rng.uniform(0, 0.24 / S, (B, N, S)).astype(np.float32), -1)[..., None]
    pts = origins[:, :, None] + dirs[:, :, None] * z
    return dict(params=params["params"], port=port, styles=styles, jstyles=jstyles,
                arrays=(pts, origins, dirs, z))


def _jax_draws(key, b, n, s, noise):
    """The draws `fused_ray_render` makes from ``key`` (ray_tile.py:953-965)."""
    k_pdf, k_nc, k_nf = jax.random.split(key, 3)
    u = jax.random.uniform(k_pdf, (b * n, s), jnp.float32).reshape(b, n, s)
    if noise:
        nc = jax.random.normal(k_nc, (b, n, s, 1), jnp.float32)[..., 0]
        nf = jax.random.normal(k_nf, (b, n, 2 * s, 1), jnp.float32)[..., 0]
    else:
        nc, nf = jnp.zeros((b, n, s)), jnp.zeros((b, n, 2 * s))
    return ray_tile.RayDraws(t(u), t(nc), t(nf))


@pytest.mark.parametrize("kwargs", [
    dict(), dict(clamp_mode="softplus"), dict(noise_std=0.4), dict(white_back=True),
    dict(last_back=True), dict(fast_sin=True),
], ids=["relu", "softplus", "noise", "white_back", "last_back", "fast_sin"])
def test_ray_tile_plain_matches_pallas(ray_setup, kwargs):
    pts, origins, dirs, z = ray_setup["arrays"]
    key = jax.random.PRNGKey(11)
    ref_fea, ref_dep = jax_fused_ray_render(
        ray_setup["params"], ray_setup["jstyles"], jnp.asarray(pts), jnp.asarray(origins),
        jnp.asarray(dirs), jnp.asarray(z), key, tile=32, **kwargs)
    draws = _jax_draws(key, B, N, S, kwargs.get("noise_std", 0.0) != 0)
    styles = {k: t(v) for k, v in ray_setup["styles"].items()}
    fea, dep = ray_tile.fused_ray_render(
        ray_setup["port"], styles, t(pts), t(origins), t(dirs), t(z), draws=draws, **kwargs)
    np.testing.assert_allclose(fea.detach().numpy(), np.asarray(ref_fea), **KERNEL_TOL)
    np.testing.assert_allclose(dep.detach().numpy(), np.asarray(ref_dep), **KERNEL_TOL)


def test_ray_tile_plain_bf16_rounds_like_pallas(ray_setup):
    """bf16 matmul inputs: same rounding points as the Pallas kernel, so the
    two agree far closer than bf16 resolution."""
    pts, origins, dirs, z = ray_setup["arrays"]
    key = jax.random.PRNGKey(12)
    ref_fea, ref_dep = jax_fused_ray_render(
        ray_setup["params"], ray_setup["jstyles"], jnp.asarray(pts), jnp.asarray(origins),
        jnp.asarray(dirs), jnp.asarray(z), key, tile=32, dtype=jnp.bfloat16)
    styles = {k: t(v) for k, v in ray_setup["styles"].items()}
    fea, dep = ray_tile.fused_ray_render(
        ray_setup["port"], styles, t(pts), t(origins), t(dirs), t(z),
        draws=_jax_draws(key, B, N, S, False), dtype=torch.bfloat16)
    assert fea.dtype == torch.bfloat16
    ref = np.asarray(ref_fea.astype(jnp.float32))
    np.testing.assert_allclose(fea.detach().float().numpy(), ref, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(dep.detach().numpy(), np.asarray(ref_dep), rtol=1e-3, atol=1e-3)


def test_ray_tile_dispatch_on_cpu_uses_plain(ray_setup):
    """The wrapper takes the plain version for CPU tensors and never counts
    a kernel launch there."""
    pts, origins, dirs, z = ray_setup["arrays"]
    styles = {k: t(v) for k, v in ray_setup["styles"].items()}
    before = build.launches("ray_tile")
    fea, dep = ray_tile.fused_ray_render(
        ray_setup["port"], styles, t(pts), t(origins), t(dirs), t(z),
        generator=torch.Generator().manual_seed(0))
    assert fea.shape == (B, N, R) and dep.shape == (B, N, 1)
    assert torch.isfinite(fea).all() and build.launches("ray_tile") == before
    with pytest.raises(ValueError, match="CUDA"):
        ray_tile.ray_tile_cuda(ray_tile.flat_weights(ray_setup["port"], styles),
                               t(pts), t(origins), t(dirs), t(z[..., 0]),
                               *ray_tile.draw_ray_randoms(B, N, S, False, None, "cpu"))


def _grad_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1.0)


def _jax_wt(params, jstyles):
    """The flat weight tuple `fused_ray_render` builds (ray_tile.py:967-984)."""
    w = jax_ray_tile.extract_siren_weights(params)
    f = jax_ray_tile.compute_films(params, jstyles)
    wt = []
    for i in range(2):
        wt += [w[f"w{i}"], w[f"b{i}"].reshape(1, -1), f[f"g{i}"], f[f"f{i}"]]
    wt += [w["wc"], w["bc"].reshape(1, -1), f["gc"], f["fc"], w["wr"], w["br"].reshape(1, -1),
           jnp.pad(w["ws"], ((0, 0), (0, 7))), jnp.pad(w["bs"].reshape(1, 1), ((0, 0), (0, 7)))]
    return tuple(wt)


@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
def test_ray_tile_residuals_match_pallas(ray_setup, mm):
    """The residual forward's tensors (rh, ra, rhc, rac) against the Pallas
    kernel's `with_residuals` outputs, brought to the port's ray-major
    layout."""
    pts, origins, dirs, z = ray_setup["arrays"]
    key = jax.random.PRNGKey(16)
    draws = _jax_draws(key, B, N, S, True)
    tile = 32
    _, jres = jax_ray_tile._pallas_forward(
        _jax_wt(ray_setup["params"], ray_setup["jstyles"]), jnp.asarray(pts),
        jnp.asarray(origins), jnp.asarray(dirs), jnp.asarray(z[..., 0]),
        *(jnp.asarray(d.numpy()) for d in draws), jnp.full((1, 1), 0.4, jnp.float32),
        tile=tile, interpret=True, clamp_mode="relu", white_back=False, last_back=False,
        use_noise=True, fast_sin=False, mm_dtype=jnp.dtype(mm), warp_scale=2.0 / 0.24,
        out_dtype=jnp.float32, with_residuals=True)
    styles = {k: t(v) for k, v in ray_setup["styles"].items()}
    wt = ray_tile.flat_weights(ray_setup["port"], styles)
    mm_dtype = getattr(torch, mm)
    _, _, res = ray_tile.ray_tile_plain(
        [w.detach() for w in wt], t(pts), t(origins), t(dirs), t(z[..., 0]), *draws, 0.4,
        mm_dtype=mm_dtype, with_residuals=True)
    n_tiles = -(-N // tile)
    for name, ours, ref in zip(("rh", "ra", "rhc", "rac"), res, jres):
        ref = np.asarray(ref.astype(jnp.float32))
        ref = ref.reshape(B, 2, n_tiles, S, tile, -1).transpose(0, 1, 2, 4, 3, 5)
        ref = ref.reshape(B, 2, n_tiles * tile, S, -1)[:, :, :N]
        assert ours.dtype == (mm_dtype if name in ("rh", "rhc") else torch.float32)
        # pre-activations reach |a| ~ 20: the kernel tolerance scaled to them;
        # bf16 outputs may round across one bf16 step
        tol = dict(rtol=2e-4, atol=4e-4) if mm == "float32" else dict(rtol=1e-2, atol=1e-2)
        np.testing.assert_allclose(ours.float().numpy(), ref, err_msg=name, **tol)


@pytest.mark.parametrize("impl,kwargs", [
    ("pallas", dict()), ("pallas_residual", dict()), ("jnp", dict()),
    ("pallas", dict(noise_std=0.4, clamp_mode="softplus")),
    ("pallas_residual", dict(noise_std=0.4, white_back=True, last_back=True)),
    ("pallas", dict(fast_sin=True)), ("pallas_residual", dict(fast_sin=True)),
], ids=["pallas-relu", "residual-relu", "jnp-relu", "pallas-noise_softplus",
        "residual-noise_white_last_back", "pallas-fast_sin", "residual-fast_sin"])
def test_ray_tile_grads_match_pallas(ray_setup, impl, kwargs):
    """Grads of the SIREN weights and the styles through the port's
    autograd function (each vjp_impl) and through `ray_tile_bwd_plain`,
    against `jax.grad` of the Pallas `fused_ray_render` in the same mode."""
    pts, origins, dirs, z = ray_setup["arrays"]
    key = jax.random.PRNGKey(25)
    draws = _jax_draws(key, B, N, S, kwargs.get("noise_std", 0.0) != 0)

    def loss_jax(params, jstyles):
        fea, dep = jax_fused_ray_render(
            params, jstyles, jnp.asarray(pts), jnp.asarray(origins), jnp.asarray(dirs),
            jnp.asarray(z), key, tile=32, tile_bwd=128, vjp_impl=impl, **kwargs)
        return jnp.sum(fea * fea) + jnp.sum(dep)

    gp, gs = jax.grad(loss_jax, argnums=(0, 1))(ray_setup["params"], ray_setup["jstyles"])
    port = ray_setup["port"]
    styles = {k: t(v).requires_grad_() for k, v in ray_setup["styles"].items()}
    fea, dep = ray_tile.fused_ray_render(port, styles, t(pts), t(origins), t(dirs), t(z),
                                         draws=draws, vjp_impl=impl, **kwargs)
    names = [n for n, _ in port.named_parameters()]
    got = torch.autograd.grad((fea * fea).sum() + dep.sum(),
                              list(port.parameters()) + list(styles.values()))
    jsd = siren_state_dict(jax.tree_util.tree_map(np.asarray, gp))
    for name, g in zip(names, got):
        assert _grad_err(g.numpy(), jsd[name]) < 1e-4, name
    for k, g in zip(styles, got[len(names):]):
        assert _grad_err(g.numpy(), gs[k]) < 1e-4, k
    # the plain backward on its own, against autograd through the plain forward
    wt = [w.detach() for w in ray_tile.flat_weights(port, styles)]
    kw = dict(kwargs)
    ns = kw.pop("noise_std", 0.0)
    args = (t(pts), t(origins), t(dirs), t(z[..., 0]), *draws, ns)
    leaves = [w.clone().requires_grad_() for w in wt]
    f2, d2 = ray_tile.ray_tile_plain(leaves, *args, **kw)
    ref = torch.autograd.grad((f2 * f2).sum() + d2.sum(), leaves)
    res = ray_tile.ray_tile_plain(wt, *args, with_residuals=True, **kw)[2] \
        if impl == "pallas_residual" else None
    mine, _ = ray_tile.ray_tile_bwd_plain(wt, *args, 2 * f2.detach(), torch.ones_like(d2),
                                          residuals=res, **kw)
    for a, b in zip(mine, ref):
        assert _grad_err(a.numpy(), b.numpy()) < 1e-4


def test_ray_tile_d_pts_matches_pallas(ray_setup):
    """d pts of the coarse points (the kernel's only point cotangent)."""
    pts, origins, dirs, z = ray_setup["arrays"]
    key = jax.random.PRNGKey(26)
    draws = _jax_draws(key, B, N, S, False)

    def loss_jax(p):
        fea, _ = jax_fused_ray_render(ray_setup["params"], ray_setup["jstyles"], p,
                                      jnp.asarray(origins), jnp.asarray(dirs), jnp.asarray(z),
                                      key, tile=32, tile_bwd=128, vjp_impl="pallas")
        return jnp.sum(fea * fea)

    ref = jax.grad(loss_jax)(jnp.asarray(pts))
    styles = {k: t(v) for k, v in ray_setup["styles"].items()}
    p = t(pts).requires_grad_()
    fea, _ = ray_tile.fused_ray_render(ray_setup["port"], styles, p, t(origins), t(dirs), t(z),
                                       draws=draws, vjp_impl="pallas")
    (got,) = torch.autograd.grad((fea * fea).sum(), p)
    assert _grad_err(got.numpy(), ref) < 1e-4


# ---------------------------------------------------------------- INR tile

IB, IN, IN0, D, STYLE = 2, 48, 16, 32, 24


@pytest.fixture(scope="module")
def inr_setup():
    rng = np.random.default_rng(3)
    net = JaxCIPSNet(hidden_dim=D, pre_rgb_dim=3)
    styles = {k: rng.standard_normal((IB, STYLE)).astype(np.float32)
              for k in sorted(net.style_dims)}
    x = rng.standard_normal((IB, IN, IN0)).astype(np.float32)
    params = net.init(jax.random.PRNGKey(0), jnp.asarray(x),
                      {k: jnp.asarray(v) for k, v in styles.items()})
    port = CIPSNet(input_dim=IN0, hidden_dim=D, style_dim=STYLE)
    port.load_state_dict(to_torch(inr_state_dict(params["params"])))
    return dict(params=params["params"], port=port, styles=styles, x=x)


@pytest.mark.parametrize("img_size", [1024, 64])
def test_inr_tile_plain_matches_pallas(inr_setup, img_size):
    """All nine blocks (the render path) and an early exit (five blocks)."""
    jstyles = {k: jnp.asarray(v) for k, v in inr_setup["styles"].items()}
    ref = jax_fused_inr_decode(inr_setup["params"], jstyles, jnp.asarray(inr_setup["x"]),
                               img_size=img_size, tile=32)
    styles = {k: t(v) for k, v in inr_setup["styles"].items()}
    out = inr_tile.fused_inr_decode(inr_setup["port"], styles, t(inr_setup["x"]),
                                    img_size=img_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **KERNEL_TOL)
    # and the module's own forward (CIPSNet's math) agrees with the fused decode
    np.testing.assert_allclose(
        inr_setup["port"](t(inr_setup["x"]), styles, img_size=img_size).detach().numpy(),
        out.numpy(), **KERNEL_TOL)


def test_inr_tile_plain_bf16_matches_pallas(inr_setup):
    jstyles = {k: jnp.asarray(v) for k, v in inr_setup["styles"].items()}
    ref = jax_fused_inr_decode(inr_setup["params"], jstyles, jnp.asarray(inr_setup["x"]),
                               tile=32, dtype=jnp.bfloat16)
    styles = {k: t(v) for k, v in inr_setup["styles"].items()}
    out = inr_tile.fused_inr_decode(inr_setup["port"], styles, t(inr_setup["x"]),
                                    dtype=torch.bfloat16)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=2e-2, atol=1e-2)


def test_inr_tile_rejects_small_img_size(inr_setup):
    styles = {k: t(v) for k, v in inr_setup["styles"].items()}
    with pytest.raises(ValueError, match="use CIPSNet"):
        inr_tile.fused_inr_decode(inr_setup["port"], styles, t(inr_setup["x"]), img_size=8)
