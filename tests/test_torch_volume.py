"""The port's unfused NeRF stage (`cips3d_tpu_torch/core/volume.py`, the
generator's unfused branch), DiffAug and the shipped-config step pieces,
against the JAX package at tiny widths.

Every JAX function draws from keys; the port takes the same draws as
tensors, rebuilt here from the same key splits (`core/volume.py:84,170`,
`models/generator.py:279,425,436`, `core/rays.py:127,247`,
`ops/diffaug.py`).  Tolerances: forward f32 rtol 1e-4 / atol 1e-5; grads
by max|a-b| / (max|b| + 1) <= 3e-4 (`tests/test_pallas_ray.py:252`);
DiffAug abs 1e-6; the unfused branch against the port's fused plain path
at the kernel-stage tolerance rtol 2e-4 / atol 2e-5
(`tests/test_pallas_ray.py:79`).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cips3d_tpu.core import volume as jv
from cips3d_tpu.models.generator import GeneratorConfig as JaxConfig
from cips3d_tpu.models.generator import GeneratorNerfINR as JaxG
from cips3d_tpu.models.generator import RenderOptions as JaxOptions
from cips3d_tpu.models.generator import sample_zs as jax_sample_zs
from cips3d_tpu.ops import diffaug as jda
from cips3d_tpu_torch.core import volume as pv
from cips3d_tpu_torch.models.generator import (ForwardDraws, GeneratorConfig, GeneratorNerfINR,
                                               RenderOptions)
from cips3d_tpu_torch.ops import diffaug as pda
from cips3d_tpu_torch.ops.ray_tile import RayDraws
from cips3d_tpu_torch.utils.convert import load_jax_params, state_dict_from_jax

FWD = dict(rtol=1e-4, atol=1e-5)
GCFG = dict(z_dim_nerf=16, z_dim_inr=32, nerf_hidden_dim=16, nerf_style_dim=16,
            nerf_mapping_layers=2, inr_hidden_dim=32, inr_style_dim=32, inr_mapping_layers=2)


def t(x, dtype=np.float32):
    return torch.from_numpy(np.array(x, dtype=dtype))


def grad_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1.0)


def _inputs(seed, b=2, n=5, s=6, c=4, ties=False):
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(0.88, 1.12, (b, n, s, 1)), axis=2).astype(np.float32)
    if ties:   # a coarse grid of depths makes equal depths common
        z = np.round(z * 20) / 20
    rgb = rng.standard_normal((b, n, s, c)).astype(np.float32)
    sigma = (rng.standard_normal((b, n, s, 1)) * 3).astype(np.float32)
    return rgb, sigma, z


def _noise(key, shape, use):
    return np.asarray(jax.random.normal(key, shape, jnp.float32)) if use else None


# ---------------------------------------------------------------- volume functions

@pytest.mark.parametrize("fn", ["volume_render_split", "volume_render", "volume_render_unsorted"])
@pytest.mark.parametrize("clamp,last_back,white_back,noise", [
    ("relu", False, False, 0.0), ("softplus", True, False, 0.5), ("relu", False, True, 0.5),
    ("softplus", True, True, 0.0)], ids=["relu", "softplus-last-noise", "white-noise",
                                         "softplus-last-white"])
def test_compositing_matches_jax(fn, clamp, last_back, white_back, noise):
    rgb, sigma, z = _inputs(0, ties=fn == "volume_render_unsorted")
    if fn == "volume_render_unsorted":   # arbitrary arrival order
        perm = np.random.default_rng(1).permutation(z.shape[2])
        rgb, sigma, z = rgb[:, :, perm], sigma[:, :, perm], z[:, :, perm]
    key = jax.random.PRNGKey(3)
    nz = _noise(key, sigma.shape, noise != 0)
    kw = dict(noise_std=noise, last_back=last_back, white_back=white_back, clamp_mode=clamp)
    jf, pf = getattr(jv, fn), getattr(pv, fn)

    def jax_call(r, s):
        if fn == "volume_render":
            return jf(jnp.concatenate([r, s], -1), z, key if noise else None, dim_rgb=4, **kw)
        return jf(r, s, z, key if noise else None, **kw)

    def port_call(r, s):
        n_t = None if nz is None else t(nz)
        if fn == "volume_render":
            return pf(torch.cat([r, s], -1), t(z), n_t, dim_rgb=4, **kw)
        return pf(r, s, t(z), n_t, **kw)

    ref = jax_call(jnp.asarray(rgb), jnp.asarray(sigma))
    r_t, s_t = t(rgb).requires_grad_(), t(sigma).requires_grad_()
    got = port_call(r_t, s_t)
    for a, b_ in zip(got, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b_), **FWD)
    w_rgb = np.random.default_rng(2).standard_normal(ref[0].shape).astype(np.float32)
    w_dep = np.random.default_rng(3).standard_normal(ref[1].shape).astype(np.float32)
    def jax_loss(r, s):
        rgb_out, dep_out, _ = jax_call(r, s)
        return (rgb_out * w_rgb).sum() + (dep_out * w_dep).sum()

    jg = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(rgb), jnp.asarray(sigma))
    ((got[0] * t(w_rgb)).sum() + (got[1] * t(w_dep)).sum()).backward()
    assert grad_err(r_t.grad.numpy(), jg[0]) < 3e-4
    assert grad_err(s_t.grad.numpy(), jg[1]) < 3e-4


@pytest.mark.parametrize("noise", [0.0, 0.5])
def test_render_weights_matches_jax(noise):
    _, sigma, z = _inputs(4)
    key = jax.random.PRNGKey(5)
    ref = jv.render_weights(jnp.asarray(sigma), jnp.asarray(z), key if noise else None, noise)
    nz = _noise(key, sigma.shape, noise != 0)
    got = pv.render_weights(t(sigma), t(z), None if nz is None else t(nz), noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD)


@pytest.mark.parametrize("det", [False, True])
def test_sample_pdf_matches_jax(det):
    rng = np.random.default_rng(6)
    R, B, I = 40, 9, 7
    bins = np.sort(rng.uniform(0.9, 1.1, (R, B)), axis=1).astype(np.float32)
    weights = rng.uniform(0, 1, (R, B - 1)).astype(np.float32)
    weights[:5] = 0.0                     # flat rows: every bin narrower than eps
    weights[5:10, 2:] = 0.0               # CDF plateaus: denominators below eps
    key = jax.random.PRNGKey(7)
    ref = jv.sample_pdf(None if det else key, jnp.asarray(bins), jnp.asarray(weights), I, det=det)
    u = None if det else t(jax.random.uniform(key, (R, I), jnp.float32))
    got = pv.sample_pdf(u, t(bins), t(weights), I, det=det).numpy()
    ref = np.asarray(ref)
    if det:
        # u = 1 exactly meets cdf[-1] = 1 +- one ulp, whose rounding depends on the order
        # of the CDF's sum (a matmul there, a cumsum here); on a plateau the sample then
        # lands at either end of the last bin.  Those samples stay inside that bin.
        last = np.abs(got[:, -1] - ref[:, -1]) > FWD["atol"] + FWD["rtol"] * np.abs(ref[:, -1])
        assert last.sum() <= 2
        assert np.all((got[last, -1] >= bins[last, -2]) & (got[last, -1] <= bins[last, -1]))
        got[last, -1] = ref[last, -1]
    np.testing.assert_allclose(got, ref, **FWD)


@pytest.mark.parametrize("noise", [0.0, 0.5])
def test_get_fine_points_matches_jax(noise):
    rgb, sigma, z = _inputs(8)
    b, n, s, _ = sigma.shape
    rng = np.random.default_rng(9)
    org = rng.standard_normal((b, n, 3)).astype(np.float32)
    dirs = rng.standard_normal((b, n, 3)).astype(np.float32)
    k, kn = jax.random.split(jax.random.PRNGKey(10))
    packed = jnp.concatenate([jnp.asarray(rgb), jnp.asarray(sigma)], -1)
    ref = jv.get_fine_points(k, packed, jnp.asarray(z), 4, "relu", noise, s, jnp.asarray(org),
                             jnp.asarray(dirs), noise_key=kn)
    u = t(jax.random.uniform(k, (b * n, s), jnp.float32))
    nz = _noise(kn, sigma.shape, noise != 0)
    sig_t = t(sigma).requires_grad_()
    got = pv.get_fine_points(u, torch.cat([t(rgb), sig_t], -1), t(z), 4, "relu", noise, s,
                             t(org), t(dirs), None if nz is None else t(nz))
    for a, b_ in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), **FWD)
        assert not a.requires_grad   # the resample is detached


def test_merge_sorted_samples_matches_jax():
    rgb, sigma, z = _inputs(11, ties=True)
    rgb2, _, z2 = _inputs(12, ties=True)
    ref = jv.merge_sorted_samples(jnp.asarray(rgb), jnp.asarray(z), jnp.asarray(rgb2),
                                  jnp.asarray(z2))
    got = pv.merge_sorted_samples(t(rgb), t(z), t(rgb2), t(z2))
    for a, b_ in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_))


def test_unsorted_ordering_runs_in_f32_under_bf16():
    """bf16 depths with many samples: the rank arithmetic stays exact."""
    rng = np.random.default_rng(13)
    m = 300
    z = np.sort(rng.uniform(0.88, 1.12, (1, 2, m, 1)), axis=2).astype(np.float32)
    zb = torch.from_numpy(z).to(torch.bfloat16)
    before, rank = pv._order(zb)
    assert before.dtype == torch.float32
    assert sorted(rank[0, 0].tolist()) == list(map(float, range(m)))


# ---------------------------------------------------------------- the unfused generator

IMG, STEPS, B = 8, 4, 2


def _ray_draws(key, b, n, hierarchical):
    k_pdf, k_nc, k_nf = jax.random.split(key, 3)
    u = jax.random.uniform(k_pdf, (b * n, STEPS), jnp.float32).reshape(b, n, STEPS)
    nc = jax.random.normal(k_nc, (b, n, STEPS, 1), jnp.float32)[..., 0]
    m = 2 * STEPS if hierarchical else STEPS
    nf = jax.random.normal(k_nf, (b, n, m, 1), jnp.float32)[..., 0]
    return RayDraws(t(u), t(nc), t(nf))


def forward_draws(key, b, grad_points, hierarchical=True):
    """The draws `GeneratorNerfINR.__call__` makes from ``key``."""
    k_rays, k_pts = jax.random.split(key)
    k_perturb, k_cam = jax.random.split(k_rays)
    perturb = jax.random.uniform(k_perturb, (b, IMG * IMG, STEPS, 1), jnp.float32)
    k_theta, k_phi, _ = jax.random.split(k_cam, 3)
    camera = (t(jax.random.normal(k_theta, (b, 1))), t(jax.random.normal(k_phi, (b, 1))))
    n = IMG * IMG
    if grad_points is None or grad_points >= n:
        return ForwardDraws(t(perturb), camera, _ray_draws(k_pts, b, n, hierarchical))
    k_perm, k1, k2 = jax.random.split(k_pts, 3)
    perm = torch.from_numpy(np.asarray(jax.random.permutation(k_perm, n)).astype(np.int64))
    return ForwardDraws(t(perturb), camera, _ray_draws(k1, b, grad_points, hierarchical), perm,
                        _ray_draws(k2, b, n - grad_points, hierarchical))


@functools.lru_cache(maxsize=None)
def _jax_params(depth):
    """One JAX initialization per depth (fast_sin and freeze_nerf do not
    change the parameters)."""
    jcfg = JaxConfig(**GCFG, nerf_hidden_layers=depth)
    jgen = JaxG(cfg=jcfg)
    zs = jax_sample_zs(jax.random.PRNGKey(0), B, jcfg)
    init = jax.jit(lambda k1, k2: jgen.init(k1, zs, k2, JaxOptions(img_size=IMG,
                                                                   num_steps=STEPS)))
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(1), jax.random.PRNGKey(2)))


GEN_CASES = {
    "depth2": dict(),
    "depth0": dict(cfg=dict(nerf_hidden_layers=0)),
    "flat": dict(opts=dict(hierarchical_sample=False)),
    "flat-noise": dict(opts=dict(hierarchical_sample=False, nerf_noise=0.5)),
    "noise": dict(opts=dict(nerf_noise=0.5)),
    "white": dict(opts=dict(white_back=True, nerf_noise=0.5)),
    "last-softplus": dict(opts=dict(last_back=True, clamp_mode="softplus")),
    "fast_sin": dict(cfg=dict(fast_sin=True), opts=dict(nerf_noise=0.5)),
    "freeze": dict(cfg=dict(freeze_nerf=True), opts=dict(nerf_noise=0.5)),
    "grad_points": dict(grad_points=16, opts=dict(nerf_noise=0.5)),
}


@pytest.mark.parametrize("case", list(GEN_CASES))
def test_unfused_generator_matches_jax(case):
    spec = GEN_CASES[case]
    gcfg = dict(GCFG, **spec.get("cfg", {}))
    ocfg = dict(img_size=IMG, num_steps=STEPS, **spec.get("opts", {}))
    gp = spec.get("grad_points")
    jcfg = JaxConfig(**gcfg)
    jgen = JaxG(cfg=jcfg)
    zs = jax_sample_zs(jax.random.PRNGKey(0), B, jcfg)
    params = _jax_params(gcfg.get("nerf_hidden_layers", 2))
    key = jax.random.PRNGKey(3)
    w = np.random.default_rng(4).standard_normal((2 * B, 3, IMG, IMG)).astype(np.float32)

    def jloss(p):
        imgs, _ = jgen.apply(p, zs, key, JaxOptions(**ocfg), return_aux_img=True, grad_points=gp)
        return (imgs * w).sum(), imgs

    vg = jax.value_and_grad(jloss, has_aux=True)
    # eager op-by-op is quicker here than one compile, except for the permutation's graph
    (_, jimgs), jgrads = (jax.jit(vg) if gp else vg)(params)

    port = GeneratorNerfINR(GeneratorConfig(**gcfg))
    load_jax_params(port, params)
    draws = forward_draws(key, B, gp, ocfg.get("hierarchical_sample", True))
    imgs, _ = port({k: t(v) for k, v in zs.items()}, RenderOptions(**ocfg), return_aux_img=True,
                   grad_points=gp, draws=draws)
    np.testing.assert_allclose(imgs.detach().numpy(), np.asarray(jimgs), **FWD)
    (imgs * t(w)).sum().backward()
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in port.named_parameters():
        if ".norm." in name:   # the reference's unused LayerNorm: no JAX parameter
            continue
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        assert grad_err(g, ref[name]) < 3e-4, name
    if gcfg.get("freeze_nerf"):
        assert all(p.grad is None or not p.grad.any() for p in port.siren.parameters())


@pytest.mark.parametrize("noise,fast_sin", [(0.0, False), (0.5, False), (0.5, True)])
def test_unfused_branch_matches_the_fused_plain_path(noise, fast_sin):
    """The unfused NeRF stage and the ray tile's plain version on the same
    draws give the same features and depth (kernel-stage tolerance)."""
    cfg = GeneratorConfig(**GCFG, fast_sin=fast_sin)
    gen = GeneratorNerfINR(cfg, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    opts = RenderOptions(img_size=IMG, num_steps=STEPS, nerf_noise=noise)
    zs = {"z_nerf": torch.randn(B, 16, generator=g), "z_inr": torch.randn(B, 32, generator=g)}
    with torch.no_grad():
        st = gen.mapping(zs["z_nerf"], zs["z_inr"])
        world = gen.sample_world(B, opts, g)
        draws = RayDraws(torch.rand(B, IMG * IMG, STEPS, generator=g),
                         torch.randn(B, IMG * IMG, STEPS, generator=g),
                         torch.randn(B, IMG * IMG, 2 * STEPS, generator=g))
        outs = [gen.points_forward(st, world, opts, draws=draws, return_depth=True,
                                   cfg=GeneratorConfig(**GCFG, fast_sin=fast_sin, fused_ray=f))
                for f in (False, True)]
    for a, b_ in zip(*outs):
        torch.testing.assert_close(a, b_, rtol=2e-4, atol=2e-5)


def test_depth_rule_and_registry():
    """Depth 0 is refused only with fused_ray (`models/generator.py:91-95`);
    the registry builds the flagship (plain and freeze) and the three D."""
    from cips3d_tpu_torch.config.config import registry_get
    from cips3d_tpu_torch.models import registry  # noqa: F401  (registers the builders)

    GeneratorConfig(**GCFG, nerf_hidden_layers=0)
    with pytest.raises(ValueError, match="nerf_hidden_layers"):
        GeneratorConfig(**GCFG, nerf_hidden_layers=0, fused_ray=True)
    g = registry_get("cips3d_tpu_torch.models.GeneratorNerfINR_freeze_NeRF")(**GCFG, unknown=1)
    assert g.cfg.freeze_nerf and g.cfg.nerf_hidden_dim == 16
    for name in ("Discriminator", "DiscriminatorMultiScale", "DiscriminatorMultiScaleAux"):
        kw = dict(size=16) if name == "Discriminator" else dict(max_size=16)
        registry_get(f"cips3d_tpu_torch.models.{name}")(**kw, channels_override={
            r: 16 for r in (4, 8, 16, 32, 64, 128, 256, 512, 1024)})


# ---------------------------------------------------------------- DiffAug

def jax_diffaug_draws(key, b, h, w):
    """The draws `diff_augment(key, x)` makes, in its split order."""
    out = []
    for _ in range(3):
        key, sub = jax.random.split(key)
        out.append(t(jax.random.uniform(sub, (b, 1, 1, 1), jnp.float32).reshape(b)))
    sh, sw, ch, cw = pda._sizes(h, w)
    for lo_h, hi_h, lo_w, hi_w in ((-sh, sh + 1, -sw, sw + 1),
                                   (0, h + (1 - ch % 2), 0, w + (1 - cw % 2))):
        key, sub = jax.random.split(key)
        kh, kw = jax.random.split(sub)
        out.append(torch.from_numpy(np.asarray(jax.random.randint(kh, (b, 1, 1), lo_h, hi_h))
                                    .reshape(b).astype(np.int64)))
        out.append(torch.from_numpy(np.asarray(jax.random.randint(kw, (b, 1, 1), lo_w, hi_w))
                                    .reshape(b).astype(np.int64)))
    return pda.DiffAugDraws(*out)


@pytest.mark.parametrize("op", ["brightness", "saturation", "contrast", "translation", "cutout",
                                "pipeline"])
@pytest.mark.parametrize("size", [8, 16])
def test_diffaug_matches_jax(op, size):
    b = 6
    x = np.random.default_rng(14).uniform(-1, 1, (b, 3, size, size)).astype(np.float32)
    key = jax.random.PRNGKey(15)
    draws = jax_diffaug_draws(key, b, size, size)
    subs = []
    k = key
    for _ in range(5):
        k, sub = jax.random.split(k)
        subs.append(sub)
    jfn, pfn = {
        "brightness": (lambda a: jda.rand_brightness(subs[0], a),
                       lambda a: pda.rand_brightness(a, draws.brightness)),
        "saturation": (lambda a: jda.rand_saturation(subs[1], a),
                       lambda a: pda.rand_saturation(a, draws.saturation)),
        "contrast": (lambda a: jda.rand_contrast(subs[2], a),
                     lambda a: pda.rand_contrast(a, draws.contrast)),
        "translation": (lambda a: jda.rand_translation(subs[3], a),
                        lambda a: pda.rand_translation(a, draws.shift_h, draws.shift_w)),
        "cutout": (lambda a: jda.rand_cutout(subs[4], a),
                   lambda a: pda.rand_cutout(a, draws.cut_h, draws.cut_w)),
        "pipeline": (lambda a: jda.diff_augment(key, a), lambda a: pda.diff_augment(a, draws)),
    }[op]
    ref = jfn(jnp.asarray(x))
    xt = t(x).requires_grad_()
    got = pfn(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    wgt = np.random.default_rng(16).standard_normal(x.shape).astype(np.float32)
    jg = jax.grad(lambda a: (jfn(a) * wgt).sum())(jnp.asarray(x))
    (got * t(wgt)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=0, atol=1e-6)


def test_discriminator_diffaug_split_matches_jax():
    """D with DiffAug: k1 augments the main D's half, k2 the aux D's."""
    from cips3d_tpu.models.discriminator import DiscriminatorMultiScaleAux as JaxD
    from cips3d_tpu_torch.models.discriminator import DiscriminatorMultiScaleAux
    from cips3d_tpu_torch.utils.convert import load_jax_d_params

    tiny = {r: 16 for r in (4, 8, 16, 32, 64, 128, 256, 512, 1024)}
    jd = JaxD(diffaug=True, max_size=16, channels_override=tiny)
    dp = jax.tree_util.tree_map(np.asarray, jax.jit(lambda k: jd.init(
        k, jnp.zeros((2, 3, 8, 8)), method=jd.init_all))(jax.random.PRNGKey(0)))
    pd = DiscriminatorMultiScaleAux(diffaug=True, max_size=16, channels_override=tiny)
    load_jax_d_params(pd, dp)
    x = np.random.default_rng(17).uniform(-1, 1, (4, 3, 16, 16)).astype(np.float32)
    key = jax.random.PRNGKey(18)
    k1, k2 = jax.random.split(key)
    for aux in (True, False):
        ref = jax.jit(lambda p, a, k: jd.apply(p, a, 0.7, use_aux_disc=aux, diffaug_key=k,
                                               fade_in=True))(dp, jnp.asarray(x), key)
        half = 2 if aux else 4
        draws = (jax_diffaug_draws(k1, half, 16, 16),
                 jax_diffaug_draws(k2, half, 16, 16) if aux else None)
        got = pd(t(x), 0.7, use_aux_disc=aux, fade_in=True, diffaug=draws)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **FWD)
