"""The port's training step (`cips3d_tpu_torch/train/`) against the JAX
package's, at tiny widths (as `tests/test_train_step.py`).

One whole `make_train_step` step from the same bridged state, the same real
batch and the same draws (rebuilt from the JAX key splits of
`train/step.py:143,186,215`, `models/generator.py:425,436`,
`core/rays.py:127,247` and `ops/pallas/ray_tile.py:953-965`), with the
Pallas kernels in interpret mode as the JAX tests run them.  Tolerances:
losses rtol 1e-4; the clipped G and D grads (captured where each step clips
them) within a normalised max|a-b| / (max|b| + 1) < 3e-4, as
`tests/test_pallas_ray.py:252`; parameters after the step within 2e-2 * lr
on all but 0.1 % of elements (with beta1 = 0 the first Adam update is
+-lr, so a near-zero gradient may flip its sign).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cips3d_tpu.train.step as jax_step
import cips3d_tpu_torch.train.step as port_step
from cips3d_tpu.core.ema import ema_update as jax_ema_update
from cips3d_tpu.core.points import gather_points as jax_gather, scatter_points as jax_scatter
from cips3d_tpu.models.discriminator import DiscriminatorMultiScaleAux as JaxD
from cips3d_tpu.models.generator import GeneratorConfig as JaxConfig
from cips3d_tpu.models.generator import GeneratorNerfINR as JaxG
from cips3d_tpu.models.generator import RenderOptions as JaxOptions
from cips3d_tpu.models.generator import sample_zs as jax_sample_zs
from cips3d_tpu.train import schedules as jax_schedules
from cips3d_tpu.train.state import TrainConfig as JaxTrainConfig
from cips3d_tpu.train.state import clip_and_guard as jax_clip
from cips3d_tpu_torch.core import ema, points
from cips3d_tpu_torch.models.discriminator import DiscriminatorMultiScaleAux
from cips3d_tpu_torch.models.generator import (ForwardDraws, GeneratorConfig, GeneratorNerfINR,
                                               RenderOptions)
from cips3d_tpu_torch.ops.ray_tile import RayDraws
from cips3d_tpu_torch.train import schedules
from cips3d_tpu_torch.train.state import TrainConfig, clip_and_guard
from cips3d_tpu_torch.train.step import PhaseDraws, StepDraws, init_train_state, make_train_step
from cips3d_tpu_torch.utils.convert import (discriminator_state_dict, load_jax_train_state,
                                            state_dict_from_jax)
from test_torch_volume import jax_diffaug_draws

GCFG = dict(z_dim_nerf=16, z_dim_inr=32, nerf_hidden_dim=16, nerf_style_dim=16,
            nerf_mapping_layers=2, inr_hidden_dim=32, inr_style_dim=32, inr_mapping_layers=2)
TINY = {4: 16, 8: 16, 16: 16, 32: 16, 64: 16, 128: 16, 256: 16, 512: 16, 1024: 16}
IMG, STEPS, BATCH = 8, 4, 2


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _grad_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1.0)


# ---------------------------------------------------------------- pieces

def test_adam_matches_optax():
    """torch.optim.Adam(betas=(0, 0.999), eps=1e-8) gives optax.adam's
    update over several steps (with a tiny and a zero grad), to two float32
    ulps of the parameter or 1.5e-5 of the learning rate."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal(64).astype(np.float32)
    grads = [rng.standard_normal(64).astype(np.float32) * s for s in (1.0, 1e-3, 0.0, 5.0)]
    tx = optax.adam(2e-3, b1=0.0, b2=0.999, eps=1e-8)
    pj, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    pt = torch.nn.Parameter(t(p0))
    opt = torch.optim.Adam([pt], lr=2e-3, betas=(0.0, 0.999), eps=1e-8)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, pj)
        pj = pj + upd
        pt.grad = t(g)
        opt.step()
        np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), rtol=2.4e-7, atol=3e-8)


@pytest.mark.parametrize("scale", [100.0, 0.1, float("nan")], ids=["clip", "under", "nan"])
def test_clip_and_guard_matches_jax(scale):
    g = [np.full(4, 1.0, np.float32) * scale, np.arange(3, dtype=np.float32)]
    ref, rnorm, rfin = jax_clip({"a": jnp.asarray(g[0]), "b": jnp.asarray(g[1])}, 10.0)
    out, norm, fin = clip_and_guard([t(x) for x in g], 10.0)
    assert bool(fin) == bool(rfin)
    np.testing.assert_allclose(float(norm), float(rnorm), rtol=1e-6)
    for a, k in zip(out, ("a", "b")):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref[k]), rtol=1e-6)


def test_schedules_ema_and_points_match_jax():
    for step in (0, 10, 2500, 6000):
        assert schedules.nerf_noise_schedule(step) == pytest.approx(
            float(jax_schedules.nerf_noise_schedule(step)))
        assert schedules.alpha_schedule(step, True, 5000) == pytest.approx(
            float(jax_schedules.alpha_schedule(step, True, 5000)))
    assert schedules.alpha_schedule(3, False) == 1.0
    assert schedules.nerf_noise_schedule(3, True) == 0.0
    src, dst = torch.nn.Linear(3, 2), torch.nn.Linear(3, 2)
    e = ema.ema_copy(dst)
    assert not any(p.requires_grad for p in e.parameters())
    ema.ema_update(e, src, step=5, decay=0.9, start_itr=10)   # frozen before start_itr
    torch.testing.assert_close(e.weight, dst.weight)
    ref = jax_ema_update({"w": jnp.asarray(e.weight.numpy())},
                         {"w": jnp.asarray(src.weight.detach().numpy())}, 10, 0.9, 10)
    ema.ema_update(e, src, step=10, decay=0.9, start_itr=10)
    np.testing.assert_allclose(e.weight.numpy(), np.asarray(ref["w"]), rtol=1e-6)
    x = np.random.default_rng(1).standard_normal((2, 10, 3, 2)).astype(np.float32)
    perm = np.random.default_rng(2).permutation(10)
    gi, ni = perm[:4], perm[4:]
    np.testing.assert_array_equal(points.gather_points(t(x), torch.from_numpy(gi)).numpy(),
                                  np.asarray(jax_gather(jnp.asarray(x), jnp.asarray(gi))))
    a, b = x[:, :4, 0], x[:, 4:, 1]
    np.testing.assert_array_equal(
        points.scatter_points(torch.from_numpy(gi), t(a), torch.from_numpy(ni), t(b), 10).numpy(),
        np.asarray(jax_scatter(jnp.asarray(gi), jnp.asarray(a), jnp.asarray(ni),
                               jnp.asarray(b), 10)))


# ---------------------------------------------------------------- one step

def _ray_draws(key, b, n):
    k_pdf, k_nc, k_nf = jax.random.split(key, 3)
    u = jax.random.uniform(k_pdf, (b * n, STEPS), jnp.float32).reshape(b, n, STEPS)
    nc = jax.random.normal(k_nc, (b, n, STEPS, 1), jnp.float32)[..., 0]
    nf = jax.random.normal(k_nf, (b, n, 2 * STEPS, 1), jnp.float32)[..., 0]
    return RayDraws(t(u), t(nc), t(nf))


def _forward_draws(key, b, grad_points):
    """The draws `GeneratorNerfINR.__call__` makes from ``key`` (training
    noise is a traced scalar there, so the density noise is always drawn)."""
    k_rays, k_pts = jax.random.split(key)
    k_perturb, k_cam = jax.random.split(k_rays)
    perturb = jax.random.uniform(k_perturb, (b, IMG * IMG, STEPS, 1), jnp.float32)
    k_theta, k_phi, _ = jax.random.split(k_cam, 3)
    camera = (t(jax.random.normal(k_theta, (b, 1))), t(jax.random.normal(k_phi, (b, 1))))
    n = IMG * IMG
    if grad_points is None or grad_points >= n:
        return ForwardDraws(t(perturb), camera, _ray_draws(k_pts, b, n))
    k_perm, k1, k2 = jax.random.split(k_pts, 3)
    perm = torch.from_numpy(np.asarray(jax.random.permutation(k_perm, n)).astype(np.int64))
    return ForwardDraws(t(perturb), camera, _ray_draws(k1, b, grad_points), perm,
                        _ray_draws(k2, b, n - grad_points))


def _disc_diffaug(key, mb, aux):
    """The DiffAug draws of one D call from ``key`` (split into k1 for the
    main D and k2 for the aux D, `models/discriminator.py:403-417`)."""
    k1, k2 = jax.random.split(key)
    return (jax_diffaug_draws(k1, mb, IMG, IMG),
            jax_diffaug_draws(k2, mb, IMG, IMG) if aux else None)


def _step_draws(key, jcfg, batch_split, grad_points, aux=True, diffaug=False):
    k_d, k_gz, k_g = jax.random.split(key, 3)
    d_keys = [k_d] if batch_split == 1 else list(jax.random.split(k_d, batch_split))
    mb = BATCH // batch_split
    d = []
    for kd in d_keys:
        k_z, k_gen, k_da1, k_da2 = jax.random.split(kd, 4)
        zs = jax_sample_zs(k_z, mb, jcfg)
        da = dict(diffaug_real=_disc_diffaug(k_da1, mb, aux),
                  diffaug=_disc_diffaug(k_da2, mb, aux)) if diffaug else {}
        d.append(PhaseDraws({k: t(v) for k, v in zs.items()}, _forward_draws(k_gen, mb, None),
                            **da))
    zs = jax_sample_zs(k_gz, BATCH, jcfg)
    g_keys = [k_g] if batch_split == 1 else list(jax.random.split(k_g, batch_split))
    g = []
    for i, kg in enumerate(g_keys):
        k_gen, k_da = jax.random.split(kg)
        zs_i = {k: t(v[i * mb:(i + 1) * mb]) for k, v in zs.items()}
        g.append(PhaseDraws(zs_i, _forward_draws(k_gen, mb, grad_points),
                            _disc_diffaug(k_da, mb, aux) if diffaug else None))
    return StepDraws(d, g)


def _capture(monkeypatch, module, clip):
    """Record the clipped grads each step passes to its optimizer."""
    seen = []

    def wrapped(grads, max_norm):
        out = clip(grads, max_norm)
        seen.append(out[0])
        return out

    monkeypatch.setattr(module, "clip_and_guard", wrapped)
    return seen


def _close_share(a, b, atol):
    """Share of elements further apart than atol."""
    return float(np.mean(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)) > atol))


@pytest.fixture(scope="module")
def jax_state():
    """One JAX initial state for every case: the parameters do not depend on
    fused_ray_vjp, aux_reg or batch_split, and Adam starts at zero."""
    jcfg = JaxConfig(**GCFG, fused_ray=True)
    state = jax_step.init_train_state(
        jax.random.PRNGKey(0), JaxG(cfg=jcfg), JaxD(max_size=16, channels_override=TINY),
        JaxTrainConfig(img_size=IMG, batch_size=BATCH), JaxOptions(img_size=IMG, num_steps=STEPS))
    return jax.tree_util.tree_map(np.asarray, state)


# the generator's flags: the exact-sine kernels' paths, configs/ffhq.yaml's shipped
# generator (fast_sin, unfused G phase; the D phase on the kernels by the auto-pick), and
# train_r256's settings (freeze_nerf, DiffAug, warmup_d, aux off, NeRF noise disabled)
SHIPPED = dict(fast_sin=True, fused_ray=False)
R256 = dict(fast_sin=True, fused_ray=False, freeze_nerf=True)


@pytest.mark.parametrize("gflags,aux,d_reg,split,grad_points,extra", [
    (dict(fused_ray=True, fused_ray_vjp="pallas"), True, True, 1, None, {}),
    (dict(fused_ray=True, fused_ray_vjp="pallas_residual"), False, False, 1, None, {}),
    (dict(fused_ray=True, fused_ray_vjp="pallas_residual"), True, True, 2, 4, {}),
    (SHIPPED, True, True, 1, 4, {}),
    (R256, False, True, 1, None, dict(diffaug=True, warmup_d=True, nerf_noise_disable=True)),
], ids=["pallas-aux-r1", "residual-noaux-nor1", "residual-aux-r1-split2-gradpoints",
        "shipped-aux-r1-gradpoints", "r256-diffaug-freeze-warmup-noaux"])
def test_train_step_matches_jax(monkeypatch, jax_state, gflags, aux, d_reg, split, grad_points,
                                extra):
    jcfg = JaxConfig(**GCFG, **gflags)
    diffaug = extra.get("diffaug", False)
    tkw = dict(img_size=IMG, batch_size=BATCH, batch_split=split, grad_points=grad_points,
               ema_start_itr=0, **extra)
    jopts = JaxOptions(img_size=IMG, num_steps=STEPS)
    jgen, jdisc = JaxG(cfg=jcfg), JaxD(diffaug=diffaug, max_size=16, channels_override=TINY)
    jstate = jax_state
    real = np.random.default_rng(1).uniform(-1, 1, (BATCH, 3, IMG, IMG)).astype(np.float32)
    key = jax.random.PRNGKey(2)

    jseen = _capture(monkeypatch, jax_step, jax_clip)
    jfn = jax_step.make_train_step(jgen, jdisc, JaxTrainConfig(**tkw), jopts, aux_reg=aux,
                                   d_regularize=d_reg)

    def run(state, x, k):   # the captured clipped grads leave the jitted step as outputs
        jseen.clear()
        new, metrics = jfn(state, x, k)
        return new, metrics, list(jseen)

    jnew, jm, jseen = jax.jit(run)(jstate, jnp.asarray(real), key)

    gen = GeneratorNerfINR(GeneratorConfig(**GCFG, **gflags))
    disc = DiscriminatorMultiScaleAux(diffaug=diffaug, max_size=16, channels_override=TINY)
    state = init_train_state(gen, disc, TrainConfig(**tkw))
    load_jax_train_state(state, jstate.g_params, jstate.d_params, jstate.ema_params,
                         int(jstate.step))
    pseen = _capture(monkeypatch, port_step, clip_and_guard)
    fn = make_train_step(gen, disc, TrainConfig(**tkw), RenderOptions(img_size=IMG,
                                                                      num_steps=STEPS),
                         aux_reg=aux, d_regularize=d_reg)
    draws = _step_draws(key, jcfg, split, grad_points ** 2 if grad_points else None, aux,
                        diffaug)
    state, m = fn(state, t(real), draws=draws)
    assert state.step == 1 and set(m) == set(jm)

    for k in ("d_loss", "g_loss", "grad_penalty", "d_logits_real", "d_logits_fake"):
        np.testing.assert_allclose(m[k], float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    for k in ("d_total_norm", "g_total_norm", "d_w_norm"):
        np.testing.assert_allclose(m[k], float(jm[k]), rtol=3e-4, err_msg=k)
    assert m["d_finite"] == m["g_finite"] == 1.0

    # clipped grads: D then G, on each side
    d_names = [n for n, _ in disc.named_parameters()]
    g_names = [n for n, _ in gen.named_parameters()]
    d_ref = discriminator_state_dict(jax.tree_util.tree_map(np.asarray, jseen[0]))
    g_ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jseen[1]))
    for names, got, ref in ((d_names, pseen[0], d_ref), (g_names, pseen[1], g_ref)):
        for name, g in zip(names, got):
            if ".norm." in name:   # the reference's unused LayerNorm: no JAX parameter
                continue
            assert _grad_err(g.numpy(), ref[name]) < 3e-4, name

    # parameters after Adam, and the EMA
    for lr, mod, ref in ((TrainConfig().disc_lr, disc, discriminator_state_dict(jnew.d_params)),
                         (TrainConfig().gen_lr, gen, state_dict_from_jax(jnew.g_params)),
                         (TrainConfig().gen_lr, state.ema, state_dict_from_jax(jnew.ema_params))):
        sd = mod.state_dict()
        share = np.mean([_close_share(sd[k].numpy(), ref[k], 2e-2 * lr) for k in ref
                         if ".norm." not in k])
        assert share <= 1e-3, share


def test_train_step_draws_from_a_generator():
    """Without StepDraws the step draws from a torch.Generator: finite
    losses, parameters that move, the same result from the same seed."""
    cfg = TrainConfig(img_size=IMG, batch_size=BATCH, grad_points=None)
    results = []
    for _ in range(2):
        gen = GeneratorNerfINR(GeneratorConfig(**GCFG, fused_ray=True),
                               generator=torch.Generator().manual_seed(0))
        disc = DiscriminatorMultiScaleAux(max_size=16, channels_override=TINY,
                                          generator=torch.Generator().manual_seed(1))
        state = init_train_state(gen, disc, cfg)
        before = [p.detach().clone() for p in gen.parameters()]
        fn = make_train_step(gen, disc, cfg, RenderOptions(num_steps=STEPS), aux_reg=True)
        real = torch.rand((BATCH, 3, IMG, IMG), generator=torch.Generator().manual_seed(2))
        state, m = fn(state, real * 2 - 1, rng=torch.Generator().manual_seed(3))
        assert all(np.isfinite(v) for v in m.values())
        assert any(not torch.equal(a, b) for a, b in zip(before, gen.parameters()))
        results.append(m)
    assert results[0] == results[1]


def test_fused_inr_is_forward_only():
    """The G phase cannot differentiate through the INR-tile kernel."""
    gen = GeneratorNerfINR(GeneratorConfig(**GCFG, fused_ray=True, fused_inr=True))
    zs = {"z_nerf": torch.randn(1, 16), "z_inr": torch.randn(1, 32)}
    img, _ = gen(zs, RenderOptions(img_size=IMG, num_steps=STEPS),
                 torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="forward only"):
        img.sum().backward()


def test_unfused_generator_raises_and_config_validates():
    """The unfused generator renders and takes gradients (it raised before
    the unfused NeRF stage was ported); the config checks still raise: an
    unknown fused_ray_vjp, and an explicit fused_dphase on a depth-0
    generator (the auto-pick keeps the plain D phase there).  A step with
    DiffAug builds and runs."""
    gen = GeneratorNerfINR(GeneratorConfig(**GCFG), generator=torch.Generator().manual_seed(0))
    zs = {"z_nerf": torch.randn(1, 16), "z_inr": torch.randn(1, 32)}
    img, _ = gen(zs, RenderOptions(img_size=IMG, num_steps=STEPS, hierarchical_sample=False),
                 torch.Generator().manual_seed(0))
    assert img.shape == (1, 3, IMG, IMG) and torch.isfinite(img).all()
    img.sum().backward()
    assert gen.siren.network[0].linear.weight.grad.abs().sum() > 0
    with pytest.raises(ValueError, match="fused_ray_vjp"):
        GeneratorConfig(**GCFG, fused_ray_vjp="xla")
    disc = DiscriminatorMultiScaleAux(diffaug=True, max_size=16, channels_override=TINY)
    depth0 = GeneratorNerfINR(GeneratorConfig(**GCFG, nerf_hidden_layers=0, fast_sin=True))
    with pytest.raises(ValueError, match="fused_dphase"):
        make_train_step(depth0, disc, TrainConfig(fused_dphase=True), RenderOptions(),
                        aux_reg=False)
    cfg = dataclasses.replace(TrainConfig(img_size=IMG, batch_size=BATCH, grad_points=None),
                              diffaug=True)
    state = init_train_state(depth0, disc, cfg)
    fn = make_train_step(depth0, disc, cfg, RenderOptions(num_steps=STEPS), aux_reg=True)
    state, m = fn(state, torch.rand((BATCH, 3, IMG, IMG)) * 2 - 1,
                  rng=torch.Generator().manual_seed(1))
    assert all(np.isfinite(v) for v in m.values())
