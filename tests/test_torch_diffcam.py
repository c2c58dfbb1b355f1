"""The port's diffcam pipeline (`models/generator_diffcam.py`,
`train/diffcam_step.py`) against the JAX package at tiny widths (as
`tests/test_variant_loops.py`).

The draws are rebuilt from the JAX key splits: `forward_rays`
(`generator_diffcam.py:65`: perturb, pdf, n1, n2), the camera
(`camera.py:143`, `core/rays.py:127`) and the step
(`diffcam_step.py:65,82,119,127`).  Tolerances: the forward f32 rtol 1e-4 /
atol 1e-5, grads by max|a-b| / (max|b| + 1) <= 3e-4; the step as
`tests/test_torch_train.py` (losses rtol 1e-4, clipped grads 3e-4,
parameters after Adam within 2e-2 lr on all but 0.1 % of elements).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cips3d_tpu.train.diffcam_step as jax_step
import cips3d_tpu_torch.train.diffcam_step as port_step
from cips3d_tpu.models.camera import CamParams as JaxCam
from cips3d_tpu.models.discriminator import DiscriminatorMultiScaleAux as JaxD
from cips3d_tpu.models.generator import GeneratorConfig as JaxConfig
from cips3d_tpu.models.generator import sample_zs as jax_sample_zs
from cips3d_tpu.models.generator_diffcam import GeneratorDiffcam as JaxG
from cips3d_tpu.models.generator_diffcam import NerfKwargs as JaxNK
from cips3d_tpu.train.state import clip_and_guard as jax_clip
from cips3d_tpu_torch.models.camera import CamParams
from cips3d_tpu_torch.models.discriminator import DiscriminatorMultiScaleAux
from cips3d_tpu_torch.models.generator import GeneratorConfig
from cips3d_tpu_torch.models.generator_diffcam import DiffcamDraws, GeneratorDiffcam, NerfKwargs
from cips3d_tpu_torch.train.diffcam_step import (DiffcamPhaseDraws, DiffcamStepDraws,
                                                 DiffcamTrainConfig, init_diffcam_state,
                                                 make_diffcam_train_step)
from cips3d_tpu_torch.train.state import clip_and_guard
from cips3d_tpu_torch.utils import convert
from test_torch_camera import jax_camera_draws
from test_torch_train import _capture, _close_share, _disc_diffaug, _grad_err

GCFG = dict(z_dim_nerf=16, z_dim_inr=32, nerf_hidden_dim=16, nerf_style_dim=16,
            nerf_mapping_layers=2, inr_hidden_dim=32, inr_style_dim=32, inr_mapping_layers=2)
TINY = {r: 16 for r in (4, 8, 16, 32, 64, 128, 256, 512, 1024)}
IMG, S, BATCH = 8, 3, 2
FWD = dict(rtol=1e-4, atol=1e-5)


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def forward_draws(key, b, n, nk):
    """The draws `GeneratorDiffcam.forward_rays` makes from ``key``."""
    k_perturb, k_pdf, k_n1, k_n2 = jax.random.split(key, 4)
    s, i = nk.n_samples, nk.n_importance
    return DiffcamDraws(t(jax.random.uniform(k_perturb, (b, n, s, 1))),
                        t(jax.random.uniform(k_pdf, (b * n, i))),
                        t(jax.random.normal(k_n1, (b, n, s, 1))),
                        t(jax.random.normal(k_n2, (b, n, i + s, 1))))


@pytest.fixture(scope="module")
def jax_state():
    """One JAX initial state (G, D, camera, three Adams) for every case."""
    state = jax_step.init_diffcam_state(
        jax.random.PRNGKey(0), JaxG(cfg=JaxConfig(**GCFG)), JaxD(max_size=16,
                                                                 channels_override=TINY),
        JaxCam(H0=IMG, W0=IMG), jax_step.DiffcamTrainConfig(img_size=IMG, batch_size=BATCH),
        JaxNK(n_samples=S, n_importance=S))
    return jax.tree_util.tree_map(np.asarray, state)


def _port_modules(jstate, gflags=None, diffaug=False):
    gen = GeneratorDiffcam(GeneratorConfig(**GCFG, **(gflags or {})))
    convert.load_jax_params(gen, jstate.g_params)
    disc = DiscriminatorMultiScaleAux(diffaug=diffaug, max_size=16, channels_override=TINY)
    convert.load_jax_d_params(disc, jstate.d_params)
    cam = CamParams(H0=IMG, W0=IMG)
    cam.load_state_dict(convert.to_torch(convert.cam_state_dict(jstate.cam_params)), strict=True)
    return gen, disc, cam


@pytest.mark.parametrize("noise", [0.0, 1.0])
@pytest.mark.parametrize("importance", [S, 0], ids=["importance", "coarse"])
def test_forward_rays_matches_jax(jax_state, importance, noise):
    """Images, depth, weights sum and aux images, and the grads of a loss
    over them with respect to G's parameters and the rays; the polynomial
    sine of the shipped config with importance sampling."""
    fast_sin = importance > 0
    jgen = JaxG(cfg=JaxConfig(**GCFG, fast_sin=fast_sin))
    jnk = JaxNK(n_samples=S, n_importance=importance, raw_noise_std=noise)
    rng = np.random.default_rng(3)
    zs = {k: rng.standard_normal((BATCH, d)).astype(np.float32)
          for k, d in (("z_nerf", 16), ("z_inr", 32))}
    jcam = JaxCam(H0=IMG, W0=IMG)
    rays_o, rays_d, _ = jcam.apply(jax_state.cam_params, jax.random.PRNGKey(4), BATCH, IMG, IMG,
                                   method=jcam.get_rays_random_pose)
    rays_o, rays_d = np.asarray(rays_o), np.asarray(rays_d)
    w = rng.standard_normal((4, BATCH, 3, IMG, IMG)).astype(np.float32)
    key = jax.random.PRNGKey(5)

    def jloss(params, ro, rd):
        imgs, ret = jgen.apply(params, zs, ro, rd, key, jnk, return_aux_img=True,
                               method=jgen.forward_rays)
        outs = (imgs, ret["aux_img"], ret["depth"], ret["weights_sum"])
        return sum(jnp.sum(o * w[i][:, :o.shape[1]]) for i, o in enumerate(outs)), outs

    (_, ref), grads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        jax_state.g_params, rays_o, rays_d)

    gen, _, _ = _port_modules(jax_state, dict(fast_sin=fast_sin))
    ro, rd = t(rays_o).requires_grad_(True), t(rays_d).requires_grad_(True)
    nk = NerfKwargs(n_samples=S, n_importance=importance, raw_noise_std=noise)
    imgs, ret = gen.forward_rays({k: t(v) for k, v in zs.items()}, ro, rd, nk,
                                 draws=forward_draws(key, BATCH, IMG * IMG, nk),
                                 return_aux_img=True)
    outs = (imgs, ret["aux_img"], ret["depth"], ret["weights_sum"])
    for name, a, b in zip(("imgs", "aux", "depth", "weights_sum"), outs, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **FWD, err_msg=name)
    loss = sum((o * t(w[i])[:, :o.shape[1]]).sum() for i, o in enumerate(outs))
    names = [n for n, _ in gen.named_parameters()]
    got = torch.autograd.grad(loss, list(gen.parameters()) + [ro, rd], allow_unused=True)
    want = convert.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads[0]))
    for name, g in zip(names, got):
        if name in want and ".norm." not in name:
            gv = np.zeros_like(want[name]) if g is None else g.numpy()
            assert _grad_err(gv, want[name]) < 3e-4, name
    for g, ref_g in zip(got[-2:], grads[1:]):
        assert _grad_err(g.numpy(), ref_g) < 3e-4


def _step_draws(key, aux, diffaug):
    """The draws of one `make_diffcam_train_step` step from ``key``."""
    nk = NerfKwargs(n_samples=S, n_importance=S)
    jcfg = JaxConfig(**GCFG)

    def fake_draws(k):
        k_cam, k_g = jax.random.split(k)
        return jax_camera_draws(k_cam, BATCH, "gaussian"), forward_draws(k_g, BATCH, IMG * IMG,
                                                                         nk)

    k_d, k_z, k_g = jax.random.split(key, 3)
    kz, kf, kda1, kda2 = jax.random.split(k_d, 4)
    da = dict(diffaug_real=_disc_diffaug(kda1, BATCH, aux),
              diffaug=_disc_diffaug(kda2, BATCH, aux)) if diffaug else {}
    d = DiffcamPhaseDraws({k: t(v) for k, v in jax_sample_zs(kz, BATCH, jcfg).items()},
                          *fake_draws(kf), **da)
    kf, kda = jax.random.split(k_g)
    g = DiffcamPhaseDraws({k: t(v) for k, v in jax_sample_zs(k_z, BATCH, jcfg).items()},
                          *fake_draws(kf), _disc_diffaug(kda, BATCH, aux) if diffaug else None)
    return DiffcamStepDraws(d, g)


@pytest.mark.parametrize("gflags,aux,extra", [
    ({}, True, dict(nerf_noise_disable=True)),
    (dict(fast_sin=True), False, dict(diffaug=True, warmup_d=True)),
], ids=["aux-r1-nonoise", "fastsin-noaux-diffaug-warmup-noise1"])
def test_diffcam_step_matches_jax(monkeypatch, jax_state, gflags, aux, extra):
    """Losses, the three clipped grads (D, G, camera), the parameters after
    the three Adams, and the EMA."""
    diffaug = extra.get("diffaug", False)
    tkw = dict(img_size=IMG, batch_size=BATCH, grad_points=None, ema_start_itr=0, **extra)
    jgen, jdisc = JaxG(cfg=JaxConfig(**GCFG, **gflags)), JaxD(diffaug=diffaug, max_size=16,
                                                              channels_override=TINY)
    jcam = JaxCam(H0=IMG, W0=IMG)
    real = np.random.default_rng(1).uniform(-1, 1, (BATCH, 3, IMG, IMG)).astype(np.float32)
    key = jax.random.PRNGKey(2)

    jseen = _capture(monkeypatch, jax_step, jax_clip)
    jfn = jax_step.make_diffcam_train_step(jgen, jdisc, jcam, jax_step.DiffcamTrainConfig(**tkw),
                                           JaxNK(n_samples=S, n_importance=S), aux_reg=aux)

    def run(state, x, k):
        jseen.clear()
        new, metrics = jfn(state, x, k)
        return new, metrics, list(jseen)

    jnew, jm, jseen = jax.jit(run)(jax_state, jnp.asarray(real), key)

    gen, disc, cam = _port_modules(jax_state, gflags, diffaug)
    cfg = DiffcamTrainConfig(**tkw)
    state = init_diffcam_state(gen, disc, cam, cfg)
    pseen = _capture(monkeypatch, port_step, clip_and_guard)
    fn = make_diffcam_train_step(gen, disc, cam, cfg, NerfKwargs(n_samples=S, n_importance=S),
                                 aux_reg=aux)
    state, m = fn(state, t(real), draws=_step_draws(key, aux, diffaug))
    assert state.step == 1 and set(m) == set(jm)

    for k in ("d_loss", "g_loss", "grad_penalty"):
        np.testing.assert_allclose(m[k], float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    for k in ("d_total_norm", "g_total_norm", "cam_total_norm"):
        np.testing.assert_allclose(m[k], float(jm[k]), rtol=3e-4, err_msg=k)
    assert m["d_finite"] == m["g_finite"] == 1.0 and m["cam_total_norm"] > 0

    d_ref = convert.discriminator_state_dict(jax.tree_util.tree_map(np.asarray, jseen[0]))
    g_ref = convert.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jseen[1]))
    c_ref = convert.cam_state_dict(jax.tree_util.tree_map(np.asarray, jseen[2]))
    for module, got, ref in ((disc, pseen[0], d_ref), (gen, pseen[1], g_ref),
                             (cam, pseen[2], c_ref)):
        for (name, _), g in zip(module.named_parameters(), got):
            if ".norm." not in name:
                assert _grad_err(g.numpy(), ref[name]) < 3e-4, name

    for lr, mod, ref in ((cfg.disc_lr, disc, convert.discriminator_state_dict(jnew.d_params)),
                         (cfg.gen_lr, gen, convert.state_dict_from_jax(jnew.g_params)),
                         (cfg.gen_lr, state.ema, convert.state_dict_from_jax(jnew.ema_params)),
                         (cfg.cam_lr, cam, convert.cam_state_dict(jnew.cam_params))):
        sd = mod.state_dict()
        share = np.mean([_close_share(sd[k].numpy(), ref[k], 2e-2 * lr) for k in ref
                         if ".norm." not in k])
        assert share <= 1e-3, share
    before = convert.cam_state_dict(jax_state.cam_params)
    assert any(not np.array_equal(before[k], v.numpy()) for k, v in cam.state_dict().items())


def test_diffcam_step_draws_from_a_generator():
    """Without draws the step draws from a torch.Generator: finite losses,
    G, D, EMA and the camera move, the same result from the same seed."""
    results = []
    for _ in range(2):
        gen = GeneratorDiffcam(GeneratorConfig(**GCFG), generator=torch.Generator().manual_seed(0))
        disc = DiscriminatorMultiScaleAux(max_size=16, channels_override=TINY,
                                          generator=torch.Generator().manual_seed(1))
        cam = CamParams(H0=IMG, W0=IMG)
        cfg = DiffcamTrainConfig(img_size=IMG, batch_size=BATCH, ema_start_itr=0)
        state = init_diffcam_state(gen, disc, cam, cfg)
        fx0 = cam.fx_raw.detach().clone()
        fn = make_diffcam_train_step(gen, disc, cam, cfg, NerfKwargs(n_samples=S, n_importance=S),
                                     aux_reg=True)
        real = torch.rand((BATCH, 3, IMG, IMG), generator=torch.Generator().manual_seed(2))
        state, m = fn(state, real * 2 - 1, rng=torch.Generator().manual_seed(3))
        assert all(np.isfinite(v) for v in m.values())
        assert not torch.equal(fx0, cam.fx_raw)
        results.append(m)
    assert results[0] == results[1]
    # a camera with nothing to learn: no third Adam, a zero norm
    frozen = CamParams(H0=IMG, W0=IMG, learn_intrinsics=False)
    state = init_diffcam_state(gen, disc, frozen, cfg)
    assert state.cam_opt is None and list(frozen.state_dict()) == []
    fn = make_diffcam_train_step(gen, disc, frozen, cfg, NerfKwargs(n_samples=S, n_importance=S))
    _, m = fn(state, real * 2 - 1, rng=torch.Generator().manual_seed(3))
    assert m["cam_total_norm"] == 0.0 and m["g_finite"] == 1.0


def test_diffcam_pipeline_runs_resumes_and_trades_snapshots_with_jax(tmp_path):
    """Two debug steps of `DiffcamPipeline` on the CPU: eval, snapshots with
    `cam_param` in every tree and `cam_opt` in resume, an exact resume
    (every Adam's moments), the JAX package reading the resume tree into
    its pipeline's refs, and the port resuming a JAX resume tree."""
    from cips3d_tpu.train.variant_loop import DiffcamPipeline as JaxPipeline
    from cips3d_tpu_torch.data.synthetic import make_blob_dataset
    from cips3d_tpu_torch.train.variant_loop import DiffcamPipeline
    from test_torch_curriculum import trade_snapshots

    data = make_blob_dataset(str(tmp_path / "d.zip"), 6, img_size=8, seed=1)

    def make_port():
        return DiffcamPipeline(GeneratorConfig(**GCFG), dict(max_size=16, channels_override=TINY),
                               dict(H0=IMG, W0=IMG),
                               DiffcamTrainConfig(img_size=IMG, batch_size=BATCH, grad_points=None,
                                                  total_iters=2, ema_start_itr=1),
                               NerfKwargs(n_samples=S, n_importance=S))

    jpipe = JaxPipeline(JaxG(cfg=JaxConfig(**GCFG)), JaxD(max_size=16, channels_override=TINY),
                        JaxCam(H0=IMG, W0=IMG),
                        jax_step.DiffcamTrainConfig(img_size=IMG, batch_size=BATCH),
                        JaxNK(n_samples=S, n_importance=S))
    first, read = trade_snapshots(tmp_path, data, make_port, jpipe,
                                  jpipe.init_state(jax.random.PRNGKey(0)))
    assert "train.cam_total_norm.cam_total_norm.log" in os.listdir(tmp_path / "run" / "textdir")
    np.testing.assert_array_equal(np.asarray(read["cam_param"]["params"]["fx_raw"]),
                                  first.camera.fx_raw.detach().numpy())
    assert not np.array_equal(first.camera.fx_raw.detach().numpy(),
                              CamParams(H0=IMG, W0=IMG).fx_raw.detach().numpy())
