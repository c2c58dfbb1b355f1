"""The port's pi-GAN baseline (`models/pigan.py`, `train/pigan_step.py`,
`PiGANPipeline`) against the JAX package at tiny widths (as
`tests/test_variant_loops.py`).

The draws are rebuilt from the JAX key splits of `models/pigan.py:154`
(rays, pdf, n1, n2), `core/rays.py:247` (perturb, camera) and
`train/pigan_step.py:88,131,139`.  Tolerances: modules f32 rtol 1e-4 /
atol 1e-5 forward, grads by max|a-b| / (max|b| + 1) <= 3e-4; the step as
`tests/test_torch_train.py`; snapshots bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cips3d_tpu.train.pigan_step as jax_step
import cips3d_tpu_torch.train.pigan_step as port_step
from cips3d_tpu.models import pigan as jp
from cips3d_tpu.models.generator import RenderOptions as JaxOptions
from cips3d_tpu.train.state import clip_and_guard as jax_clip
from cips3d_tpu.utils.checkpoint import CheckpointManager as JaxManager
from cips3d_tpu_torch.models import pigan as pp
from cips3d_tpu_torch.models.generator import RenderOptions
from cips3d_tpu_torch.train.state import clip_and_guard
from cips3d_tpu_torch.utils import convert
from cips3d_tpu_torch.utils.checkpoint import CheckpointManager
from test_torch_camera import jax_camera_draws
from test_torch_train import _capture, _close_share, _grad_err

FWD = dict(rtol=1e-4, atol=1e-5)
IMG, S, BATCH = 8, 3, 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def forward_draws(key, b, opts):
    """The draws `ImplicitGenerator3d.__call__` makes from ``key``."""
    k_rays, k_pdf, k_n1, k_n2 = jax.random.split(key, 4)
    k_perturb, k_cam = jax.random.split(k_rays)
    n, s = opts.img_size ** 2, opts.num_steps
    m = 2 * s if opts.hierarchical_sample else s
    return pp.PiGANDraws(t(jax.random.uniform(k_perturb, (b, n, s, 1))),
                         jax_camera_draws(k_cam, b, opts.sample_dist),
                         t(jax.random.uniform(k_pdf, (b * n, s))),
                         t(jax.random.normal(k_n1, (b, n, s, 1))),
                         t(jax.random.normal(k_n2, (b, n, m, 1))))


def _port_g(params, **kw):
    g = pp.ImplicitGenerator3d(**kw)
    g.load_state_dict(convert.to_torch(convert.pigan_state_dict(params)), strict=True)
    return g


def _check_grads(module, got_grads, ref_sd):
    for (name, _), g in zip(module.named_parameters(), got_grads):
        if name in ref_sd:
            gv = np.zeros_like(ref_sd[name]) if g is None else g.numpy()
            assert _grad_err(gv, ref_sd[name]) < 3e-4, name


# ---------------------------------------------------------------- modules

@pytest.mark.parametrize("box_warp", [True, False], ids=["spatial", "tall"])
def test_siren_matches_jax(box_warp):
    js = jp.SpatialSirenBaseline(z_dim=16, hidden_dim=16, use_box_warp=box_warp)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.15, 0.15, (2, 10, 3)).astype(np.float32)
    dirs = rng.standard_normal((2, 10, 3)).astype(np.float32)
    z = rng.standard_normal((2, 16)).astype(np.float32)
    w = rng.standard_normal((2, 10, 4)).astype(np.float32)
    params = js.init(jax.random.PRNGKey(1), pts, z, dirs)
    ref = js.apply(params, pts, z, dirs)
    grads = jax.grad(lambda p: jnp.sum(js.apply(p, pts, z, dirs) * w))(params)
    ps = pp.SpatialSirenBaseline(z_dim=16, hidden_dim=16, use_box_warp=box_warp)
    sd = convert.pigan_state_dict({"siren": tree_np(params["params"])})
    ps.load_state_dict(convert.to_torch({k[len("siren."):]: v for k, v in sd.items()}),
                       strict=True)
    got = ps(t(pts), t(z), t(dirs))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **FWD)
    gsd = convert.pigan_state_dict({"siren": tree_np(grads["params"])})
    _check_grads(ps, torch.autograd.grad((got * t(w)).sum(), list(ps.parameters())),
                 {k[len("siren."):]: v for k, v in gsd.items()})


@pytest.fixture(scope="module")
def jax_g():
    g = jp.ImplicitGenerator3d(z_dim=16, hidden_dim=16)
    return g, tree_np(g.init(jax.random.PRNGKey(0), jnp.zeros((2, 16)), jax.random.PRNGKey(1),
                             JaxOptions(img_size=IMG, num_steps=S)))


@pytest.mark.parametrize("hier,noise,dist", [(True, 0.0, "gaussian"),
                                             (True, 1.0, "spherical_uniform"),
                                             (False, 0.0, "uniform"),
                                             (False, 1.0, "truncated_gaussian")])
def test_generator_matches_jax(jax_g, hier, noise, dist):
    """Images and pitch/yaw, and the parameter grads of a loss over the
    images."""
    jg, params = jax_g
    kw = dict(img_size=IMG, num_steps=S, hierarchical_sample=hier, nerf_noise=noise,
              sample_dist=dist)
    z = np.random.default_rng(2).standard_normal((BATCH, 16)).astype(np.float32)
    w = np.random.default_rng(3).standard_normal((BATCH, 3, IMG, IMG)).astype(np.float32)
    key = jax.random.PRNGKey(4)

    def jloss(p):
        imgs, pos = jg.apply(p, z, key, JaxOptions(**kw))
        return jnp.sum(imgs * w), (imgs, pos)

    (_, ref), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    g = _port_g(params, z_dim=16, hidden_dim=16)
    opts = RenderOptions(**kw)
    imgs, pos = g(t(z), opts, draws=forward_draws(key, BATCH, opts))
    np.testing.assert_allclose(imgs.detach().numpy(), np.asarray(ref[0]), **FWD)
    np.testing.assert_allclose(pos.numpy(), np.asarray(ref[1]), **FWD)
    _check_grads(g, torch.autograd.grad((imgs * t(w)).sum(), list(g.parameters())),
                 convert.pigan_state_dict(tree_np(grads)))


@pytest.mark.parametrize("alpha", [1.0, 0.5])
@pytest.mark.parametrize("size", [8, 16, 32])
@pytest.mark.parametrize("encoder", [False, True], ids=["plain", "encoder"])
def test_discriminator_matches_jax(encoder, size, alpha):
    """The outputs, and the grads of a loss over them with respect to the
    parameters and the images (the fade-in's nearest halving at alpha 0.5
    keeps pixels 2i + 1, as `jax.image.resize` does)."""
    jd = jp.ProgressiveDiscriminator(predict_encodings=encoder)
    x = np.random.default_rng(size).uniform(-1, 1, (2, 3, size, size)).astype(np.float32)
    params = tree_np(jd.init(jax.random.PRNGKey(size), jnp.asarray(x), alpha))
    pd = pp.ProgressiveDiscriminator(predict_encodings=encoder,
                                     generator=torch.Generator().manual_seed(0))
    convert.load_partial(pd, convert.pigan_d_state_dict(params))
    n_out = 259 if encoder else 1
    w = np.random.default_rng(1).standard_normal((2, n_out)).astype(np.float32)

    def jloss(p, xx):
        outs = [o for o in jd.apply(p, xx, alpha) if o is not None]
        return jnp.sum(jnp.concatenate(outs, -1) * w), outs

    (_, ref), (gp, gx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        params, x)
    xt = t(x).requires_grad_(True)
    outs = [o for o in pd(xt, alpha) if o is not None]
    assert len(outs) == (3 if encoder else 1)
    for a, b in zip(outs, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **FWD)
    grads = torch.autograd.grad((torch.cat(outs, -1) * t(w)).sum(),
                                list(pd.parameters()) + [xt], allow_unused=True)
    _check_grads(pd, grads[:-1], convert.pigan_d_state_dict(tree_np(gp)))
    assert _grad_err(grads[-1].numpy(), gx) < 3e-4


@pytest.mark.parametrize("n", [1, 3, 7, 28])
def test_topk_logit_loss_matches_jax(n):
    """Over steps where k falls from n to topk_v * n, with ties among the
    logits."""
    logits = np.round(np.random.default_rng(n).standard_normal((n, 1)), 1).astype(np.float32)
    for step in (0, 1, 150, 999, 2000, 10000, 40000, 10 ** 6):
        for interval, v in ((2000, 0.6), (1000, 0.5)):
            ref = jax_step.topk_logit_loss(jnp.asarray(logits), jnp.asarray(step, jnp.int32),
                                           interval, v)
            got = port_step.topk_logit_loss(t(logits), step, interval, v)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                       err_msg=f"step {step}")


def test_identity_penalty_matches_jax():
    rng = np.random.default_rng(5)
    lat, z = rng.standard_normal((2, 4, 8)).astype(np.float32)
    pos, py = rng.standard_normal((2, 4, 2)).astype(np.float32)
    for zl, pl in ((0.0, 15.0), (1.0, 0.0), (0.5, 2.0), (0.0, 0.0)):
        ref = jax_step.identity_penalty(jnp.asarray(lat), jnp.asarray(pos), jnp.asarray(z),
                                        jnp.asarray(py), zl, pl)
        got = port_step.identity_penalty(t(lat), t(pos), t(z), t(py), zl, pl)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    assert port_step.identity_penalty(None, None, t(z), t(py), 1.0, 1.0) == 0.0


def test_generator_and_discriminator_round_trip_through_the_jax_layout(tmp_path, jax_g):
    """pi-GAN G and D (the port's 8 blocks) through snapshots the JAX
    package's CheckpointManager reads into its own refs (an r8 D holds two
    blocks), and back: bit for bit."""
    g = pp.ImplicitGenerator3d(z_dim=16, hidden_dim=16, generator=torch.Generator().manual_seed(1))
    d = pp.ProgressiveDiscriminator(True, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():   # biases away from their zero init
        for p in d.parameters():
            p.add_(0.01)
    mods = {"generator": convert.pigan_tree_from_state_dict(g.state_dict()),
            "discriminator": convert.pigan_d_tree_from_state_dict(d.state_dict())}
    CheckpointManager(str(tmp_path)).save_snapshot("best_fid", mods)
    jd = jp.ProgressiveDiscriminator(predict_encodings=True)
    dref = jd.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, IMG, IMG)), 1.0)
    loaded = JaxManager(str(tmp_path)).load_snapshot("best_fid", {"generator": jax_g[1],
                                                                  "discriminator": dref})
    for sd, ref in ((convert.pigan_state_dict(tree_np(loaded["generator"])), g.state_dict()),
                    (convert.pigan_d_state_dict(tree_np(loaded["discriminator"])),
                     d.state_dict())):
        for k, v in sd.items():
            np.testing.assert_array_equal(v, ref[k].numpy(), err_msg=k)
    assert {k.split(".")[1] for k in convert.pigan_d_state_dict(
        tree_np(loaded["discriminator"])) if k.startswith("layers.")} == {"6", "7"}
    back = CheckpointManager(str(tmp_path)).load_snapshot("best_fid", ("generator",
                                                                      "discriminator"))
    g2 = _port_g(back["generator"], z_dim=16, hidden_dim=16)
    d2 = pp.ProgressiveDiscriminator(True)
    convert.load_partial(d2, convert.pigan_d_state_dict(back["discriminator"]))
    for a, b in ((g, g2), (d, d2)):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), k
    with pytest.raises(KeyError):
        convert.load_partial(pp.ProgressiveDiscriminator(False),
                             convert.pigan_d_state_dict(back["discriminator"]))


# ---------------------------------------------------------------- the step

def _step_draws(key, opts):
    k_d, k_z, k_g = jax.random.split(key, 3)
    kz, kg = jax.random.split(k_d)
    d = port_step.PiGANPhaseDraws(t(jax.random.normal(kz, (BATCH, 256))),
                                  forward_draws(kg, BATCH, opts))
    g = port_step.PiGANPhaseDraws(t(jax.random.normal(k_z, (BATCH, 256))),
                                  forward_draws(k_g, BATCH, opts))
    return port_step.PiGANStepDraws(d, g)


@pytest.mark.parametrize("encoder,tkw", [
    (True, dict(r1_lambda=0.2, pos_lambda=15.0, z_lambda=1.0, topk_v=0.6)),
    (False, dict(r1_lambda=10.0, topk_v=0.0, nerf_noise_disable=True, warmup_d=True,
                 fade_steps=2)),
], ids=["encoder-topk-identity-noise1", "plain-mean-r1-nonoise"])
def test_pigan_step_matches_jax(monkeypatch, encoder, tkw):
    """Losses, the clipped grads of D and G, the parameters after Adam and
    the EMA (z_dim 256, so that the latent head is compared too)."""
    jg, jd = (jp.ImplicitGenerator3d(z_dim=256, hidden_dim=16),
              jp.ProgressiveDiscriminator(predict_encodings=encoder))
    cfg_kw = dict(img_size=IMG, batch_size=BATCH, grad_points=None, ema_start_itr=0,
                  train_aux_img=False, **tkw)
    jopts = JaxOptions(img_size=IMG, num_steps=S)
    jstate = tree_np(jax_step.init_pigan_state(jax.random.PRNGKey(0), jg, jd,
                                               jax_step.PiGANTrainConfig(**cfg_kw), jopts))
    real = np.random.default_rng(1).uniform(-1, 1, (BATCH, 3, IMG, IMG)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    jseen = _capture(monkeypatch, jax_step, jax_clip)
    jfn = jax_step.make_pigan_train_step(jg, jd, jax_step.PiGANTrainConfig(**cfg_kw), jopts)

    def run(state, x, k):
        jseen.clear()
        new, metrics = jfn(state, x, k)
        return new, metrics, list(jseen)

    jnew, jm, jseen = jax.jit(run)(jstate, jnp.asarray(real), key)

    gen = _port_g(jstate.g_params, z_dim=256, hidden_dim=16)
    disc = pp.ProgressiveDiscriminator(encoder)
    convert.load_partial(disc, convert.pigan_d_state_dict(jstate.d_params))
    cfg = port_step.PiGANTrainConfig(**cfg_kw)
    state = port_step.init_pigan_state(gen, disc, cfg)
    pseen = _capture(monkeypatch, port_step, clip_and_guard)
    opts = RenderOptions(img_size=IMG, num_steps=S)
    fn = port_step.make_pigan_train_step(gen, disc, cfg, opts)
    state, m = fn(state, t(real), draws=_step_draws(key, opts))
    assert state.step == 1 and set(m) == set(jm)
    for k in ("d_loss", "g_loss", "grad_penalty", "identity_penalty"):
        np.testing.assert_allclose(m[k], float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    for k in ("d_total_norm", "g_total_norm"):
        np.testing.assert_allclose(m[k], float(jm[k]), rtol=3e-4, err_msg=k)
    assert m["d_finite"] == m["g_finite"] == 1.0
    _check_grads(disc, pseen[0], convert.pigan_d_state_dict(tree_np(jseen[0])))
    _check_grads(gen, pseen[1], convert.pigan_state_dict(tree_np(jseen[1])))
    for lr, mod, ref in ((cfg.disc_lr, disc, convert.pigan_d_state_dict(jnew.d_params)),
                         (cfg.gen_lr, gen, convert.pigan_state_dict(jnew.g_params)),
                         (cfg.gen_lr, state.ema, convert.pigan_state_dict(jnew.ema_params))):
        sd = mod.state_dict()
        share = np.mean([_close_share(sd[k].numpy(), ref[k], 2e-2 * lr) for k in ref])
        assert share <= 1e-3, share


# ---------------------------------------------------------------- the pipeline and the CLI

def test_pigan_pipeline_runs_resumes_and_trades_snapshots_with_jax(tmp_path):
    """Two debug steps of `PiGANPipeline` on the CPU: eval, snapshots, an
    exact resume, the JAX package reading the resume tree into its
    pipeline's refs (its r8 D: two of the port's eight blocks), and the
    port resuming a JAX resume tree."""
    from cips3d_tpu.train.variant_loop import PiGANPipeline as JaxPipeline
    from cips3d_tpu_torch.data.synthetic import make_blob_dataset
    from cips3d_tpu_torch.train.variant_loop import PiGANPipeline
    from test_torch_curriculum import trade_snapshots

    data = make_blob_dataset(str(tmp_path / "d.zip"), 6, img_size=8, seed=1)
    tkw = dict(img_size=IMG, batch_size=BATCH, r1_lambda=0.2, pos_lambda=15.0,
               train_aux_img=False, total_iters=2, ema_start_itr=1)

    def make_port():
        return PiGANPipeline(dict(z_dim=16, hidden_dim=16), dict(predict_encodings=True),
                             port_step.PiGANTrainConfig(**tkw),
                             RenderOptions(img_size=IMG, num_steps=S))

    jpipe = JaxPipeline(jp.ImplicitGenerator3d(z_dim=16, hidden_dim=16),
                        jp.ProgressiveDiscriminator(predict_encodings=True),
                        jax_step.PiGANTrainConfig(**tkw), JaxOptions(img_size=IMG, num_steps=S))
    jstate = jpipe.init_state(jax.random.PRNGKey(0))
    first, read = trade_snapshots(tmp_path, data, make_port, jpipe, jstate)
    assert "train.identity_penalty.identity_penalty.log" in os.listdir(tmp_path / "run" /
                                                                       "textdir")
    got = convert.pigan_d_state_dict(tree_np(read["discriminator"]))
    sd = first.discriminator.state_dict()
    for k, v in got.items():
        np.testing.assert_array_equal(v, sd[k].numpy(), err_msg=k)


def test_cli_trains_pigan_r32_on_the_cpu(tmp_path, capsys, monkeypatch):
    """`configs/pigan.yaml train_r32 --debug --device cpu` at tiny widths:
    step and FID lines, JAX-layout snapshots."""
    from cips3d_tpu_torch.data.synthetic import make_blob_dataset
    from cips3d_tpu_torch.train import cli

    monkeypatch.chdir(tmp_path)
    make_blob_dataset("d.zip", 8, img_size=16, seed=0)
    assert cli.main(["--config", os.path.join(ROOT, "configs", "pigan.yaml"), "--command",
                     "train_r32", "--debug", "--device", "cpu", "--opts", "img_size", "8",
                     "batch_size", "2", "fixed_z_bs", "2", "eval_batch_size", "4",
                     "num_workers", "1", "render.num_steps", "3", "generator.z_dim", "16",
                     "generator.hidden_dim", "16", "data_path", "d.zip"]) == 0
    out = capsys.readouterr().out
    assert "step 2: d_loss=" in out and "FID_surrogate=" in out
    best = tmp_path / "results" / "pigan" / "train_r32" / "ckptdir" / "best_fid"
    assert "['params']['siren']['film_0']['layer']['kernel']" in np.load(
        best / "G_ema.npz").files
    assert "['params']['block_7']['conv1']['weight']" in np.load(
        best / "discriminator.npz").files
