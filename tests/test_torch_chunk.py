"""Chunked dispatch (`cips3d_tpu_torch/train/chunk.py`) and the step's
device-side counter, schedules, EMA gate and noise operand, on the CPU at
tiny widths.

  * the device schedules and the EMA gate against the JAX package's traced
    forms (an int32 step under jit, as the JAX step traces ``state.step``),
    bit for bit;
  * a chunk of 3 steps against 3 single steps of the port (flagship,
    diffcam, pi-GAN), bit for bit in every state tensor and metric, from
    step 4999 with ``ema_start_itr`` 5000, so that the noise reaches 0 and
    the EMA switches on inside the chunk; the chunk follows a `warm_up`
    (one step, then the state and the generator put back), as a captured
    chunk's does on the card;
  * each step with a batch stacked from HWC images (the loader's
    channels-last strides) against its contiguous copy, bit for bit: the
    loop's eager steps take the former, a chunk's input buffer the latter;
  * JAX's step in a ``lax.scan`` of 2 steps against the port's chunk of 2
    fed the same draws (tests/test_torch_train.py's draws and tolerances:
    losses rtol 1e-4, norms rtol 3e-4, parameters within 2e-2 * lr on all
    but 0.1 % of elements);
  * the loop with ``dispatch_chunk`` 2, the counterpart of
    tests/test_loop.py::test_chunked_dispatch;
  * the ray tile's plain version with the noise as a 0-d tensor against its
    float form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cips3d_tpu.train.step as jax_step
from cips3d_tpu.core.ema import ema_update as jax_ema_update
from cips3d_tpu.models.discriminator import DiscriminatorMultiScaleAux as JaxD
from cips3d_tpu.models.generator import GeneratorConfig as JaxConfig
from cips3d_tpu.models.generator import GeneratorNerfINR as JaxG
from cips3d_tpu.models.generator import RenderOptions as JaxOptions
from cips3d_tpu.train import schedules as jax_schedules
from cips3d_tpu.train.state import TrainConfig as JaxTrainConfig
from cips3d_tpu_torch.core.ema import ema_update
from cips3d_tpu_torch.models.camera import CamParams
from cips3d_tpu_torch.models.discriminator import DiscriminatorMultiScaleAux
from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR, RenderOptions
from cips3d_tpu_torch.models.generator_diffcam import GeneratorDiffcam, NerfKwargs
from cips3d_tpu_torch.models.pigan import ImplicitGenerator3d, ProgressiveDiscriminator
from cips3d_tpu_torch.ops import ray_tile
from cips3d_tpu_torch.train import schedules
from cips3d_tpu_torch.train.chunk import make_chunk_fn, state_tensors, warm_up
from cips3d_tpu_torch.train.diffcam_step import (DiffcamTrainConfig, init_diffcam_state,
                                                 make_diffcam_train_step)
from cips3d_tpu_torch.train.pigan_step import (PiGANTrainConfig, init_pigan_state,
                                               make_pigan_train_step)
from cips3d_tpu_torch.train.state import TrainConfig
from cips3d_tpu_torch.train.step import init_train_state, make_train_step
from cips3d_tpu_torch.utils.convert import (discriminator_state_dict, load_jax_train_state,
                                            state_dict_from_jax)
from test_torch_train import BATCH, GCFG, IMG, STEPS, TINY, _close_share, _step_draws


# ---------------------------------------------------------------- (a) schedules, EMA gate

@pytest.mark.parametrize("warmup_d,disable", [(False, False), (True, False), (False, True),
                                              (True, True)])
def test_device_schedules_and_ema_gate_match_jax(warmup_d, disable):
    """nerf_noise, alpha and the EMA gate at steps 0, 1, 4999, 5000, 5001
    and 10000, from an int32 step tensor as the step reads it, bit for bit
    against JAX's traced forms."""
    fade = 10000

    @jax.jit
    def jax_fns(step, e, p):
        return (jax_schedules.nerf_noise_schedule(step, disable),
                jax_schedules.alpha_schedule(step, warmup_d, fade),
                jax_ema_update({"w": e}, {"w": p}, step, 0.999, 5000)["w"])

    rng = np.random.default_rng(0)
    e0 = rng.standard_normal((3, 5)).astype(np.float32)
    p0 = rng.standard_normal((3, 5)).astype(np.float32)
    for step in (0, 1, 4999, 5000, 5001, 10000):
        jn, ja, je = (np.asarray(x) for x in jax_fns(jnp.int32(step), e0, p0))
        st = torch.tensor(step, dtype=torch.int32)
        noise = schedules.nerf_noise_schedule(st, disable)
        alpha = schedules.alpha_schedule(st, warmup_d, fade)
        assert noise.dtype == alpha.dtype == torch.float32 and noise.ndim == alpha.ndim == 0
        np.testing.assert_array_equal(noise.numpy(), jn, err_msg=f"noise at {step}")
        np.testing.assert_array_equal(alpha.numpy(), ja, err_msg=f"alpha at {step}")
        ema, src = torch.nn.Linear(5, 3, bias=False), torch.nn.Linear(5, 3, bias=False)
        with torch.no_grad():
            ema.weight.copy_(torch.from_numpy(e0))
            src.weight.copy_(torch.from_numpy(p0))
        ema_update(ema, src, st, 0.999, 5000)
        np.testing.assert_array_equal(ema.weight.detach().numpy(), je, err_msg=f"ema at {step}")
        assert np.array_equal(je, e0) == (step < 5000)


# ---------------------------------------------------------------- (b) chunk vs single steps

def _flagship(seed):
    gen = GeneratorNerfINR(GeneratorConfig(**GCFG, fast_sin=True),
                           generator=torch.Generator().manual_seed(seed))
    disc = DiscriminatorMultiScaleAux(max_size=16, channels_override=TINY,
                                      generator=torch.Generator().manual_seed(seed + 1))
    cfg = TrainConfig(img_size=IMG, batch_size=BATCH, grad_points=2, ema_start_itr=5000)
    return init_train_state(gen, disc, cfg), lambda st: make_train_step(
        st.generator, st.discriminator, cfg, RenderOptions(num_steps=STEPS), aux_reg=True)


def _diffcam(seed):
    gen = GeneratorDiffcam(GeneratorConfig(**GCFG), generator=torch.Generator().manual_seed(seed))
    disc = DiscriminatorMultiScaleAux(max_size=16, channels_override=TINY,
                                      generator=torch.Generator().manual_seed(seed + 1))
    cfg = DiffcamTrainConfig(img_size=IMG, batch_size=BATCH, ema_start_itr=5000)
    state = init_diffcam_state(gen, disc, CamParams(H0=IMG, W0=IMG), cfg)
    return state, lambda st: make_diffcam_train_step(
        st.generator, st.discriminator, st.camera, cfg, NerfKwargs(n_samples=3, n_importance=3),
        aux_reg=True)


def _pigan(seed):
    gen = ImplicitGenerator3d(z_dim=16, hidden_dim=16, generator=torch.Generator().manual_seed(seed))
    disc = ProgressiveDiscriminator(generator=torch.Generator().manual_seed(seed + 1))
    cfg = PiGANTrainConfig(img_size=IMG, batch_size=BATCH, ema_start_itr=5000,
                           train_aux_img=False)
    return init_pigan_state(gen, disc, cfg), lambda st: make_pigan_train_step(
        st.generator, st.discriminator, cfg, RenderOptions(img_size=IMG, num_steps=3))


@pytest.mark.parametrize("build", [_flagship, _diffcam, _pigan],
                         ids=["flagship", "diffcam", "pigan"])
def test_chunk_is_single_steps_bit_for_bit(build):
    """Steps 4999-5001 as a chunk of 3 (after a warm-up that puts the state
    back) and as 3 single steps, from the same state and generator."""
    reals = [np.random.default_rng(i).integers(0, 256, (BATCH, 3, IMG, IMG), np.uint8)
             for i in range(3)]
    states, rows = [], []
    for chunked in (False, True):
        state, make = build(0)
        state.step = 4999
        ema0 = [p.detach().clone() for p in state.ema.parameters()]
        step_fn = make(state)
        rng = torch.Generator().manual_seed(7)
        if chunked:
            warm_up(step_fn, state, torch.from_numpy(reals[0]), rng)
            assert state.step == int(state.step_t) == 4999
            got = make_chunk_fn(step_fn, state, reals[0].shape, rng)(reals).read()
        else:
            got = []
            for r in reals:
                _, m = step_fn(state, torch.from_numpy(r), rng=rng)
                got.append({k: float(v) for k, v in m.items()})
        assert state.step == int(state.step_t) == 5002
        # the EMA was frozen at step 4999 and moved from step 5000 on
        assert any(not torch.equal(a, b) for a, b in zip(ema0, state.ema.parameters()))
        states.append([t.detach().clone() for t in state_tensors(state)])
        rows.append(got)
    assert rows[0] == rows[1]
    if "nerf_noise" in rows[0][0]:
        # (as XLA rounds JAX's schedule, the noise is still 2.5e-8 at step 5000)
        want = [float(schedules.nerf_noise_schedule(torch.tensor(i, dtype=torch.int32)))
                for i in (4999, 5000, 5001)]
        assert [r["nerf_noise"] for r in rows[0]] == want and want[0] > want[1] > want[2] == 0
    assert len(states[0]) == len(states[1])
    for a, b in zip(*states):
        assert torch.equal(a, b)


@pytest.mark.parametrize("build", [_flagship, _diffcam, _pigan],
                         ids=["flagship", "diffcam", "pigan"])
def test_step_ignores_the_batch_layout(build):
    """A batch stacked from HWC images (the loader's: channels-last strides)
    and its contiguous copy give the same step bit for bit, as a chunk's
    input buffer (contiguous) gives the loop's eager step."""
    hwc = np.random.default_rng(3).integers(0, 256, (BATCH, IMG, IMG, 3), np.uint8)
    strided = np.stack([im.transpose(2, 0, 1) for im in hwc])
    assert not strided.flags["C_CONTIGUOUS"]
    out = []
    for real in (strided, np.ascontiguousarray(strided)):
        state, make = build(0)
        _, m = make(state)(state, torch.from_numpy(real), rng=torch.Generator().manual_seed(7))
        out.append(([t.detach().clone() for t in state_tensors(state)],
                    {k: float(v) for k, v in m.items()}))
    assert out[0][1] == out[1][1]
    for a, b in zip(out[0][0], out[1][0]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- (c) JAX's scan vs a chunk

def test_chunk_matches_jax_scan():
    """JAX's make_train_step in a lax.scan of 2 steps (from step 0, the EMA
    on from step 1) against the port's chunk of 2 fed the same draws: the
    unfused generator with aux, R1 and a grad_points subset, density noise
    on (no Pallas kernel, so that JAX compiles quickly)."""
    tkw = dict(img_size=IMG, batch_size=BATCH, grad_points=2, ema_start_itr=1,
               fused_dphase_inr=False)
    jcfg = JaxConfig(**GCFG)
    jgen, jdisc = JaxG(cfg=jcfg), JaxD(max_size=16, channels_override=TINY)
    jopts = JaxOptions(img_size=IMG, num_steps=STEPS)
    jstate = jax.tree_util.tree_map(np.asarray, jax_step.init_train_state(
        jax.random.PRNGKey(0), jgen, jdisc, JaxTrainConfig(**tkw), jopts))
    raw = jax_step.make_train_step(jgen, jdisc, JaxTrainConfig(**tkw), jopts, aux_reg=True)
    reals = np.random.default_rng(1).uniform(-1, 1, (2, BATCH, 3, IMG, IMG)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(2), 2)

    @jax.jit
    def scan(state, xs, ks):
        return jax.lax.scan(lambda c, inp: raw(c, *inp), state, (xs, ks))

    jnew, jm = scan(jstate, jnp.asarray(reals), keys)

    gen = GeneratorNerfINR(GeneratorConfig(**GCFG))
    disc = DiscriminatorMultiScaleAux(max_size=16, channels_override=TINY)
    state = init_train_state(gen, disc, TrainConfig(**tkw))
    load_jax_train_state(state, jstate.g_params, jstate.d_params, jstate.ema_params, 0)
    fn = make_train_step(gen, disc, TrainConfig(**tkw), RenderOptions(num_steps=STEPS),
                         aux_reg=True)
    draws = [_step_draws(k, jcfg, 1, 4) for k in keys]
    rows = make_chunk_fn(fn, state, reals.shape[1:], None)(
        [torch.from_numpy(r) for r in reals], draws=draws).read()
    assert state.step == 2 and set(rows[0]) == set(jm)
    for j, m in enumerate(rows):
        for k in ("d_loss", "g_loss", "grad_penalty", "d_logits_real", "d_logits_fake"):
            np.testing.assert_allclose(m[k], float(jm[k][j]), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{k} step {j}")
        for k in ("d_total_norm", "g_total_norm", "d_w_norm"):
            np.testing.assert_allclose(m[k], float(jm[k][j]), rtol=3e-4, err_msg=f"{k} step {j}")
        for k in ("alpha", "nerf_noise", "d_finite", "g_finite"):
            assert m[k] == float(jm[k][j]), (k, j)
    for lr, mod, ref in ((TrainConfig().disc_lr, disc, discriminator_state_dict(jnew.d_params)),
                         (TrainConfig().gen_lr, gen, state_dict_from_jax(jnew.g_params)),
                         (TrainConfig().gen_lr, state.ema, state_dict_from_jax(jnew.ema_params))):
        sd = mod.state_dict()
        share = np.mean([_close_share(sd[k].numpy(), ref[k], 2e-2 * lr) for k in ref
                         if ".norm." not in k])
        assert share <= 1e-3, share


# ---------------------------------------------------------------- (d) the loop

def test_loop_chunked_dispatch(tmp_path, monkeypatch):
    """dispatch_chunk 2, eval_every 4, 4 steps: step 0 alone (the step-0
    eval), steps 1-2 one chunk, step 3 a chunk of 1 (no chunk straddles the
    eval after step 4); every step logged; the run ends at step 4."""
    import cips3d_tpu_torch.train.loop as loop_mod
    from cips3d_tpu_torch.data.synthetic import make_blob_dataset

    chunks = []
    real_make = loop_mod.make_chunk_fn

    def spy(*args, **kw):
        run = real_make(*args, **kw)

        def counted(reals, draws=None):
            chunks.append((run.state.step, len(reals)))
            return run(reals, draws)

        counted.captured, counted.close = run.captured, run.close
        return counted

    monkeypatch.setattr(loop_mod, "make_chunk_fn", spy)
    data = make_blob_dataset(str(tmp_path / "d.zip"), 6, img_size=8, seed=1)
    outdir = tmp_path / "run"
    lcfg = loop_mod.LoopConfig(outdir=str(outdir), data_path=data, log_every=1, eval_every=4,
                               num_images_real_eval=4, num_images_gen_eval=4, eval_batch_size=2,
                               fixed_z_bs=2, num_workers=1, dispatch_chunk=2, device="cpu")
    tcfg = TrainConfig(img_size=8, batch_size=1, grad_points=None, forward_points=None,
                       total_iters=4, ema_start_itr=1)
    state = loop_mod.train(GeneratorConfig(**GCFG), tcfg, RenderOptions(num_steps=3), lcfg,
                           disc_kwargs=dict(max_size=16, channels_override=TINY))
    assert state.step == int(state.step_t) == 4
    assert chunks == [(0, 1), (1, 2), (3, 1)]
    with open(outdir / "textdir" / "train.d_loss.d_loss.log") as f:
        steps = [int(line.split(":")[0]) for line in f if line.strip()]
    assert steps == [1, 2, 3, 4]


# ---------------------------------------------------------------- (e) the noise operand

@pytest.mark.parametrize("noise", [0.5, 0.0])
def test_ray_tile_plain_noise_tensor_matches_float(noise):
    """The plain forward and backward with the noise as a 0-d float32
    tensor (always applied, as a traced noise is) equal their float form (a
    literal 0 skips the noise; adding nc * 0 is exact)."""
    g = torch.Generator().manual_seed(0)
    b, n, S, H = 1, 16, 4, 16
    wt = ([torch.randn(3, H, generator=g), torch.randn(1, H, generator=g),
           30 + torch.randn(b, H, generator=g), torch.randn(b, H, generator=g),
           torch.randn(H, H, generator=g) / 4, torch.randn(1, H, generator=g),
           30 + torch.randn(b, H, generator=g), torch.randn(b, H, generator=g)]
          + [torch.randn(H, 16, generator=g) / 4, torch.randn(1, 16, generator=g),
             30 + torch.randn(b, 16, generator=g), torch.randn(b, 16, generator=g),
             torch.randn(16, 16, generator=g) / 4, torch.randn(1, 16, generator=g),
             torch.randn(H, 1, generator=g) / 4, torch.randn(1, generator=g)])
    org = torch.zeros(b, n, 3)
    dirs = torch.nn.functional.normalize(torch.randn(b, n, 3, generator=g), dim=-1)
    z = torch.linspace(0.88, 1.12, S).expand(b, n, S).contiguous()
    pts = org[:, :, None] + dirs[:, :, None] * z[..., None]
    draws = ray_tile.draw_ray_randoms(b, n, S, True, g, "cpu")
    args = (wt, pts, org, dirs, z, *draws)
    as_tensor = torch.tensor(noise, dtype=torch.float32)
    for a, b_ in zip(ray_tile.ray_tile_plain(*args, as_tensor),
                     ray_tile.ray_tile_plain(*args, noise)):
        assert torch.equal(a, b_)
    d_fea, d_dep = torch.randn(b, n, 16, generator=g), torch.randn(b, n, 1, generator=g)
    (ga, pa), (gb, pb) = (ray_tile.ray_tile_bwd_plain(*args, ns, d_fea, d_dep)
                          for ns in (as_tensor, noise))
    assert torch.equal(pa, pb) and all(torch.equal(x, y) for x, y in zip(ga, gb))
    assert ray_tile.uses_noise(as_tensor) and ray_tile.uses_noise(noise) == (noise != 0)
