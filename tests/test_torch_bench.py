"""The benches' bf16 path (`cips3d_tpu_torch/bench/`) against the JAX
package at tiny widths: the bf16 generator forward, the bf16 discriminator
with R1 and one bf16 training step of each bench leg, then the two benches'
``main`` on the CPU.

bf16 rounding in two libraries cannot agree element for element, so every
bf16 check carries a witness: the port's bf16 result may be at most
``RATIO`` = 2 times as far from JAX's bf16 result as JAX's bf16 result is
from JAX's f32 result on the same parameters and draws, plus ``ATOL`` =
1e-6; per tensor, as max abs error, and for gradients as the normalised
error max|a-b| / (max|b| + 1).  The port's f32 result against JAX's f32
result is the control in the same test (forward rtol 1e-4 / atol 1e-5,
losses rtol 1e-4, grads normalised 3e-4, parameters as
`tests/test_torch_train.py`).

Measured here (CPU): the forward's port-vs-JAX bf16 distance is 0.3-0.6 of
the witness on the unfused stage, where one bf16 ulp of a style (the two
libraries' matmuls round ties apart) is amplified by the SIREN's 30x sine
gain, and about 0.01 of it on the fused paths, whose sines, resample and
compositing run in f32 (before the FiLM gains were computed in f32 as JAX
computes them, the fused forward stood at 0.4 of its witness).  The step
runs without density noise: JAX draws the noise in the compute dtype, so
with noise its bf16 and f32 steps would see different draws and the
witness would measure the draws, not the rounding.  The forward cases run
with noise 1.0, the bench's at step 0, on JAX's bf16 draws.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cips3d_tpu.train.step as jax_step
import cips3d_tpu_torch.train.step as port_step
from cips3d_tpu.models.discriminator import DiscriminatorMultiScaleAux as JaxD
from cips3d_tpu.models.generator import GeneratorConfig as JaxConfig
from cips3d_tpu.models.generator import GeneratorNerfINR as JaxG
from cips3d_tpu.models.generator import RenderOptions as JaxOptions
from cips3d_tpu.models.generator import sample_zs as jax_sample_zs
from cips3d_tpu.ops.pallas.ray_tile import fused_ray_render as jax_fused_ray_render
from cips3d_tpu.train import losses as jax_losses
from cips3d_tpu.train.state import TrainConfig as JaxTrainConfig
from cips3d_tpu.train.state import clip_and_guard as jax_clip
from cips3d_tpu_torch.bench import inference as bench_inference
from cips3d_tpu_torch.bench import train as bench_train
from cips3d_tpu_torch.models.discriminator import DiscriminatorMultiScaleAux
from cips3d_tpu_torch.models.generator import (ForwardDraws, GeneratorConfig, GeneratorNerfINR,
                                               RenderOptions)
from cips3d_tpu_torch.ops.ray_tile import RayDraws, fused_ray_render
from cips3d_tpu_torch.train import losses
from cips3d_tpu_torch.train.state import TrainConfig, clip_and_guard
from cips3d_tpu_torch.train.step import init_train_state, make_train_step
from cips3d_tpu_torch.utils.convert import (discriminator_state_dict, load_jax_d_params,
                                            load_jax_params, load_jax_train_state,
                                            siren_state_dict, state_dict_from_jax)
from test_torch_ops import B as OPS_B
from test_torch_ops import N as OPS_N
from test_torch_ops import R as OPS_R
from test_torch_ops import S as OPS_S
from test_torch_ops import _jax_draws as ops_draws
from test_torch_ops import ray_setup  # noqa: F401  (the fixture)
from test_torch_train import BATCH, GCFG, IMG, STEPS, TINY, _capture, _grad_err, _step_draws

RATIO, ATOL = 2.0, 1e-6
ROUNDS = 0.25   # `_closer`: a bf16 result lies this many witnesses from JAX's f32 at least
KINKS = 2   # elements of a gradient or a parameter a kink may move (`_grad_witness`)
BF16 = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _max_err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _witness(name, port16, jax16, jax32):
    """The 2x rule on the max abs error."""
    d, w = _max_err(port16, jax16), _max_err(jax16, jax32)
    assert d <= RATIO * w + ATOL, f"{name}: port vs JAX bf16 {d:.3e}, witness {w:.3e}"


def _closer(name, port16, jax16, jax32, port32, nearer=True):
    """The rounding checks that the 2x rule cannot make (a result that
    skipped the bf16 rounding reads exactly 1x the witness), in mean abs
    error over all elements of the given tensors: the port's bf16 result
    lies at least ROUNDS x the witness away from JAX's f32 result (it
    rounds), and with ``nearer`` it lies nearer JAX's bf16 result than
    JAX's f32 result (it rounds where JAX rounds).  The control, the port's
    f32 result, must fail the first.

    Measured here, in witnesses (bf16 vs JAX's bf16 / vs JAX's f32): the
    forward 0.009-0.12 / 0.98-1.0 on the fused paths and at noise 1.0, 1.48
    / 1.74 on the unfused stage at noise 0; the D's logits 0.40 / 1.10 and
    its R1 grads 0.47 / 0.80; a step's D grads 0.45 / 1.12, the shipped
    leg's G grads 0.55 / 1.08.  The exact-sine leg's G grads read 0.95 /
    0.49 and are held by the first check only.  Two causes are known, the
    rest is open: JAX on the CPU sums a bf16 gradient over broadcast rows in
    bf16 (`jax.grad` of a bf16 bias add over 4096 rows of 0.0123 gives 48.75
    against 50.5), so its ToRGB and aux bias grads stray from f32 where the
    port, as the card, sums in f32; and the ray tile's bf16 backward on its
    own lies far nearer JAX's than JAX's f32
    (`test_ray_tile_bf16_backward_matches_jax`), so #2r and #3 round as JAX
    rounds."""
    def cat(xs):
        return np.concatenate([np.asarray(x, np.float64).ravel() for x in xs])

    p16, j16, j32, p32 = (cat(x) for x in (port16, jax16, jax32, port32))
    w = np.abs(j16 - j32).mean()
    near, far, ctrl = (np.abs(a - b).mean() for a, b in ((p16, j16), (p16, j32), (p32, j32)))
    print(f"{name}: bf16 vs JAX's bf16 {near / w:.3g}, vs JAX's f32 {far / w:.3g}; f32 control "
          f"vs JAX's f32 {ctrl / w:.3g} (in units of the witness {w:.3e})")
    assert far >= ROUNDS * w, f"{name}: the port's bf16 result does not round ({far / w:.3g})"
    assert not nearer or near < far, f"{name}: nearer JAX's f32 ({far / w:.3g}) than its bf16"
    assert ctrl < ROUNDS * w, f"{name}: the check does not tell an f32 result ({ctrl / w:.3g})"


def _grad_witness(name, port16, jax16, jax32):
    """The 2x rule on the normalised error, element by element: at most
    ``KINKS`` elements (or 2 % of the tensor) may lie beyond it.  A
    pre-activation within bf16 rounding of a leaky ReLU's or the density
    clamp's kink falls on either side in either library, and moves the
    gradient of its row by 0.8 or all of its upstream gradient; the
    elements it moves are that many outliers, not a rounding of every
    element that differs."""
    p16, j16, j32 = (np.asarray(x, np.float64) for x in (port16, jax16, jax32))
    w = _grad_err(j16, j32)
    outside = np.abs(p16 - j16) / (np.abs(j16).max() + 1.0) > RATIO * w + ATOL
    n = int(outside.sum())
    assert n <= max(KINKS, 0.02 * outside.size), (
        f"{name}: {n} of {outside.size} elements beyond {RATIO} x the witness {w:.3e} "
        f"(port vs JAX bf16 {_grad_err(p16, j16):.3e})")


def _adam_witness(name, port16, jax16, jax32, lr):
    """Parameters after the first Adam step (beta1 = 0: each moves by about
    +-lr, so a max abs error would only say whether any sign flipped): the
    elements further than 2e-2 lr from JAX's bf16 step, or from JAX's f32
    step, at most 2x as many as JAX's bf16 step has from its f32 step, plus
    ``KINKS``.  A gradient within rounding of zero takes either sign in
    either library; from the f32 step, both bf16 steps count the same
    rounding once, where from each other they count it twice."""
    def moved(a, b):
        return int((np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                    > 2e-2 * lr).sum())

    d, w = min(moved(port16, jax16), moved(port16, jax32)), moved(jax16, jax32)
    assert d <= RATIO * w + KINKS, f"{name}: {d} elements moved otherwise, witness {w}"


# ---------------------------------------------------------------- forward

def _ray_draws(key, b, n, jdt):
    """`fused_ray_render`'s draws (`ops/pallas/ray_tile.py:953-965`): the
    density noise in the compute dtype, as the unfused path draws it too."""
    k_pdf, k_nc, k_nf = jax.random.split(key, 3)
    u = jax.random.uniform(k_pdf, (b * n, STEPS), jnp.float32).reshape(b, n, STEPS)
    nc = jax.random.normal(k_nc, (b, n, STEPS, 1), jdt)[..., 0].astype(jnp.float32)
    nf = jax.random.normal(k_nf, (b, n, 2 * STEPS, 1), jdt)[..., 0].astype(jnp.float32)
    return RayDraws(t(u), t(nc), t(nf))


def _forward_draws(key, b, jdt):
    k_rays, k_pts = jax.random.split(key)
    k_perturb, k_cam = jax.random.split(k_rays)
    perturb = jax.random.uniform(k_perturb, (b, IMG * IMG, STEPS, 1), jnp.float32)
    k_theta, k_phi, _ = jax.random.split(k_cam, 3)
    camera = (t(jax.random.normal(k_theta, (b, 1))), t(jax.random.normal(k_phi, (b, 1))))
    return ForwardDraws(t(perturb), camera, _ray_draws(k_pts, b, IMG * IMG, jdt))


@functools.lru_cache(maxsize=None)
def _g_params():
    jcfg = JaxConfig(**GCFG)
    zs = jax_sample_zs(jax.random.PRNGKey(0), BATCH, jcfg)
    init = jax.jit(lambda k1, k2: JaxG(cfg=jcfg).init(k1, zs, k2,
                                                      JaxOptions(img_size=IMG, num_steps=STEPS)))
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(1), jax.random.PRNGKey(2)))


FORWARD_CASES = {
    # the shipped G phase; the shipped D phase (both kernels); the exact-sine G phase's forward
    "unfused-fast_sin": dict(fast_sin=True),
    "fused-fast_sin": dict(fast_sin=True, fused_ray=True, fused_inr=True),
    "fused-exact_sin": dict(fused_ray=True, fused_ray_vjp="pallas_residual"),
}


@pytest.mark.parametrize("noise", [0.0, 1.0])
@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_bf16_generator_forward_matches_jax(case, noise):
    """bf16 `GeneratorNerfINR` images and aux images against JAX's
    (`points_forward` through `__call__`; the Pallas kernels in interpret
    mode) on the same parameters and JAX's draws, with the witness; f32 as
    the control."""
    flags = FORWARD_CASES[case]
    jcfg = JaxConfig(**GCFG, **flags)
    zs = jax_sample_zs(jax.random.PRNGKey(0), BATCH, jcfg)
    params = _g_params()
    key = jax.random.PRNGKey(3)
    opts = dict(img_size=IMG, num_steps=STEPS, nerf_noise=noise)
    out = {}
    for name, (jdt, pdt) in BF16.items():
        fn = jax.jit(lambda p, dt=jdt: JaxG(cfg=jcfg, dtype=dt).apply(
            p, zs, key, JaxOptions(**opts), return_aux_img=True)[0].astype(jnp.float32))
        out["jax", name] = np.asarray(fn(params))
        port = GeneratorNerfINR(GeneratorConfig(**GCFG, **flags), dtype=pdt)
        load_jax_params(port, params)
        with torch.no_grad():
            img, _ = port({k: t(v) for k, v in zs.items()}, RenderOptions(**opts),
                          return_aux_img=True, draws=_forward_draws(key, BATCH, jdt))
        assert img.dtype == pdt
        out["port", name] = img.float().numpy()
    np.testing.assert_allclose(out["port", "f32"], out["jax", "f32"], rtol=1e-4, atol=1e-5)
    for part, rows in (("inr", slice(0, BATCH)), ("aux", slice(BATCH, 2 * BATCH))):
        _witness(f"{case} noise {noise} {part}", out["port", "bf16"][rows],
                 out["jax", "bf16"][rows], out["jax", "f32"][rows])
    _closer(f"{case} noise {noise}", *([out[k]] for k in (
        ("port", "bf16"), ("jax", "bf16"), ("jax", "f32"), ("port", "f32"))))


@pytest.mark.parametrize("impl", ["pallas_residual", "pallas"])
def test_ray_tile_bf16_backward_matches_jax(ray_setup, impl):
    """The ray tile's bf16 backward on its own (the plain versions of #2r
    and #3 residual, or #3 recompute) against `jax.grad` of the Pallas
    `fused_ray_render` in bf16 (interpret mode), under random cotangents of
    the feature and the depth: every SIREN and style grad within the
    witness, and nearer JAX's bf16 grads than its f32 ones (measured: 1600
    times nearer over all grads); f32 as the control."""
    pts, origins, dirs, z = ray_setup["arrays"]
    key = jax.random.PRNGKey(25)
    draws = ops_draws(key, OPS_B, OPS_N, OPS_S, False)
    rng = np.random.default_rng(7)
    cot_fea = rng.standard_normal((OPS_B, OPS_N, OPS_R)).astype(np.float32)
    cot_dep = rng.standard_normal((OPS_B, OPS_N, 1)).astype(np.float32)
    port = ray_setup["port"]
    out = {}
    for name, (jdt, pdt) in BF16.items():
        def loss(params, jstyles, jdt=jdt):
            fea, dep = jax_fused_ray_render(
                params, jstyles, jnp.asarray(pts), jnp.asarray(origins), jnp.asarray(dirs),
                jnp.asarray(z), key, tile=32, tile_bwd=128, vjp_impl=impl, dtype=jdt)
            return jnp.sum(fea.astype(jnp.float32) * cot_fea) + jnp.sum(dep * cot_dep)

        gp, gs = jax.grad(loss, argnums=(0, 1))(ray_setup["params"], ray_setup["jstyles"])
        jsd = siren_state_dict(jax.tree_util.tree_map(np.asarray, gp))
        styles = {k: t(v).requires_grad_() for k, v in ray_setup["styles"].items()}
        fea, dep = fused_ray_render(port, styles, t(pts), t(origins), t(dirs), t(z),
                                    draws=draws, vjp_impl=impl, dtype=pdt)
        assert fea.dtype == pdt
        names = [n for n, _ in port.named_parameters()]
        got = torch.autograd.grad((fea.float() * t(cot_fea)).sum() + (dep * t(cot_dep)).sum(),
                                  list(port.parameters()) + list(styles.values()))
        out["jax", name] = [np.asarray(jsd[n]) for n in names] + [np.asarray(gs[k])
                                                                  for k in styles]
        out["port", name] = [g.numpy() for g in got]
    for i, (p32, j32, p16, j16) in enumerate(zip(*(out[k] for k in (
            ("port", "f32"), ("jax", "f32"), ("port", "bf16"), ("jax", "bf16"))))):
        assert _grad_err(p32, j32) < 1e-4, i
        _grad_witness(f"{impl} grad {i}", p16, j16, j32)
    _closer(f"{impl} grads", *(out[k] for k in (
        ("port", "bf16"), ("jax", "bf16"), ("jax", "f32"), ("port", "f32"))))


# ---------------------------------------------------------------- discriminator + R1

def test_bf16_discriminator_r1_matches_jax():
    """The bf16 `DiscriminatorMultiScaleAux` (main and aux D) with R1: real
    and fake logits, the penalty, the D loss and every D-parameter grad of
    it against JAX's (`train/losses.py`: softplus on the bf16 logits, the R1
    sum of squares in f32), with the witness; f32 as the control."""
    size = 16
    jd32 = JaxD(max_size=size, channels_override=TINY)
    params = jax.tree_util.tree_map(np.asarray, jd32.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 3, 8, 8)), method=jd32.init_all))
    rng = np.random.default_rng(1)
    real = rng.uniform(-1, 1, (4, 3, size, size)).astype(np.float32)
    fake = rng.uniform(-1, 1, (4, 3, size, size)).astype(np.float32)
    res = {}
    for name, (jdt, pdt) in BF16.items():
        jd = JaxD(max_size=size, channels_override=TINY, dtype=jdt)

        def jloss(p):
            def apply(x):
                return jd.apply(p, x, use_aux_disc=True, fade_in=False)

            pen, rl = jax_losses.r1_penalty(apply, jnp.asarray(real), 10.0)
            fl = apply(jnp.asarray(fake))
            loss = jnp.mean(jax_losses.d_logistic_loss(rl, fl) + pen)
            return loss, (rl, fl, pen)

        (loss, (rl, fl, pen)), g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
        res["jax", name] = dict(loss=loss, real=rl, fake=fl, r1=pen,
                                grads=discriminator_state_dict(
                                    jax.tree_util.tree_map(np.asarray, g)))
        port = DiscriminatorMultiScaleAux(max_size=size, channels_override=TINY, dtype=pdt)
        load_jax_d_params(port, params)

        def apply(x):
            return port(x, use_aux_disc=True, fade_in=False)

        pen, rl = losses.r1_penalty(apply, t(real), 10.0)
        fl = apply(t(fake))
        assert rl.dtype == fl.dtype == pdt and pen.dtype == torch.float32
        loss = (losses.d_logistic_loss(rl, fl) + pen).mean()
        names = [n for n, _ in port.named_parameters()]
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
            port.parameters(), torch.autograd.grad(loss, list(port.parameters()),
                                                   allow_unused=True))]
        res["port", name] = dict(loss=loss, real=rl, fake=fl, r1=pen,
                                 grads=dict(zip(names, grads)))

    def np_(x):
        return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
            jnp.asarray(x).astype(jnp.float32))

    p32, j32, p16, j16 = (res[k] for k in (("port", "f32"), ("jax", "f32"), ("port", "bf16"),
                                           ("jax", "bf16")))
    for k in ("loss", "real", "fake", "r1"):
        np.testing.assert_allclose(np_(p32[k]), np_(j32[k]), rtol=1e-4, atol=1e-6, err_msg=k)
        _witness(k, np_(p16[k]), np_(j16[k]), np_(j32[k]))
    for n in p32["grads"]:
        assert _grad_err(np_(p32["grads"][n]), j32["grads"][n]) < 3e-4, n
        _grad_witness(f"grad {n}", np_(p16["grads"][n]), j16["grads"][n], j32["grads"][n])
    _closer("logits", *([np_(r["real"]), np_(r["fake"])] for r in (p16, j16, j32, p32)))
    _closer("D grads", *([np_(r["grads"][n]) for n in p32["grads"]] for r in (p16, j16, j32, p32)))


# ---------------------------------------------------------------- one bench step

STEP_CASES = {   # bench.py's two legs: the shipped config and the exact-sine alternate
    "shipped": dict(fast_sin=True, fused_ray=False),
    "exact_sin": dict(fast_sin=False, fused_ray=True, fused_ray_vjp="pallas_residual"),
}


@functools.lru_cache(maxsize=None)
def _steps(case):
    """One step of ``case`` in JAX and in the port, f32 and bf16, from the
    same initial state, real batch and draws: {(side, dtype): (metrics,
    [D grads, G grads] clipped, D params, G params after Adam)} in the
    port's state-dict names."""
    flags = STEP_CASES[case]
    jcfg = JaxConfig(**GCFG, **flags)
    tkw = dict(img_size=IMG, batch_size=BATCH, ema_start_itr=0, nerf_noise_disable=True)
    jopts = JaxOptions(img_size=IMG, num_steps=STEPS)
    real = np.random.default_rng(1).uniform(-1, 1, (BATCH, 3, IMG, IMG)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    draws = _step_draws(key, jcfg, 1, None)
    jstate0 = _jax_state0()
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for name, (jdt, pdt) in BF16.items():
            jseen = _capture(mp, jax_step, jax_clip)
            jfn = jax_step.make_train_step(JaxG(cfg=jcfg, dtype=jdt),
                                           JaxD(max_size=16, channels_override=TINY, dtype=jdt),
                                           JaxTrainConfig(**tkw), jopts, aux_reg=True)

            def run(state, x, k):
                jseen.clear()
                new, metrics = jfn(state, x, k)
                return new, metrics, list(jseen)

            jnew, jm, jg = jax.jit(run)(jstate0, jnp.asarray(real), key)
            jg = [discriminator_state_dict(jax.tree_util.tree_map(np.asarray, jg[0])),
                  state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jg[1]))]
            out["jax", name] = ({k: float(v) for k, v in jm.items()}, jg,
                                discriminator_state_dict(jnew.d_params),
                                state_dict_from_jax(jnew.g_params))

            gen = GeneratorNerfINR(GeneratorConfig(**GCFG, **flags), dtype=pdt)
            disc = DiscriminatorMultiScaleAux(max_size=16, channels_override=TINY, dtype=pdt)
            state = init_train_state(gen, disc, TrainConfig(**tkw))
            load_jax_train_state(state, jstate0.g_params, jstate0.d_params,
                                 jstate0.ema_params, int(jstate0.step))
            pseen = _capture(mp, port_step, clip_and_guard)
            fn = make_train_step(gen, disc, TrainConfig(**tkw),
                                 RenderOptions(img_size=IMG, num_steps=STEPS), aux_reg=True)
            state, m = fn(state, t(real), draws=draws)
            pg = [dict(zip([n for n, _ in mod.named_parameters()], [g.numpy() for g in seen]))
                  for mod, seen in ((disc, pseen[0]), (gen, pseen[1]))]
            out["port", name] = (m, pg, {k: v.numpy() for k, v in disc.state_dict().items()},
                                 {k: v.numpy() for k, v in gen.state_dict().items()})
    finally:
        mp.undo()
    return out


@functools.lru_cache(maxsize=None)
def _jax_state0():
    jcfg = JaxConfig(**GCFG, fused_ray=True)
    state = jax_step.init_train_state(
        jax.random.PRNGKey(0), JaxG(cfg=jcfg), JaxD(max_size=16, channels_override=TINY),
        JaxTrainConfig(img_size=IMG, batch_size=BATCH), JaxOptions(img_size=IMG, num_steps=STEPS))
    return jax.tree_util.tree_map(np.asarray, state)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_bf16_train_step_matches_jax(case):
    """One bf16 step of each bench leg (aux on, R1, r8 b = 2 at tiny
    widths) against JAX's `make_train_step` with the same dtype: losses,
    the clipped D and G grads (captured where each step clips them), and the
    parameters after Adam, each with the witness; the f32 step as the
    control.  The kernels' plain versions run here (the Pallas kernels in
    interpret mode on the JAX side): in the shipped leg #2 and #1 in the D
    phase, in the exact-sine leg #1 in the D phase and #2r and #3 (residual
    mode) in the G phase."""
    res = _steps(case)
    (m32, g32, d32, gp32), (jm32, jg32, jd32, jgp32) = res["port", "f32"], res["jax", "f32"]
    (m16, g16, d16, gp16), (jm16, jg16, jd16, jgp16) = res["port", "bf16"], res["jax", "bf16"]
    for k in ("d_loss", "g_loss", "grad_penalty", "d_logits_real", "d_logits_fake"):
        np.testing.assert_allclose(m32[k], jm32[k], rtol=1e-4, atol=1e-6, err_msg=k)
        _witness(k, m16[k], jm16[k], jm32[k])
    assert m16["d_finite"] == m16["g_finite"] == 1.0
    for phase in (0, 1):
        for name, g in g32[phase].items():
            if ".norm." in name:   # the reference's unused LayerNorm: no JAX parameter
                continue
            assert _grad_err(g, jg32[phase][name]) < 3e-4, name
            _grad_witness(f"grad {name}", g16[phase][name], jg16[phase][name],
                          jg32[phase][name])
    for phase in (0, 1):
        names = [n for n in g32[phase] if ".norm." not in n]
        # the exact-sine leg's G grads lie nearer JAX's f32 grads (`_closer`'s docstring)
        _closer(f"{case} {'DG'[phase]} grads", *([r[phase][n] for n in names]
                                                 for r in (g16, jg16, jg32, g32)),
                nearer=(case, phase) != ("exact_sin", 1))
    for lr, got32, ref32, got16, ref16 in ((TrainConfig().disc_lr, d32, jd32, d16, jd16),
                                           (TrainConfig().gen_lr, gp32, jgp32, gp16, jgp16)):
        for name in ref32:
            if ".norm." in name:
                continue
            # f32: at most 0.1 % of elements beyond 2e-2 lr (a sign flip of the first update)
            assert np.mean(np.abs(got32[name] - ref32[name]) > 2e-2 * lr) <= 1e-3, name
            _adam_witness(f"param {name}", got16[name], ref16[name], ref32[name], lr)


# ---------------------------------------------------------------- the benches' CLIs

JAX_TRAIN_KEYS = {"metric", "value", "unit", "vs_baseline", "exact_sin_imgs_per_sec",
                  "loader_imgs_per_sec"}   # bench.py:168-180
JAX_INFERENCE_KEYS = {"metric", "value", "unit", "vs_baseline", "xla_fps", "same_session"}


def _json_line(text):
    lines = [ln for ln in text.strip().splitlines() if ln.startswith("{")]
    assert len(lines) == 1, text
    return json.loads(lines[0])


def test_bench_build_is_bf16_with_f32_parameters():
    gen, disc, tcfg, opts = bench_train.build(True, gen_widths=bench_train.TINY_G,
                                              disc_channels=bench_train.TINY_D, device="cpu")
    assert gen.dtype == torch.bfloat16 and disc.main_disc.conv_in["64"].conv.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in (*gen.parameters(), *disc.parameters()))
    assert (tcfg.img_size, tcfg.batch_size, opts.img_size, opts.num_steps) == (64, 4, 64, 12)
    assert tcfg.fused_dphase is None and tcfg.fused_dphase_inr
    assert not gen.cfg.fused_ray and gen.cfg.fast_sin


def test_bench_train_main_on_the_cpu(tmp_path, monkeypatch, capsys):
    """`bench/train.py::main` at tiny widths, one step a call: one JSON line
    with `bench.py`'s keys and finite positive rates; the report holds each
    leg (no kernel launches on the CPU)."""
    from cips3d_tpu_torch.data.synthetic import make_blob_dataset

    data = str(tmp_path / "blobs.zip")
    make_blob_dataset(data, num_images=8, img_size=64, seed=1)
    monkeypatch.setenv("CIPS3D_BENCH_DATA", data)
    monkeypatch.setenv("BENCH_BATCH", "1")
    monkeypatch.delenv("BENCH_FAST_SIN", raising=False)
    report = tmp_path / "report.json"
    assert bench_train.main(["--device", "cpu", "--tiny", "--k", "1", "--calls", "1",
                             "--exact-calls", "1", "--loader-steps", "1",
                             "--report", str(report)]) == 0
    line = _json_line(capsys.readouterr().out)
    assert set(line) == JAX_TRAIN_KEYS and line["metric"] == "train_imgs_per_sec_per_chip_r64"
    # the line rounds as bench.py's does (the loader's rate to 0.1): a loaded CPU may print 0.0
    for k in ("value", "vs_baseline", "exact_sin_imgs_per_sec", "loader_imgs_per_sec"):
        assert np.isfinite(line[k]) and line[k] >= 0, k
    rep = json.loads(report.read_text())
    assert set(rep) == {"shipped", "exact_sin", "loader"}
    assert rep["shipped"]["steps"] == 2 and rep["shipped"]["launches"] == {}
    for leg in ("shipped", "exact_sin"):
        assert all(np.isfinite(r) and r > 0 for r in rep[leg]["rates"]), leg
    assert np.isfinite(rep["loader"]["images_per_sec"]) and rep["loader"]["images_per_sec"] > 0


def test_bench_train_fails_when_a_leg_raises(monkeypatch, capsys):
    """No swallowed failure: a leg that raises ends `main` with the error
    and no JSON line; as a process, a leg that cannot build exits non-zero."""
    real = bench_train.measure

    def measure(fast_sin, *a, **k):
        if not fast_sin:
            raise RuntimeError("exact-sine leg failed")
        return real(fast_sin, *a, **k)

    monkeypatch.setattr(bench_train, "measure", measure)
    monkeypatch.delenv("BENCH_FAST_SIN", raising=False)
    with pytest.raises(RuntimeError, match="exact-sine leg failed"):
        bench_train.main(["--device", "cpu", "--tiny", "--k", "1", "--calls", "1"])
    assert "{" not in capsys.readouterr().out
    env = dict(os.environ, BENCH_FUSED="1", BENCH_VJP="xla", PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-m", "cips3d_tpu_torch.bench.train", "--device", "cpu",
                        "--tiny"], capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert p.returncode != 0 and "fused_ray_vjp" in p.stderr and "{" not in p.stdout


def test_bench_inference_main_on_the_cpu(monkeypatch, capsys, tmp_path):
    """`bench/inference.py::main` with BENCH_AB at r16 x 4, 2 frames a call:
    one JSON line with `bench_inference.py`'s keys; a failing leg raises."""
    monkeypatch.setenv("BENCH_AB", "1")
    report = tmp_path / "report.json"
    assert bench_inference.main(["16", "4", "2", "--device", "cpu", "--tiny", "--calls", "1",
                                 "--report", str(report)]) == 0
    line = _json_line(capsys.readouterr().out)
    assert set(line) == JAX_INFERENCE_KEYS and line["metric"] == "novel_view_fps_per_chip_r16"
    assert line["same_session"] is True
    for k in ("value", "vs_baseline", "xla_fps"):
        assert np.isfinite(line[k]) and line[k] > 0, k
    assert set(json.loads(report.read_text())) == {"fused", "plain"}

    def measure(run, styles, frames, tag, *a, **k):
        raise RuntimeError(f"{tag} leg failed")

    monkeypatch.setattr(bench_inference, "measure", measure)
    with pytest.raises(RuntimeError, match="fused leg failed"):
        bench_inference.main(["16", "4", "2", "--device", "cpu", "--tiny"])
    assert "{" not in capsys.readouterr().out
