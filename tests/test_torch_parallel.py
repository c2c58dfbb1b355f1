"""The port's training step on two processes (`cips3d_tpu_torch/parallel/mesh.py`,
`train/step.py`, `train/diffcam_step.py`, `train/pigan_step.py` with a
`Mesh`) against one process at the global batch.

Two OS processes join a gloo group on 127.0.0.1 (the ``CIPS3D_*`` env of
the training CLI) and run one step each on their rows of the same global
draws; they import torch and the port only.  The flagship's step is held to
the JAX step at the global batch (JAX's draws, Pallas kernels in interpret
mode), in the 1-D layout (the shipped and the exact-sine flags, aux on and
off, ``batch_split`` 1 and 2, DiffAug) and in the 2-D layout
(``ray_shards`` 2, ``grad_points`` below the pixel count), at the
tolerances of `tests/test_torch_train.py`: losses rtol 1e-4, clipped grads
3e-4 by max|a-b| / (max|b| + 1), parameters of G, D and G_ema within 2e-2
lr on all but 0.1 % of elements.  A case without draws checks that the
ranks draw the global batch from one seed and keep their own rows.  The
variants are held to the port's own single-process step (which their tests
hold to JAX).  Both ranks must end with the same parameters, bit for bit.

    python tests/test_torch_parallel.py <cases.pt> <out dir>   # one rank, from the env
"""

import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import torch

IMG, STEPS = 8, 4
GCFG = dict(z_dim_nerf=16, z_dim_inr=32, nerf_hidden_dim=16, nerf_style_dim=16,
            nerf_mapping_layers=2, inr_hidden_dim=32, inr_style_dim=32, inr_mapping_layers=2)
TINY = {r: 16 for r in (4, 8, 16, 32, 64, 128, 256, 512, 1024)}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240    # seconds for the two ranks to run every case


# ---------------------------------------------------------------- one rank's side

def _capture_clip(module):
    """Record the clipped grads each `clip_and_guard` of ``module`` returns;
    returns (seen, restore)."""
    orig, seen = module.clip_and_guard, []

    def wrapped(grads, max_norm):
        out = orig(grads, max_norm)
        seen.append([g.detach().clone() for g in out[0]])
        return out

    module.clip_and_guard = wrapped
    return seen, lambda: setattr(module, "clip_and_guard", orig)


def _run(step_mod, fn, state, c, mesh, modules):
    """One step on the rank's rows of ``c["real"]`` (all of them without a
    mesh); the metrics, the clipped grads and the modules' state dicts."""
    seen, restore = _capture_clip(step_mod)
    real = c["real"]
    if mesh is not None:
        n = real.shape[0] // mesh.world
        real = real[mesh.rank * n:(mesh.rank + 1) * n]
    state.step = c.get("step", 0)
    rng = torch.Generator().manual_seed(c["seed"]) if c.get("seed") is not None else None
    try:
        state, m = fn(state, real, draws=c["draws"], rng=rng)
    finally:
        restore()
    out = {"metrics": m, "grads": [[g.numpy() for g in gs] for gs in seen]}
    for k, mod in modules.items():
        out[k] = {n: v.numpy() for n, v in mod.state_dict().items()}
    return out


def _load(c, **modules):
    for k, mod in modules.items():
        mod.load_state_dict(c[k])


def flagship_step(c, mesh):
    import cips3d_tpu_torch.train.step as step_mod
    from cips3d_tpu_torch.models.discriminator import DiscriminatorMultiScaleAux
    from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR, RenderOptions
    from cips3d_tpu_torch.train.state import TrainConfig

    gen = GeneratorNerfINR(GeneratorConfig(**GCFG, **c["gflags"]))
    disc = DiscriminatorMultiScaleAux(diffaug=c["diffaug"], max_size=16, channels_override=TINY)
    cfg = TrainConfig(**c["tkw"])
    state = step_mod.init_train_state(gen, disc, cfg)
    _load(c, g=gen, d=disc, ema=state.ema)
    fn = step_mod.make_train_step(gen, disc, cfg, RenderOptions(img_size=IMG, num_steps=STEPS),
                                  aux_reg=c["aux"], mesh=mesh)
    return _run(step_mod, fn, state, c, mesh, dict(g=gen, d=disc, ema=state.ema))


def diffcam_step(c, mesh):
    import cips3d_tpu_torch.train.diffcam_step as step_mod
    from cips3d_tpu_torch.models.camera import CamParams
    from cips3d_tpu_torch.models.discriminator import DiscriminatorMultiScaleAux
    from cips3d_tpu_torch.models.generator import GeneratorConfig
    from cips3d_tpu_torch.models.generator_diffcam import GeneratorDiffcam, NerfKwargs

    gen = GeneratorDiffcam(GeneratorConfig(**GCFG))
    disc = DiscriminatorMultiScaleAux(diffaug=c["diffaug"], max_size=16, channels_override=TINY)
    cam = CamParams(H0=IMG, W0=IMG)
    cfg = step_mod.DiffcamTrainConfig(**c["tkw"])
    state = step_mod.init_diffcam_state(gen, disc, cam, cfg)
    _load(c, g=gen, d=disc, ema=state.ema, cam=cam)
    fn = step_mod.make_diffcam_train_step(gen, disc, cam, cfg, NerfKwargs(n_samples=3,
                                                                          n_importance=3),
                                          aux_reg=c["aux"], mesh=mesh)
    return _run(step_mod, fn, state, c, mesh, dict(g=gen, d=disc, ema=state.ema, cam=cam))


def pigan_step(c, mesh):
    import cips3d_tpu_torch.train.pigan_step as step_mod
    from cips3d_tpu_torch.models.generator import RenderOptions
    from cips3d_tpu_torch.models.pigan import ImplicitGenerator3d, ProgressiveDiscriminator

    gen, disc = ImplicitGenerator3d(z_dim=256, hidden_dim=16), ProgressiveDiscriminator(True)
    cfg = step_mod.PiGANTrainConfig(**c["tkw"])
    state = step_mod.init_pigan_state(gen, disc, cfg)
    _load(c, g=gen, d=disc, ema=state.ema)
    fn = step_mod.make_pigan_train_step(gen, disc, cfg, RenderOptions(img_size=IMG, num_steps=3),
                                        mesh=mesh)
    return _run(step_mod, fn, state, c, mesh, dict(g=gen, d=disc, ema=state.ema))


KINDS = {"flagship": flagship_step, "diffcam": diffcam_step, "pigan": pigan_step}


def worker(case_file, out_dir):
    """One rank: every case of ``case_file`` on its mesh."""
    from cips3d_tpu_torch.parallel.mesh import initialize_multihost, make_mesh

    torch.set_num_threads(2)
    assert initialize_multihost(device="cpu")
    try:
        for name, c in torch.load(case_file, weights_only=False).items():
            out = KINDS[c["kind"]](c, make_mesh(c.get("ray_shards", 1)))
            torch.save(out, os.path.join(out_dir, f"{name}.rank{torch.distributed.get_rank()}.pt"))
    finally:
        torch.distributed.destroy_process_group()
    assert "jax" not in sys.modules and "cips3d_tpu" not in sys.modules
    return 0


if __name__ == "__main__":
    sys.exit(worker(*sys.argv[1:]))


# ---------------------------------------------------------------- the test side

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

import cips3d_tpu.train.step as jax_step  # noqa: E402
from cips3d_tpu.models.discriminator import DiscriminatorMultiScaleAux as JaxD  # noqa: E402
from cips3d_tpu.models.generator import GeneratorConfig as JaxConfig  # noqa: E402
from cips3d_tpu.models.generator import GeneratorNerfINR as JaxG  # noqa: E402
from cips3d_tpu.models.generator import RenderOptions as JaxOptions  # noqa: E402
from cips3d_tpu.models.generator import sample_zs as jax_sample_zs  # noqa: E402
from cips3d_tpu.train.state import TrainConfig as JaxTrainConfig  # noqa: E402
from cips3d_tpu.train.state import clip_and_guard as jax_clip  # noqa: E402
from cips3d_tpu_torch.models.discriminator import DiscriminatorMultiScaleAux  # noqa: E402
from cips3d_tpu_torch.models.generator import (GeneratorConfig, GeneratorNerfINR,  # noqa: E402
                                               RenderOptions)
from cips3d_tpu_torch.parallel.mesh import Mesh, shard_batch  # noqa: E402
from cips3d_tpu_torch.train.schedules import nerf_noise_schedule  # noqa: E402
from cips3d_tpu_torch.train.state import TrainConfig  # noqa: E402
from cips3d_tpu_torch.train.step import (PhaseDraws, StepDraws, draw_step,  # noqa: E402
                                         init_train_state, rank_draws)
from cips3d_tpu_torch.utils.convert import (discriminator_state_dict,  # noqa: E402
                                            load_jax_train_state, state_dict_from_jax)
from test_torch_train import (_capture, _close_share, _disc_diffaug, _forward_draws,  # noqa: E402
                              _grad_err, t)

SHIPPED = dict(fast_sin=True, fused_ray=False)
EXACT = dict(fused_ray=True, fused_ray_vjp="pallas_residual")
# name: (generator flags, aux, batch_split, grad_points, extra TrainConfig, ray_shards, B)
FLAGSHIP = {
    "shipped-aux-split1-gradpoints": (SHIPPED, True, 1, 4, {}, 1, 4),
    "shipped-noaux-split2-gradpoints": (SHIPPED, False, 2, 4, {}, 1, 4),
    "exact-aux-split2-gradpoints": (EXACT, True, 2, 4, {}, 1, 4),
    "exact-noaux-diffaug-warmup": (EXACT, False, 1, None, dict(diffaug=True, warmup_d=True), 1, 4),
    "2d-shipped-aux-gradpoints": (SHIPPED, True, 1, 4, {}, 2, 2),
    "2d-exact-noaux-diffaug": (EXACT, False, 1, None, dict(diffaug=True), 2, 2),
}
# Held to the port's one-process step only: there one process of the port moves 91 of
# G's 43351 elements (0.21 %) beyond 2e-2 lr from JAX's.  Their gradients are ~1e-7 where
# the largest is 3e-4, and Adam's first update g / (|g| + eps) turns their rounding into
# lr-sized moves; the port's split-1 and split-2 steps on the same draws agree within 6e-9.
ONE_PROCESS = {"shipped-noaux-split2": (SHIPPED, False, 2, None, {}, 1, 4)}


def _jax_step_draws(key, jcfg, batch, split, grad_points, aux, diffaug):
    """The draws of the JAX step at ``batch`` rows (`tests/test_torch_train.py`
    `_step_draws`, at any batch)."""
    k_d, k_gz, k_g = jax.random.split(key, 3)
    d_keys = [k_d] if split == 1 else list(jax.random.split(k_d, split))
    mb = batch // split
    d = []
    for kd in d_keys:
        k_z, k_gen, k_da1, k_da2 = jax.random.split(kd, 4)
        zs = jax_sample_zs(k_z, mb, jcfg)
        da = dict(diffaug_real=_disc_diffaug(k_da1, mb, aux),
                  diffaug=_disc_diffaug(k_da2, mb, aux)) if diffaug else {}
        d.append(PhaseDraws({k: t(v) for k, v in zs.items()}, _forward_draws(k_gen, mb, None),
                            **da))
    zs = jax_sample_zs(k_gz, batch, jcfg)
    g_keys = [k_g] if split == 1 else list(jax.random.split(k_g, split))
    g = []
    for i, kg in enumerate(g_keys):
        k_gen, k_da = jax.random.split(kg)
        g.append(PhaseDraws({k: t(v[i * mb:(i + 1) * mb]) for k, v in zs.items()},
                            _forward_draws(k_gen, mb, grad_points),
                            _disc_diffaug(k_da, mb, aux) if diffaug else None))
    return StepDraws(d, g)


def _tkw(split, grad_points, extra, batch):
    return dict(img_size=IMG, batch_size=batch, batch_split=split, grad_points=grad_points,
                ema_start_itr=0, **extra)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_pair(script, args, timeout=TIMEOUT):
    """Start ``script`` as ranks 0 and 1 of a gloo group on 127.0.0.1; returns
    a function that waits for both and returns their (returncode, output)."""
    port = _free_port()
    procs, logs = [], []
    for rank in range(2):
        env = dict(os.environ, CIPS3D_COORDINATOR=f"127.0.0.1:{port}", CIPS3D_NUM_PROCESSES="2",
                   CIPS3D_PROCESS_ID=str(rank),
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        logs.append(tempfile.TemporaryFile("w+"))   # a pipe could fill and stall a rank
        procs.append(subprocess.Popen([sys.executable, script, *map(str, args)], env=env,
                                      stdout=logs[-1], stderr=subprocess.STDOUT, text=True))

    def wait():
        try:
            rcs = [p.wait(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = []
        for rc, log in zip(rcs, logs):
            log.seek(0)
            outs.append((rc, log.read()))
            log.close()
        return outs

    return wait


def _flagship_case(jstate, spec):
    gflags, aux, split, gp, extra, ray_shards, batch = spec
    jcfg = JaxConfig(**GCFG, **gflags)
    real = np.random.default_rng(1).uniform(-1, 1, (batch, 3, IMG, IMG)).astype(np.float32)
    gen = GeneratorNerfINR(GeneratorConfig(**GCFG, **gflags))
    disc = DiscriminatorMultiScaleAux(diffaug=extra.get("diffaug", False), max_size=16,
                                      channels_override=TINY)
    state = init_train_state(gen, disc, TrainConfig())
    load_jax_train_state(state, jstate.g_params, jstate.d_params, jstate.ema_params, 0)
    draws = _jax_step_draws(jax.random.PRNGKey(2), jcfg, batch, split, gp ** 2 if gp else None,
                            aux, extra.get("diffaug", False))
    return dict(kind="flagship", gflags=gflags, aux=aux, diffaug=extra.get("diffaug", False),
                tkw=_tkw(split, gp, extra, batch), ray_shards=ray_shards, real=t(real),
                draws=draws, g=gen.state_dict(), d=disc.state_dict(), ema=state.ema.state_dict())


def _variant_cases():
    """A diffcam step with DiffAug and aux, and a pi-GAN step at step 50 with
    a top-k of 3 of 4 logits, at B = 4 on draws from one seed; one flagship
    step whose ranks draw the global batch from one seed themselves."""
    from cips3d_tpu_torch.models.camera import CamParams
    from cips3d_tpu_torch.models.generator_diffcam import GeneratorDiffcam, NerfKwargs
    from cips3d_tpu_torch.models.pigan import ImplicitGenerator3d, ProgressiveDiscriminator
    from cips3d_tpu_torch.train.diffcam_step import DiffcamTrainConfig, draw_diffcam_step
    from cips3d_tpu_torch.train.pigan_step import PiGANTrainConfig, draw_pigan_step

    batch, g = 4, torch.Generator().manual_seed(7)
    real = torch.rand((batch, 3, IMG, IMG), generator=g) * 2 - 1
    gen = GeneratorDiffcam(GeneratorConfig(**GCFG), generator=torch.Generator().manual_seed(0))
    disc = DiscriminatorMultiScaleAux(diffaug=True, max_size=16, channels_override=TINY,
                                      generator=torch.Generator().manual_seed(1))
    tkw = dict(img_size=IMG, batch_size=batch, grad_points=None, ema_start_itr=0)
    diffcam = dict(kind="diffcam", aux=True, diffaug=True, tkw=tkw, real=real,
                   draws=draw_diffcam_step(gen.cfg, True, DiffcamTrainConfig(**tkw),
                                           NerfKwargs(n_samples=3, n_importance=3), True, batch,
                                           g, "cpu"),
                   g=gen.state_dict(), d=disc.state_dict(), ema=gen.state_dict(),
                   cam=CamParams(H0=IMG, W0=IMG).state_dict())
    pg = ImplicitGenerator3d(z_dim=256, hidden_dim=16, generator=torch.Generator().manual_seed(2))
    pd = ProgressiveDiscriminator(True, generator=torch.Generator().manual_seed(3))
    ptkw = dict(img_size=IMG, batch_size=batch, grad_points=None, ema_start_itr=0,
                train_aux_img=False, topk_interval=1, topk_v=0.6, z_lambda=1.0)
    pigan = dict(kind="pigan", tkw=ptkw, real=real, step=50,
                 draws=draw_pigan_step(256, RenderOptions(img_size=IMG, num_steps=3), batch, g,
                                       "cpu"),
                 g=pg.state_dict(), d=pd.state_dict(), ema=pg.state_dict())
    fg = GeneratorNerfINR(GeneratorConfig(**GCFG, **SHIPPED),
                          generator=torch.Generator().manual_seed(4))
    fd = DiscriminatorMultiScaleAux(max_size=16, channels_override=TINY,
                                    generator=torch.Generator().manual_seed(5))
    seeded = dict(kind="flagship", gflags=SHIPPED, aux=True, diffaug=False,
                  tkw=_tkw(2, 4, {}, batch), real=real, draws=None, seed=11,
                  g=fg.state_dict(), d=fd.state_dict(), ema=fg.state_dict())
    return {"diffcam-aux-diffaug": diffcam, "pigan-topk3of4": pigan, "flagship-seeded": seeded}


@pytest.fixture(scope="module")
def jax_state():
    jcfg = JaxConfig(**GCFG, fused_ray=True)
    state = jax_step.init_train_state(
        jax.random.PRNGKey(0), JaxG(cfg=jcfg), JaxD(max_size=16, channels_override=TINY),
        JaxTrainConfig(img_size=IMG, batch_size=4), JaxOptions(img_size=IMG, num_steps=STEPS))
    return jax.tree_util.tree_map(np.asarray, state)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_state):
    """Every case written, the two ranks started on them; ``ranks(name)``
    waits for the ranks (once) and returns both ranks' outputs and the case."""
    d = tmp_path_factory.mktemp("parallel")
    cases = {name: _flagship_case(jax_state, spec) for name, spec in {**FLAGSHIP,
                                                                       **ONE_PROCESS}.items()}
    cases.update(_variant_cases())
    torch.save(cases, d / "cases.pt")
    wait = launch_pair(os.path.abspath(__file__), [d / "cases.pt", d])
    done = []

    def get(name):
        if not done:
            done.extend(wait())
            for rank, (rc, out) in enumerate(done):
                assert rc == 0, f"rank {rank} failed:\n{out[-4000:]}"
        outs = [torch.load(d / f"{name}.rank{r}.pt", weights_only=False) for r in range(2)]
        return outs, cases[name]

    yield get
    if not done:   # no test asked: the ranks still end before the module does
        wait()


def _same_on_both_ranks(outs):
    for k in outs[0]:
        if k in ("metrics", "grads"):
            continue
        for n, v in outs[0][k].items():
            assert np.array_equal(v, outs[1][k][n]), (k, n)
    assert outs[0]["metrics"] == outs[1]["metrics"]


def _param_share(got, ref, lr):
    return np.mean([_close_share(got[k], ref[k], 2e-2 * lr) for k in ref if ".norm." not in k])


@pytest.mark.parametrize("name", list(FLAGSHIP))
def test_two_ranks_match_the_jax_step(monkeypatch, ranks, jax_state, name):
    """Two gloo ranks (b = B / 2 each, or 2-D: one ray group of two ranks)
    against the JAX step at the global batch: losses, clipped grads, the
    parameters of G, D and G_ema after the step; both ranks bit for bit."""
    gflags, aux, split, gp, extra, ray_shards, batch = FLAGSHIP[name]
    jcfg = JaxConfig(**GCFG, **gflags)
    tkw = _tkw(split, gp, extra, batch)
    jgen = JaxG(cfg=jcfg)
    jdisc = JaxD(diffaug=extra.get("diffaug", False), max_size=16, channels_override=TINY)
    jseen = _capture(monkeypatch, jax_step, jax_clip)
    jfn = jax_step.make_train_step(jgen, jdisc, JaxTrainConfig(**tkw),
                                   JaxOptions(img_size=IMG, num_steps=STEPS), aux_reg=aux)

    def run(state, x, k):
        jseen.clear()
        new, metrics = jfn(state, x, k)
        return new, metrics, list(jseen)

    outs, case = ranks(name)
    jnew, jm, jseen = jax.jit(run)(jax_state, jnp.asarray(case["real"].numpy()),
                                   jax.random.PRNGKey(2))
    _same_on_both_ranks(outs)
    m = outs[0]["metrics"]
    keys = ["d_loss", "g_loss", "grad_penalty", "d_logits_real", "d_logits_fake", "g_logits_fake"]
    # with microbatches the JAX step averages each microbatch's root mean square
    keys += ["d_logits_norm"] if split == 1 else []
    for k in keys:
        np.testing.assert_allclose(m[k], float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    for k in ("d_total_norm", "g_total_norm", "d_w_norm"):
        np.testing.assert_allclose(m[k], float(jm[k]), rtol=3e-4, err_msg=k)
    assert m["d_finite"] == m["g_finite"] == 1.0

    gen = GeneratorNerfINR(GeneratorConfig(**GCFG, **gflags))
    disc = DiscriminatorMultiScaleAux(max_size=16, channels_override=TINY)
    d_ref = discriminator_state_dict(jax.tree_util.tree_map(np.asarray, jseen[0]))
    g_ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jseen[1]))
    for module, got, ref in ((disc, outs[0]["grads"][0], d_ref),
                             (gen, outs[0]["grads"][1], g_ref)):
        for (pname, _), g in zip(module.named_parameters(), got):
            if ".norm." not in pname:
                assert _grad_err(g, ref[pname]) < 3e-4, pname
    for lr, key, ref in ((TrainConfig().disc_lr, "d", discriminator_state_dict(jnew.d_params)),
                         (TrainConfig().gen_lr, "g", state_dict_from_jax(jnew.g_params)),
                         (TrainConfig().gen_lr, "ema", state_dict_from_jax(jnew.ema_params))):
        share = _param_share(outs[0][key], ref, lr)
        assert share <= 1e-3, (key, share)


@pytest.mark.parametrize("name", ["diffcam-aux-diffaug", "pigan-topk3of4", "flagship-seeded",
                                  *ONE_PROCESS])
def test_two_ranks_match_one_process(ranks, name):
    """Two ranks against the port's own single-process step at the global
    batch on the same draws (for the seeded case: the global batch's draws
    from the ranks' seed, `draw_step`): losses, clipped grads (D, G and
    diffcam's camera), every module after the step; both ranks bit for bit."""
    outs, case = ranks(name)
    if case["draws"] is None:   # what every rank draws from the seed, at the global batch
        cfg = TrainConfig(**case["tkw"])
        opts = RenderOptions(img_size=IMG, num_steps=STEPS,
                             nerf_noise=nerf_noise_schedule(0, cfg.nerf_noise_disable))
        case = dict(case, seed=None, draws=draw_step(
            GeneratorConfig(**GCFG, **case["gflags"]), False, cfg, opts, case["aux"],
            cfg.grad_points ** 2, case["real"].shape[0], torch.Generator().manual_seed(11),
            "cpu"))
    ref = KINDS[case["kind"]](case, None)
    _same_on_both_ranks(outs)
    split = case["tkw"].get("batch_split", 1)
    for k, v in ref["metrics"].items():
        if k == "d_logits_norm" and split > 1:   # one process averages each microbatch's root
            continue
        tol = 1e-4 if "norm" not in k else 3e-4
        np.testing.assert_allclose(outs[0]["metrics"][k], v, rtol=tol, atol=1e-6, err_msg=k)
    assert len(outs[0]["grads"]) == len(ref["grads"])
    for got, want in zip(outs[0]["grads"], ref["grads"]):
        for a, b in zip(got, want):
            assert _grad_err(a, b) < 3e-4
    lrs = {"d": 2e-3, "g": 2e-4, "ema": 2e-4, "cam": 1e-4}
    for key, lr in lrs.items():
        if key in ref:
            share = _param_share(outs[0][key], ref[key], lr)
            assert share <= 1e-3, (key, share)


@pytest.mark.parametrize("ray_shards", [1, 2])
def test_rank_draws_keep_each_ranks_rows(ray_shards):
    """`rank_draws` of four ranks on one seed's global draws (B = 8, two
    microbatches, grad_points, aux, DiffAug): ray groups hold their own G rows
    (the same on the ranks of a group), each rank its own rows of D's DiffAug
    draws of the fakes and of the reals, and every microbatch the perm of its
    global microbatch; the ranks together cover the global batch once."""
    cfg = TrainConfig(img_size=IMG, batch_split=2)
    opts = RenderOptions(img_size=IMG, num_steps=STEPS, nerf_noise=1.0)
    glob = draw_step(GeneratorConfig(**GCFG), True, cfg, opts, True, 16, 8,
                     torch.Generator().manual_seed(0), "cpu")
    n_real, world = 2, 4
    local = [rank_draws(glob, Mesh(world, r, ray_shards), n_real, 2) for r in range(world)]
    z_glob = torch.cat([pd.zs["z_nerf"] for pd in glob.d])
    real_glob = torch.cat([pd.diffaug_real[0].brightness for pd in glob.d])
    fake_glob = torch.cat([pd.diffaug[1].cut_w for pd in glob.g])
    n_g = n_real * ray_shards
    seen_z, seen_fake = [], []
    for r, ld in enumerate(local):
        grp, idx = r // ray_shards, r % ray_shards
        z = torch.cat([pd.zs["z_nerf"] for pd in ld.d])
        assert torch.equal(z, z_glob[grp * n_g:(grp + 1) * n_g])
        assert torch.equal(torch.cat([pd.diffaug_real[0].brightness for pd in ld.d]),
                           real_glob[r * n_real:(r + 1) * n_real])
        for j, pd in enumerate(ld.g):
            lo = grp * n_g + j * (n_g // 2)
            assert torch.equal(pd.forward.perm, glob.g[lo // 4].forward.perm)
            assert torch.equal(pd.forward.rays.u,
                               shard_batch(glob.g[lo // 4].forward.rays.u, lo % 4,
                                           lo % 4 + n_g // 2, 4))
            assert pd.forward.rays.u.shape[:2] == (n_g // 2, 16)
            f_lo = lo + idx * (n_real // 2)
            assert torch.equal(pd.diffaug[1].cut_w, fake_glob[f_lo:f_lo + n_real // 2])
            seen_fake.append(f_lo)
        seen_z.append(z)
    assert sorted(seen_fake) == list(range(8))
    assert torch.equal(torch.cat(seen_z[::ray_shards]), z_glob)
    assert not torch.equal(local[0].d[0].zs["z_inr"], local[-1].d[0].zs["z_inr"])
    with pytest.raises(ValueError, match="rows"):
        rank_draws(glob, Mesh(world, 0, ray_shards), 3, 1)


def test_mesh_refuses_what_it_cannot_split():
    """A minibatch standard deviation on several ranks, pixel counts that do
    not divide by ray_shards (a 2-D step at r8 with 15 grad_points), and the
    2-D mesh's row arithmetic."""
    from cips3d_tpu_torch.train.step import check_mesh

    mesh = Mesh(4, 3, 2)
    assert (mesh.group_index, mesh.ray_index, mesh.pixel_range(64)) == (1, 1, (32, 64))
    assert Mesh(4, 3, 1).pixel_range(64) == (48, 64)   # R = 1: pixels over every rank
    with pytest.raises(ValueError, match="divide by 2"):
        mesh.pixel_range(63)
    d4 = DiscriminatorMultiScaleAux(max_size=16, channels_override=TINY, stddev_group=4)
    with pytest.raises(ValueError, match="stddev_group"):
        check_mesh(Mesh(2, 0, 1), d4)
    check_mesh(Mesh(1, 0, 1), d4)   # one rank groups as one process does
    check_mesh(None, d4)
    gen = GeneratorNerfINR(GeneratorConfig(**GCFG))
    zs = {"z_nerf": torch.zeros(2, 16), "z_inr": torch.zeros(2, 32)}
    with pytest.raises(ValueError, match="15 pixels do not divide by 2"):
        gen(zs, RenderOptions(img_size=IMG, num_steps=STEPS), torch.Generator().manual_seed(0),
            grad_points=15, mesh=Mesh(2, 0, 2))
