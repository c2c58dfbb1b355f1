"""The render side's one program a call (`cips3d_tpu_torch/utils/graphs.py`
and its callers): `render_chunked`, `RenderService`, `bench.inference`'s
K-frame call, `project_image`'s step, the sigma volume's chunk and the eval
render.

On the CPU a program runs op by op on its input buffers; these tests hold
that route against the eager functions (``dispatch="eager"``) bit for bit:
images, depths, styles, losses, the generator's state after the call.  One
frame goes against the JAX package's `render_chunked_traced` on JAX's
draws at `test_torch_slice.py`'s tolerance; the program route is the
default, so `test_torch_slice.py::test_render_chunked_matches_jax` and
`test_torch_apps.py::test_project_image_matches_jax` (three program-route
inversion steps against JAX's `project_image`) hold it too.  The ``gpu``
cases (replays against eager calls on the card) skip without a CUDA
device; the file imports JAX only inside the JAX case (which skips where
JAX or flax is absent), so it runs on the card as
`tests/test_torch_kernels.py` does: `python -m pytest --noconftest
tests/test_torch_render_graph.py`.
"""

import numpy as np
import pytest
import torch

from cips3d_tpu_torch.apps import inversion, render, shapes
from cips3d_tpu_torch.apps.serve import RenderService
from cips3d_tpu_torch.bench import inference
from cips3d_tpu_torch.eval import images
from cips3d_tpu_torch.models.generator import (GeneratorConfig, GeneratorNerfINR, RenderOptions,
                                               sample_zs)
from cips3d_tpu_torch.ops.ray_tile import RayDraws
from cips3d_tpu_torch.utils import graphs
from cips3d_tpu_torch.utils.convert import jax_tree_from_state_dict

TINY = dict(z_dim_nerf=16, z_dim_inr=32, nerf_hidden_dim=32, nerf_style_dim=32,
            nerf_rgb_dim=16, nerf_mapping_layers=2, inr_hidden_dim=32, inr_style_dim=32,
            inr_mapping_layers=2)
SERVING = dict(TINY, fused_ray=True, fused_inr=True, fast_sin=True)
EXACT = dict(TINY, fast_sin=False, fused_ray=True, fused_ray_vjp="pallas_residual")
CARD = dict(SERVING, inr_hidden_dim=64)   # the INR tile takes widths in multiples of 64
KERNEL_TOL = dict(rtol=2e-4, atol=2e-5)   # tests/test_torch_slice.py
FRAME_TOL = dict(rtol=1e-4, atol=1e-5)    # tests/test_torch_apps.py
OPTS = RenderOptions(img_size=8, num_steps=4, h_stddev=0.0, v_stddev=0.0)


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _gen(cfg=SERVING, seed=0, device="cpu"):
    return GeneratorNerfINR(GeneratorConfig(**cfg),
                            generator=torch.Generator().manual_seed(seed)).to(device).eval()


def _styles(gen, seed=1):
    zs = sample_zs(1, gen.cfg, torch.Generator(gen.device).manual_seed(seed), device=gen.device)
    with torch.no_grad():
        return gen.mapping(zs["z_nerf"], zs["z_inr"])


def _camera(b=1):
    pos = np.tile(np.array([[0.3, 0.1, 0.95]], np.float32), (b, 1))
    return pos / np.linalg.norm(pos, axis=-1, keepdims=True)


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


# ---------------------------------------------------------------- the program core

def test_put_back_driven_by_and_fill():
    """`put_back` restores tensors and generators; `driven_by` leaves the
    caller's generator where drawing from it directly would; `fill` takes
    device tensors, CPU tensors and numpy arrays."""
    x = torch.arange(4.0)
    g = torch.Generator().manual_seed(3)
    with graphs.put_back([x], [g]):
        x.add_(1)
        torch.rand(5, generator=g)
    assert torch.equal(x, torch.arange(4.0))
    assert torch.equal(torch.rand(3, generator=g), torch.rand(3, generator=torch.Generator()
                                                                   .manual_seed(3)))
    caller, direct, own = (torch.Generator().manual_seed(9) for _ in range(3))
    with graphs.driven_by(caller, own):
        a = torch.rand(7, generator=own)
    assert torch.equal(a, torch.rand(7, generator=direct))
    assert torch.equal(torch.rand(2, generator=caller), torch.rand(2, generator=direct))
    buf = torch.empty(2, 3)
    graphs.fill(buf, np.ones((2, 3), np.float64) * 0.1)
    assert buf.dtype == torch.float32 and torch.equal(buf, torch.full((2, 3), 0.1))
    graphs.fill(buf, torch.zeros(2, 3))
    assert not buf.any()


def test_program_cache_keys_rebinding_and_limit():
    """One program a model and key; a model whose parameters moved gets a
    new one; past the limit the oldest goes; a model's programs hold it
    weakly."""
    cache = graphs.ProgramCache(limit=2)
    gen = _gen()
    made = []

    def make(pool, lock):
        made.append(graphs.Program(lambda x, rng: x * 2, torch.zeros(2), "cpu", "double",
                                   pool=pool, lock=lock))
        return made[-1]

    a = cache.get(gen, "a", make)
    assert cache.get(gen, "a", make) is a and len(made) == 1
    assert torch.equal(a(torch.ones(2)), torch.full((2,), 2.0))
    lin = gen.aux_to_rbg[0]
    lin.weight = torch.nn.Parameter(lin.weight.detach().clone())
    assert cache.get(gen, "a", make) is not a and len(made) == 2
    cache.get(gen, "b", make)
    cache.get(gen, "c", make)
    assert len(cache._order) == 2 and "a" not in cache._by_model[gen]
    import gc
    import weakref

    ref = weakref.ref(gen)
    del gen
    gc.collect()
    assert ref() is None   # no program kept the model alive
    assert not graphs.Program(lambda x, r: x, torch.zeros(1), "cpu", "x").captured


# ---------------------------------------------------------------- render_chunked

@pytest.mark.parametrize("draws", ["generator", "tensors", "unfused"])
def test_render_chunked_program_matches_eager(draws):
    """The program route against the eager call, bit for bit, image and
    depth; with a generator it is left where the eager call leaves it.  A
    second call of the same key (other styles, camera and draws) fills the
    buffers again; the first call's outputs stay as they were."""
    gen = _gen(TINY if draws == "unfused" else SERVING)
    outs = {}
    for dispatch in ("eager", "program"):
        calls = []
        for seed in (1, 2):
            st = _styles(gen, seed)
            kw = dict(camera_pos=_camera(), camera_lookup=-_camera(), return_depth=True,
                      dispatch=dispatch)
            g = torch.Generator().manual_seed(10 + seed)
            if draws == "tensors":
                kw.update(perturb_uniform=torch.rand((1, 64, 4, 1), generator=g),
                          chunk_draws=[RayDraws(torch.rand((1, 32, 4), generator=g),
                                                torch.zeros(1, 32, 4), torch.zeros(1, 32, 8))
                                       for _ in range(2)])
                g = None
            out = render.render_chunked(gen, st, OPTS, g, 32, **kw)
            after = None if g is None else torch.rand(4, generator=g)
            calls.append((out, after))
        outs[dispatch] = calls
    first = [o.clone() for o in outs["program"][0][0]]
    for (e, ea), (p, pa) in zip(outs["eager"], outs["program"]):
        assert _equal(e, p)
        assert ea is None or torch.equal(ea, pa)
    assert not _equal(outs["program"][0][0], outs["program"][1][0])
    assert _equal(first, outs["program"][0][0])


def test_render_frame_program_matches_jax():
    """One frame through the program route (`render_frame`, the camera as
    numpy) on JAX's draws against JAX's `render_chunked_traced`."""
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax")   # the JAX package's models
    import jax.numpy as jnp

    from cips3d_tpu.apps.render import render_chunked_traced
    from cips3d_tpu.models.generator import GeneratorConfig as JaxConfig
    from cips3d_tpu.models.generator import GeneratorNerfINR as JaxGenerator
    from cips3d_tpu.models.generator import RenderOptions as JaxOptions
    from cips3d_tpu.models.generator import sample_zs as jax_sample_zs

    port = _gen(SERVING, 11)
    jgen = JaxGenerator(cfg=JaxConfig(**SERVING))
    params = jax.tree_util.tree_map(jnp.asarray, jax_tree_from_state_dict(port.state_dict()))
    zs = jax_sample_zs(jax.random.PRNGKey(0), 1, jgen.cfg)
    size, S, fp = 8, 6, 64
    opts = dict(img_size=size, num_steps=S, h_stddev=0.0, v_stddev=0.0)
    pos = _camera()
    jst = jgen.apply(params, zs["z_nerf"], zs["z_inr"], method=jgen.mapping)
    st = {k: t(v) for k, v in jst.items()}
    key = jax.random.PRNGKey(7)
    ref_img, ref_dep = render_chunked_traced(params, jgen, jst, JaxOptions(**opts), key, fp,
                                             jnp.asarray(pos), jnp.asarray(-pos), None, True)
    k_rays, k_pts = jax.random.split(key)
    uniform = jax.random.uniform(jax.random.split(k_rays)[0], (1, size * size, S, 1))
    chunk_draws = []
    for k in jax.random.split(k_pts, size * size // fp):
        u = jax.random.uniform(jax.random.split(k, 3)[0], (fp, S), jnp.float32)
        chunk_draws.append(RayDraws(t(u).reshape(1, fp, S), torch.zeros(1, fp, S),
                                    torch.zeros(1, fp, 2 * S)))

    class Given(render.Draws):
        def render(self, key, b, opts, chunk):
            return dict(perturb_uniform=t(uniform), chunk_draws=chunk_draws)

    img, dep = render.render_frame(port, st, RenderOptions(**opts), 7, Given("cpu"), fp,
                                   pos, -pos, return_depth=True)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref_img), **KERNEL_TOL)
    np.testing.assert_allclose(dep.numpy(), np.asarray(ref_dep), **KERNEL_TOL)


# ---------------------------------------------------------------- serving, bench

def test_render_service_program_matches_eager():
    """Two models in one service: each seed's frame through the program
    route equals the eager frame bit for bit, and again when replayed; one
    program per model and size, in the service's cache."""
    service = RenderService({"a": _gen(seed=0), "b": _gen(seed=5)}, img_size=8, num_steps=3,
                            forward_points=32)
    for model in ("a", "b"):
        for seed, yaw in ((0, 1.5), (1, 1.7), (0, 1.5)):
            e = service.render(seed, yaw, model=model, dispatch="eager")
            p = service.render(seed, yaw, model=model)
            assert _equal(e, p)
    assert {k[0][0] for p in service.programs._by_model.values() for k in p} == \
        {"render_chunked"}
    assert sum(len(p) for p in service.programs._by_model.values()) == 2
    assert service.frame(seed=3, depth=True).shape == (8, 8, 3)
    service.close()


def test_bench_frames_sum_matches_single_frames():
    """`run_frames`' K-frame call (the program route) against K eager
    frames from the same generator seed, and against K single frames each
    summed on its own (the checksum bit for bit with the eager call)."""
    widths = dict(TINY)
    gen, opts, run = inference.build_renderer(8, 4, 3, True, True, True, gen_widths=widths,
                                              device="cpu")
    _, _, run_eager = inference.build_renderer(8, 4, 3, True, True, True, gen_widths=widths,
                                               device="cpu", weights=gen.state_dict(),
                                               dispatch="eager")
    _, _, run_one = inference.build_renderer(8, 4, 1, True, True, True, gen_widths=widths,
                                             device="cpu", weights=gen.state_dict())
    st = _styles(gen)
    g1, g2, g3 = (torch.Generator().manual_seed(4) for _ in range(3))
    got, want = run(st, g1), run_eager(st, g2)
    singles = [run_one(st, g3) for _ in range(3)]
    assert got == want and got > 0
    assert abs(got - sum(singles)) <= 1e-5 * got
    assert torch.equal(g1.get_state(), g2.get_state()) and torch.equal(g1.get_state(),
                                                                       g3.get_state())
    assert run.program[0].captured is False


# ---------------------------------------------------------------- inversion

def test_project_image_program_matches_eager():
    """Three steps on the exact-sine flags with the percept term: the
    program route against the eager steps, styles, render and losses bit
    for bit."""
    from cips3d_tpu_torch.models.discriminator import DiscriminatorMultiScaleAux

    gen = _gen(EXACT, seed=3)
    disc = DiscriminatorMultiScaleAux(max_size=32, channels_override={s: 16 for s in (
        4, 8, 16, 32, 64, 128, 256, 512, 1024)}, generator=torch.Generator().manual_seed(4))
    target = np.random.default_rng(5).uniform(-1, 1, (3, 8, 8)).astype(np.float32)
    out = {}
    for dispatch in ("eager", "program"):
        out[dispatch] = inversion.project_image(
            gen, target, num_steps_opt=3, img_size=8, num_steps=4, avg_samples=8, log_every=1,
            percept_fn=inversion.make_disc_percept_fn(disc), dispatch=dispatch)
    (se, ie, he), (sp, ip, hp) = out["eager"], out["program"]
    assert he == hp and len(hp) == 3 and np.array_equal(ie, ip)
    assert all(torch.equal(se[k], sp[k]) for k in se)


# ---------------------------------------------------------------- sigma volume, eval

def test_sigma_volume_and_eval_images_program_match_eager(tmp_path):
    """The sigma volume (a ragged grid, padded to whole chunks) and the
    eval renders (`gen_images`, `sample_images`) through their programs
    against their eager runs, bit for bit."""
    gen = _gen()
    st = _styles(gen)
    vols = [shapes.sample_sigma_volume(gen, n=7, chunk=100, styles=st, dispatch=d)
            for d in ("eager", "program")]
    assert vols[0].shape == (7, 7, 7) and np.array_equal(vols[0], vols[1])
    for fn, n in ((images.gen_images, 5), (images.sample_images, 3)):
        pngs = {}
        for d in ("eager", "program"):
            out = tmp_path / f"{fn.__name__}_{d}"
            assert fn(gen, str(out), n, 8, batch_size=2, num_steps=3, dispatch=d) == n
            pngs[d] = {p.name: p.read_bytes() for p in out.iterdir()}
        assert len(pngs["eager"]) == n and pngs["eager"] == pngs["program"]


def test_loop_releases_the_chunk_before_each_eval(tmp_path, monkeypatch):
    """The training loop frees its chunk's graph before every eval (on the
    card train_r256's eval render, b = 16 at r256, did not fit beside the
    step's pool) and the next chunk captures again: chunk, release, eval,
    then the chunks after it."""
    import cips3d_tpu_torch.train.loop as loop_mod
    from cips3d_tpu_torch.data.synthetic import make_blob_dataset
    from cips3d_tpu_torch.train.state import TrainConfig

    events = []
    real_make = loop_mod.make_chunk_fn

    def spy(*args, **kw):
        run = real_make(*args, **kw)

        def counted(reals, draws=None):
            events.append(f"chunk of {len(reals)}")
            return run(reals, draws)

        def close():
            events.append("release")
            run.close()

        counted.captured, counted.close = run.captured, close
        return counted

    monkeypatch.setattr(loop_mod, "make_chunk_fn", spy)
    monkeypatch.setattr(loop_mod, "_run_eval_and_checkpoint", lambda *a, **k: events.append(
        "eval"))
    data = make_blob_dataset(str(tmp_path / "d.zip"), 6, img_size=8, seed=1)
    lcfg = loop_mod.LoopConfig(outdir=str(tmp_path / "run"), data_path=data, log_every=1,
                               eval_every=3, fixed_z_bs=2, num_workers=1, dispatch_chunk=2,
                               device="cpu")
    tcfg = TrainConfig(img_size=8, batch_size=1, grad_points=None, forward_points=None,
                       total_iters=4, ema_start_itr=1)
    disc = dict(max_size=16, channels_override={k: 16 for k in (4, 8, 16, 32, 64, 128, 256,
                                                                 512, 1024)})
    state = loop_mod.train(GeneratorConfig(**TINY, nerf_hidden_layers=1), tcfg,
                           RenderOptions(num_steps=3), lcfg, disc_kwargs=disc)
    assert state.step == 4
    assert events == ["chunk of 1", "release", "eval", "chunk of 2", "release", "eval",
                      "chunk of 1", "release", "eval", "release"]


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the programs are captured only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_render_replay_matches_eager_on_the_card(cuda_device):
    """Replays against eager frames of the same seeds, bit for bit; the
    outputs are copies (a later replay leaves them); the generator ends
    where the eager call leaves it; the kernels counted through replays."""
    from cips3d_tpu_torch.ops import build

    gen = _gen(CARD, device=cuda_device)
    cache = graphs.ProgramCache()
    outs = []
    for dispatch in ("eager", "program"):
        got = []
        for seed in (1, 2, 1):
            g = torch.Generator(cuda_device).manual_seed(seed)
            got.append(render.render_chunked(gen, _styles(gen, seed), OPTS, g, 32, _camera(),
                                             -_camera(), return_depth=True, dispatch=dispatch,
                                             programs=cache)
                       + (torch.rand(3, generator=g, device=cuda_device),))
        outs.append(got)
    for e, p in zip(*outs):
        assert _equal(e, p)
    assert _equal(outs[1][0], outs[1][2]) and not _equal(outs[1][0], outs[1][1])
    for _ in range(2):   # the first call warms up (launches counted) and captures
        build.reset_launches()
        render.render_chunked(gen, _styles(gen), OPTS, None, 32, _camera(), -_camera(),
                              programs=cache)
    assert build.launches("ray_tile") == 2 and build.launches("inr_tile") == 2
    cache.close()


@pytest.mark.gpu
def test_inversion_and_bench_replays_match_eager_on_the_card(cuda_device):
    """The captured inversion step and the bench's K-frame call against
    their eager runs on the card, bit for bit."""
    gen = _gen(EXACT, seed=3, device=cuda_device)
    target = np.random.default_rng(5).uniform(-1, 1, (3, 8, 8)).astype(np.float32)
    runs = [inversion.project_image(gen, target, num_steps_opt=3, img_size=8, num_steps=4,
                                    avg_samples=8, log_every=1, dispatch=d)
            for d in ("eager", "program")]
    assert runs[0][2] == runs[1][2] and np.array_equal(runs[0][1], runs[1][1])
    assert all(torch.equal(runs[0][0][k], runs[1][0][k]) for k in runs[0][0])
    sums = []
    for d in ("eager", "program"):
        g, _, run = inference.build_renderer(32, 4, 4, True, True, True,
                                             gen_widths={k: v for k, v in CARD.items() if k
                                                         not in ("fused_ray", "fused_inr",
                                                                 "fast_sin")},
                                             device=cuda_device, dispatch=d)
        sums.append(run(_styles(g), torch.Generator(cuda_device).manual_seed(0)))
    assert sums[0] == sums[1]
