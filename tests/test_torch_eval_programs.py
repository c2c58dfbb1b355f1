"""The loop's eval renders, and the surrogate FID on the device it is
given.

  * the flagship's monitor grids (`train/loop.py::save_monitor_images`):
    each model's renders at its pose; one monitor render against the JAX
    loop's `_monitor_render_fn` on the same weights, JAX's draws fed as
    tensors, at rtol 1e-4 / atol 1e-5;
  * diffcam's and pi-GAN's eval fakes (`train/variant_loop.py`): each
    batch's seed and render, file for file;
  * `graphs.eager`, the check of a caller's ``dispatch``;
  * `surrogate_extractor` and `default_extractor` on the device they are
    given, one extractor a device; a ``gpu`` case holds the card's features
    to the CPU's (rtol 1e-4 / atol 1e-5, TF32 off) and the FID to 1e-4
    relative.
The JAX case imports JAX inside (and skips without JAX or flax), so the
file runs on the card as `tests/test_torch_render_graph.py` does:
`python -m pytest --noconftest tests/test_torch_eval_programs.py`.
"""

import math
import os

import numpy as np
import pytest
import torch

from cips3d_tpu_torch.eval import fid
from cips3d_tpu_torch.models.generator import (GeneratorConfig, GeneratorNerfINR, RenderOptions,
                                               sample_zs)
from cips3d_tpu_torch.train.loop import LoopConfig, save_monitor_images
from cips3d_tpu_torch.utils import graphs, image_io
from cips3d_tpu_torch.utils.convert import jax_tree_from_state_dict

TINY = dict(z_dim_nerf=16, z_dim_inr=32, nerf_hidden_dim=16, nerf_style_dim=16,
            nerf_mapping_layers=2, inr_hidden_dim=32, inr_style_dim=32, inr_mapping_layers=2)
D_TINY = dict(max_size=16, channels_override={r: 16 for r in (4, 8, 16)})
IMG, STEPS = 8, 4
OPTS = RenderOptions(img_size=IMG, num_steps=STEPS, h_stddev=0.0, v_stddev=0.0)
FRAME_TOL = dict(rtol=1e-4, atol=1e-5)


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _gen(cfg, seed, cls=GeneratorNerfINR):
    return cls(GeneratorConfig(**cfg), generator=torch.Generator().manual_seed(seed)).eval()


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


# ---------------------------------------------------------------- the flagship's monitors

def test_monitor_grids_are_the_models_renders(monkeypatch, tmp_path):
    """`save_monitor_images` writes the five grids, each the images of its
    model at its pose with the aux images below, a generator seeded 0 a
    sub-batch: G and EMA at the mean pose and tilted, and the EMA's flip
    probe at yaw 1.44 over 1.70."""
    import cips3d_tpu_torch.train.loop as loop_mod

    g, ema = _gen(dict(TINY, fast_sin=True), 1), _gen(dict(TINY, fast_sin=True), 2)
    zs = sample_zs(3, g.cfg, torch.Generator().manual_seed(3))
    grids = {}
    orig = loop_mod.save_image_grid
    monkeypatch.setattr(loop_mod, "save_image_grid", lambda x, path, nrow: (
        grids.__setitem__(os.path.basename(path), x), orig(x, path, nrow)))
    save_monitor_images(g, ema, zs, OPTS, str(tmp_path))
    assert sorted(grids) == sorted(os.listdir(tmp_path)) == [
        "0G_flip_ema.jpg", "0Gz.jpg", "0Gz_ema.jpg", "0Gz_tilted.jpg", "0Gz_tilted_ema.jpg"]

    def want(model, h_mean, n=3):
        o = RenderOptions(img_size=IMG, num_steps=STEPS, h_stddev=0.0, v_stddev=0.0,
                          h_mean=h_mean)
        with torch.no_grad():
            return model({k: v[:n] for k, v in zs.items()}, o, torch.Generator().manual_seed(0),
                         return_aux_img=True)[0].numpy()

    tilt = math.pi * 0.5 + 0.5
    for name, model, h_mean in (("0Gz", g, math.pi * 0.5), ("0Gz_ema", ema, math.pi * 0.5),
                                ("0Gz_tilted", g, tilt), ("0Gz_tilted_ema", ema, tilt)):
        assert grids[f"{name}.jpg"].shape == (6, 3, IMG, IMG)
        np.testing.assert_array_equal(grids[f"{name}.jpg"], want(model, h_mean))
    np.testing.assert_array_equal(grids["0G_flip_ema.jpg"],
                                  np.concatenate([want(ema, 1.44), want(ema, 1.70)]))


def test_monitor_render_matches_jax():
    """One monitor render of the port (the images with the aux images
    below) on converted weights and JAX's draws against the JAX loop's
    jitted `_monitor_render_fn` (key 0, the mean pose without jitter)."""
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax")
    import jax.numpy as jnp

    from cips3d_tpu.models.generator import GeneratorConfig as JaxConfig
    from cips3d_tpu.models.generator import GeneratorNerfINR as JaxGenerator
    from cips3d_tpu.models.generator import RenderOptions as JaxOptions
    from cips3d_tpu.models.generator import sample_zs as jax_sample_zs
    from cips3d_tpu.train.loop import _monitor_render_fn
    from test_torch_volume import forward_draws   # IMG 8, STEPS 4: the draws of key 0

    port = _gen(dict(TINY, fast_sin=True), 11)
    jgen = JaxGenerator(cfg=JaxConfig(**TINY, fast_sin=True))
    params = jax.tree_util.tree_map(jnp.asarray, jax_tree_from_state_dict(port.state_dict()))
    zs = jax_sample_zs(jax.random.PRNGKey(4), 2, jgen.cfg)
    opts = dict(img_size=IMG, num_steps=STEPS, h_stddev=0.0, v_stddev=0.0)
    ref = _monitor_render_fn(jgen)(params, zs, jax.random.PRNGKey(0), JaxOptions(**opts))
    with torch.no_grad():
        got = port({k: t(v) for k, v in zs.items()}, RenderOptions(**opts), return_aux_img=True,
                   draws=forward_draws(jax.random.PRNGKey(0), 2, None))[0]
    assert got.shape == ref.shape == (4, 3, IMG, IMG)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FRAME_TOL)


# ---------------------------------------------------------------- the variants

def _diffcam():
    from cips3d_tpu_torch.models.generator_diffcam import NerfKwargs
    from cips3d_tpu_torch.train.diffcam_step import DiffcamTrainConfig
    from cips3d_tpu_torch.train.variant_loop import DiffcamPipeline

    return DiffcamPipeline(GeneratorConfig(**TINY), D_TINY, dict(H0=IMG, W0=IMG),
                           DiffcamTrainConfig(img_size=IMG, batch_size=2),
                           NerfKwargs(n_samples=3, n_importance=3))


def _pigan():
    from cips3d_tpu_torch.train.pigan_step import PiGANTrainConfig
    from cips3d_tpu_torch.train.variant_loop import PiGANPipeline

    return PiGANPipeline(dict(z_dim=16, hidden_dim=16), {},
                         PiGANTrainConfig(img_size=IMG, batch_size=2, train_aux_img=False),
                         RenderOptions(img_size=IMG, num_steps=3))


@pytest.mark.parametrize("build", [_diffcam, _pigan], ids=["diffcam", "pigan"])
def test_variant_eval_fakes_are_each_batch_seeds_renders(build, tmp_path):
    """Each pipeline's eval writes fake i of shard k of n from its batch j
    drawn from a generator seeded k * 100003 + j (diffcam: its latents and
    a random pose of its camera; pi-GAN: its latents), as the port's
    `gen_images` seeds its batches, and its monitors write three grids."""
    from cips3d_tpu_torch.eval.images import to_uint8

    pipe = build()
    loop = LoopConfig(device="cpu", seed=3, fixed_z_bs=2, eval_batch_size=2)
    state = pipe.init_state(loop)
    pipe.gen_eval_images(state, str(tmp_path / "fake"), 7, loop, shard_index=1, num_shards=2)
    assert sorted(os.listdir(tmp_path / "fake")) == [f"fake_{i:06d}.png" for i in (1, 3, 5)]
    want = []
    for j in range(2):
        rng = torch.Generator().manual_seed(100003 + j)
        with torch.no_grad():
            if hasattr(state, "camera"):
                imgs = pipe.render(state.ema, state.camera, sample_zs(2, pipe.gen_cfg, rng), rng)
            else:
                imgs = state.ema(torch.randn((2, state.ema.z_dim), generator=rng),
                                 pipe.eval_opts(), rng)[0]
        want += [to_uint8(x) for x in imgs.float().numpy()]
    for i, img in zip((1, 3, 5), want):
        got = image_io.read_png(str(tmp_path / "fake" / f"fake_{i:06d}.png"))
        np.testing.assert_array_equal(got, img)
    pipe.save_monitors(state, str(tmp_path / "mon"))
    assert sorted(os.listdir(tmp_path / "mon")) == ["0Gz.jpg", "0Gz_ema.jpg",
                                                    "0Gz_tilted_ema.jpg"]


def test_dispatch_names_are_checked(tmp_path):
    """`graphs.eager` reads ``"eager"`` and ``"program"`` and refuses any
    other name, as every caller with a ``dispatch`` (here `gen_images`)
    does before it renders."""
    from cips3d_tpu_torch.eval.images import gen_images

    assert graphs.eager("eager") and not graphs.eager("program")
    with pytest.raises(ValueError, match="dispatch"):
        graphs.eager("jit")
    with pytest.raises(ValueError, match="dispatch"):
        gen_images(_gen(TINY, 1), str(tmp_path), 2, IMG, batch_size=2, num_steps=STEPS,
                   dispatch="jit")


# ---------------------------------------------------------------- the surrogate FID's device

def test_extractors_compute_on_the_device_they_are_given(monkeypatch, tmp_path):
    """`default_extractor` hands its device to the surrogate; the cache keeps
    one extractor a device (``cpu`` and ``torch.device("cpu")`` are one,
    the meta device another, built there without CUDA); the features of a
    CPU extractor come back as (b, 256) float32 numpy."""
    monkeypatch.setenv("CIPS3D_INCEPTION_WEIGHTS", str(tmp_path / "absent.pth"))
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    cpu = fid.surrogate_extractor(device="cpu")
    assert cpu is fid.surrogate_extractor(device=torch.device("cpu"))
    assert cpu is fid.default_extractor(device="cpu") and cpu.device == torch.device("cpu")
    meta = fid.default_extractor(device="meta")
    assert meta is fid.surrogate_extractor(device="meta") and meta is not cpu
    assert meta.device.type == "meta" and meta.metric_name == "FID_surrogate"
    x = np.random.default_rng(0).integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    feats = cpu(x)
    assert isinstance(feats, np.ndarray) and feats.shape == (2, 256) and \
        feats.dtype == np.float32


@pytest.mark.gpu
def test_surrogate_on_the_card_matches_the_cpu():
    """Features of 64 r64 images on the card against the CPU extractor's
    (TF32 off inside the extractor), and the FID of two such sets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(1)
    a, b = (rng.integers(0, 256, (64, 64, 64, 3), dtype=np.uint8) for _ in range(2))
    b = (b // 2 + 60).astype(np.uint8)
    card, cpu = fid.surrogate_extractor(device="cuda"), fid.surrogate_extractor(device="cpu")
    assert card.device.type == "cuda"
    feats = {name: (ex(a), ex(b)) for name, ex in (("card", card), ("cpu", cpu))}
    for x, y in zip(feats["card"], feats["cpu"]):
        np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-5)
    f = {name: fid.frechet_distance(*fid.activation_statistics(x), *fid.activation_statistics(y))
         for name, (x, y) in feats.items()}
    assert abs(f["card"] - f["cpu"]) <= 1e-4 * abs(f["cpu"])



@pytest.mark.gpu
def test_graphs_of_one_pool_reuse_each_others_freed_blocks():
    """Two graphs captured into one pool (as a `ProgramCache`'s are): the
    second takes the blocks the first freed (both are captured on one
    stream, `graphs.capture_stream`), so the pool does not grow by the
    second graph's temporaries; each replays its own result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    x = torch.ones(1 << 24, device=dev)   # 64 MiB; each call makes two such temporaries

    def call(k):
        return lambda: ((x * k) + 1).sum()

    pool = torch.cuda.graph_pool_handle()
    a = graphs.Graph(call(2.0), dev, "a", pool=pool)
    held = torch.cuda.memory_reserved(dev)
    b = graphs.Graph(call(3.0), dev, "b", pool=pool)
    assert torch.cuda.memory_reserved(dev) - held < (32 << 20)
    assert a.replay().item() == 3 * (1 << 24) and b.replay().item() == 4 * (1 << 24)
    a.close()
    b.close()
