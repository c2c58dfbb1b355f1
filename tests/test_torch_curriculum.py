"""The port's curricula and stage chain (`cips3d_tpu_torch/train/curriculum.py`)
against the JAX package's, and the helpers the variant pipelines' loop
tests share (`tests/test_torch_diffcam.py`, `tests/test_torch_pigan.py`):
a two-step run, an exact resume, and snapshots traded both ways with the
JAX package's `CheckpointManager` and pipelines.
"""

import os

import jax
import numpy as np
import optax
import pytest

from cips3d_tpu.train import curriculum as jc
from cips3d_tpu.utils.checkpoint import CheckpointManager as JaxManager
from cips3d_tpu_torch.train import curriculum as pc

TINY = {r: 16 for r in (4, 8, 16)}


def _outcome(fn, *args):
    """fn's result, or the KeyError it raises (the curricula's empty end
    stages carry no img_size, in both packages)."""
    try:
        return fn(*args)
    except KeyError as e:
        return ("KeyError", str(e))


@pytest.mark.parametrize("name", ["CelebA", "CARLA", "CATS"])
def test_curricula_match_jax(name):
    cur = pc.CURRICULUMS[name]
    assert cur == jc.CURRICULUMS[name]
    for step in (0, 1, 9999, 10000, 54999, 55000, 199999, 200000, 4000000, 10 ** 8):
        assert pc.extract_metadata(cur, step) == jc.extract_metadata(cur, step), step
        for fn in ("next_upsample_step", "last_upsample_step"):
            assert _outcome(getattr(pc, fn), cur, step) == \
                _outcome(getattr(jc, fn), cur, step), (fn, step)
    assert pc.next_upsample_step(cur, 0) == jc.next_upsample_step(cur, 0)


def test_stage_table_matches_jax():
    assert [vars(s) for s in pc.FFHQ_STAGES] == [vars(s) for s in jc.FFHQ_STAGES]
    cur = {0: {"img_size": 32}, 100: {"img_size": 64}, 500: {"img_size": 64}, "fov": 12}
    assert pc.extract_metadata(cur, 99) == {"img_size": 32, "fov": 12}
    assert pc.next_upsample_step(cur, 0) == 100 and pc.next_upsample_step(cur, 100) == np.inf
    assert pc.last_upsample_step(cur, 600) == 100


def test_two_stage_chain_on_the_cpu(tmp_path):
    """`run_progressive` over two tiny stages on the CPU: each stage's trees,
    stage 2 finetuned from stage 1's best_fid (its first G is stage 1's
    best G), and a restart from stage 2 alone."""
    from cips3d_tpu_torch.data.synthetic import make_blob_dataset
    from cips3d_tpu_torch.models.generator import GeneratorConfig, RenderOptions
    from cips3d_tpu_torch.train.loop import LoopConfig
    from cips3d_tpu_torch.train.state import TrainConfig
    from cips3d_tpu_torch.utils import convert
    from cips3d_tpu_torch.utils.checkpoint import CheckpointManager
    from test_torch_volume import GCFG

    data = make_blob_dataset(str(tmp_path / "d.zip"), 6, img_size=8, seed=1)
    stages = [pc.Stage("s8a", 8, 2), pc.Stage("s8b", 8, 2, overrides=dict(gen_lr=1e-4))]
    tcfg = TrainConfig(img_size=8, batch_size=2, grad_points=None, forward_points=None,
                       total_iters=2, ema_start_itr=1)
    lcfg = LoopConfig(outdir=str(tmp_path / "prog"), data_path=data, eval_every=2, log_every=1,
                      num_images_real_eval=4, num_images_gen_eval=4, eval_batch_size=2,
                      fixed_z_bs=2, num_workers=1, device="cpu", debug=True)
    seen = []
    import cips3d_tpu_torch.train.loop as loop_mod
    real_train = loop_mod.train

    def spy(*args, **kw):
        seen.append((args[1].img_size, args[1].gen_lr, kw["finetune_dir"]))
        return real_train(*args, **kw)

    loop_mod.train = spy
    kw = dict(stages=stages, disc_kwargs=dict(max_size=16, channels_override=TINY))
    gcfg, opts = GeneratorConfig(**GCFG), RenderOptions(num_steps=3)
    try:
        state = pc.run_progressive(gcfg, tcfg, opts, lcfg, **kw)
        # stage 2 started from stage 1's best G: its first backup, one Adam step (of at
        # most lr = 1e-4 an element) later, lies within a step of it
        best = CheckpointManager(str(tmp_path / "prog" / "s8a" / "ckptdir")).load_snapshot(
            "best_fid", ("generator",))["generator"]
        first = CheckpointManager(str(tmp_path / "prog" / "s8b" / "ckptdir")).load_snapshot(
            "ckpt_00000000", ("generator",))["generator"]
        sd_a, sd_b = convert.state_dict_from_jax(best), convert.state_dict_from_jax(first)
        assert max(np.abs(sd_a[k] - sd_b[k]).max() for k in sd_a) <= 1e-4 * 1.01
        again = pc.run_progressive(gcfg, tcfg, opts, lcfg, start_stage=1, **kw)
    finally:
        loop_mod.train = real_train
    best_a = str(tmp_path / "prog" / "s8a" / "ckptdir" / "best_fid")
    assert seen == [(8, tcfg.gen_lr, None), (8, 1e-4, best_a), (8, 1e-4, best_a)]
    assert state.step == again.step == 2
    for name in ("s8a", "s8b"):
        assert {"best_fid", "resume"} <= set(os.listdir(tmp_path / "prog" / name / "ckptdir"))


# ---------------------------------------------------------------- shared by the pipelines

def loop_cfg(outdir, data):
    from cips3d_tpu_torch.train.loop import LoopConfig

    return LoopConfig(outdir=str(outdir), data_path=data, eval_every=2, log_every=1,
                      num_images_real_eval=4, num_images_gen_eval=4, eval_batch_size=2,
                      fixed_z_bs=2, num_workers=1, device="cpu", debug=True)


def assert_same_trees(a, b):
    """Two nested dicts of arrays with the same keys, equal bit for bit."""
    fa, fb = (dict(jax.tree_util.tree_leaves_with_path(x)) for x in (a, b))
    assert fa.keys() == fb.keys()
    for k, v in fa.items():
        np.testing.assert_array_equal(np.asarray(fb[k]), np.asarray(v), err_msg=str(k))


def random_adam(params, count, seed):
    """optax's Adam state over ``params`` with the given count and random
    moments (nu positive)."""
    rng = np.random.default_rng(seed)
    st = optax.adam(1e-3).init(params)[0]
    mu = jax.tree_util.tree_map(lambda x: rng.standard_normal(x.shape).astype(np.float32),
                                st.mu)
    nu = jax.tree_util.tree_map(lambda x: rng.uniform(0, 1, x.shape).astype(np.float32), st.nu)
    return (st._replace(count=np.asarray(count, np.int32), mu=mu, nu=nu), optax.EmptyState())


def trade_snapshots(tmp_path, data, make_port, jax_pipe, jax_state):
    """A two-step port run of ``make_port()``: its trees, an exact resume,
    its resume tree loaded by the JAX package into ``jax_pipe``'s refs;
    then a JAX resume tree (``jax_state``'s modules, random Adam moments)
    resumed by the port bit for bit.  Returns the port's first run state
    and the trees the JAX package read back."""
    from cips3d_tpu_torch.train.loop import run_pipeline

    first = run_pipeline(make_port(), loop_cfg(tmp_path / "run", data))
    assert first.step == 2
    ckpt = tmp_path / "run" / "ckptdir"
    resume_names = set(os.listdir(ckpt / "resume"))
    pipe = make_port()
    assert {f"{n}.npz" for n in pipe.module_names + pipe.opt_names} <= resume_names
    assert {"0Gz.jpg", "0Gz_ema.jpg", "0Gz_tilted_ema.jpg"} <= resume_names
    assert {f"{n}.npz" for n in pipe.module_names} <= set(os.listdir(ckpt / "best_fid"))
    logs = os.listdir(tmp_path / "run" / "textdir")
    assert "eval.FID_surrogate.FID_surrogate.log" in logs and "train.g_loss.g_loss.log" in logs
    assert len(os.listdir(tmp_path / "run" / "fid" / "fake")) == 16

    # exact resume: every module and every Adam state as the snapshot carries them (all
    # the forward reads; the reference's unused LayerNorms and early ToRGB heads are not)
    resumed = run_pipeline(pipe, loop_cfg(tmp_path / "run", data), resume=True)
    assert resumed.step == 2
    assert_same_trees(pipe.modules(first), pipe.modules(resumed))
    opts = pipe.opt_states(resumed)
    assert_same_trees(pipe.opt_states(first), opts)
    assert all(int(o["0"]["count"]) == 2 for o in opts.values())

    refs = dict(jax_pipe.module_refs(jax_state), **jax_pipe.opt_refs(jax_state))
    read = JaxManager(str(ckpt)).load_snapshot("resume", refs)
    for o in jax_pipe.opt_refs(jax_state):
        assert int(read[o][0].count) == 2, o

    # the other way: a JAX resume tree at step 2 (no step left to run under debug)
    jmods = jax.tree_util.tree_map(np.asarray, jax_pipe.module_refs(jax_state))
    jopts = {o: random_adam(p, 5, i) for i, (o, p) in enumerate(
        (o, jmods[{"g_opt": "generator", "d_opt": "discriminator",
                   "cam_opt": "cam_param"}[o]]) for o in jax_pipe.opt_refs(jax_state))}
    JaxManager(str(tmp_path / "jax" / "ckptdir")).save_snapshot(
        "resume", dict(jmods, **jopts), {"step": 2, "best_fid": 9.0, "cur_fid": 9.0})
    pipe = make_port()
    state = run_pipeline(pipe, loop_cfg(tmp_path / "jax", data), resume=True)
    assert state.step == 2
    mine = pipe.modules(state)
    for name, tree in jmods.items():   # the port's pi-GAN D writes blocks the JAX D lacks
        flat = dict(jax.tree_util.tree_leaves_with_path(mine[name]))
        for k, v in jax.tree_util.tree_leaves_with_path(tree):
            np.testing.assert_array_equal(flat[k], v, err_msg=f"{name} {k}")
    mine = pipe.opt_states(state)
    for name, (st, _) in jopts.items():
        assert int(mine[name]["0"]["count"]) == 5
        for part in ("mu", "nu"):
            for k, v in jax.tree_util.tree_leaves_with_path(getattr(st, part)):
                got = dict(jax.tree_util.tree_leaves_with_path(mine[name]["0"][part]))[k]
                np.testing.assert_array_equal(got, v, err_msg=f"{name} {part} {k}")
    return first, read
