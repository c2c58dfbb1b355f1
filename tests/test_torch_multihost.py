"""The port's training loop, `render_sharded` and the process-group helpers
on two processes (`cips3d_tpu_torch/parallel/mesh.py`): the counterpart of
`tests/test_multihost.py`.

Two OS processes join a gloo group on 127.0.0.1 through the ``CIPS3D_*``
env of the training CLI and import torch and the port only:

  * the training CLI's debug stage at tiny widths on a `data.synthetic`
    zip, with ``ray_shards`` 1 and 2: both exit 0, rank 0 alone writes the
    snapshots and computes the FID, both ranks write their interleaved shard
    of the eval images;
  * `render_sharded` over both ranks (pixels over the world, and over a ray
    group of two) against `render_frame` in one process on the same draws,
    its program route against its eager call bit for bit;
  * `host_barrier`: one both reach, one a peer never reaches, which fails
    within its timeout naming the barrier and the rank.

    python tests/test_torch_multihost.py cli <record> <cli args...>   # one rank, from the env
    python tests/test_torch_multihost.py render <out.pt>
    python tests/test_torch_multihost.py barrier
"""

import os
import sys
import time

import torch

IMG = 8
GCFG = dict(z_dim_nerf=16, z_dim_inr=32, nerf_hidden_dim=16, nerf_style_dim=16,
            nerf_mapping_layers=2, inr_hidden_dim=32, inr_style_dim=32, inr_mapping_layers=2)
SERVING = dict(fast_sin=True, fused_ray=True, fused_inr=True)


# ---------------------------------------------------------------- one rank's side

def note(record, line):
    with open(f"{record}.{os.environ['CIPS3D_PROCESS_ID']}", "a") as f:
        f.write(line + "\n")


def cli_worker(record, *argv):
    """The training CLI, with each snapshot, backup, eval shard and FID of
    this rank appended to ``record``.{rank}."""
    from cips3d_tpu_torch.train import cli, loop
    from cips3d_tpu_torch.utils.checkpoint import CheckpointManager

    def wrap(owner, name, fmt):
        orig = getattr(owner, name)

        def wrapped(*a, **kw):
            note(record, fmt(*a, **kw))
            return orig(*a, **kw)

        setattr(owner, name, wrapped)

    wrap(CheckpointManager, "save_snapshot", lambda self, name, *a, **kw: f"snapshot {name}")
    wrap(CheckpointManager, "save_backup", lambda self, *a, **kw: "backup")
    wrap(loop, "eval_fid", lambda *a, **kw: "fid")
    wrap(loop, "gen_images", lambda *a, shard_index=0, num_shards=1, **kw:
         f"fakes {shard_index} of {num_shards}")
    torch.set_num_threads(2)
    rc = cli.main(list(argv))
    assert "jax" not in sys.modules and "cips3d_tpu" not in sys.modules
    return rc


def profile_worker(record, *argv):
    """The training CLI with a chunk that stands in for a captured one (a
    gloo group's is eager): where a captured chunk would capture and release
    its graph, by step, appended to ``record``.{rank}."""
    from cips3d_tpu_torch.train import chunk, loop

    class Captured(chunk.EagerChunk):
        captured, graph = True, None

        def capture(self):
            self.graph = True
            note(record, f"capture at step {self.state.step}")

        def close(self):
            if self.graph:
                note(record, f"release at step {self.state.step}")
            self.graph = None

        def __call__(self, reals, draws=None):
            if self.graph is None:
                self.capture()
            return super().__call__(reals, draws)

    loop.make_chunk_fn = lambda step_fn, state, real_shape, rng, mesh=None, label="": \
        Captured(step_fn, state, rng)
    return cli_worker(record, *argv)


def render_worker(out):
    """`render_sharded` of one seed's frame over both ranks, with pixels over
    the world (ray_shards 1) and over one ray group of two."""
    from cips3d_tpu_torch.apps.render import Draws, render_sharded, seed_styles
    from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR, RenderOptions
    from cips3d_tpu_torch.parallel.mesh import initialize_multihost, make_mesh

    assert initialize_multihost(device="cpu")
    gen = GeneratorNerfINR(GeneratorConfig(**GCFG, **SERVING),
                           generator=torch.Generator().manual_seed(0))
    draws = Draws("cpu")
    styles = seed_styles(gen, 3, 1.0, draws)
    opts = RenderOptions(img_size=IMG, num_steps=4, h_stddev=0.0, v_stddev=0.0, nerf_noise=0.5)
    res = {(r, dispatch): render_sharded(gen, styles, opts, 5, draws, make_mesh(r),
                                         return_depth=True, dispatch=dispatch)
           for r in (1, 2) for dispatch in ("program", "eager")}
    torch.save(res, f"{out}.{torch.distributed.get_rank()}")
    torch.distributed.destroy_process_group()
    return 0


def barrier_worker():
    """A barrier both ranks reach, then one only rank 0 reaches."""
    from cips3d_tpu_torch.parallel.mesh import host_barrier, initialize_multihost

    assert initialize_multihost(device="cpu")
    assert host_barrier("both_ranks", timeout_s=60)
    if torch.distributed.get_rank() == 0:
        t0 = time.time()
        try:
            host_barrier("rank_1_never_comes", timeout_s=2)
            print("NO ERROR", flush=True)
        except RuntimeError as e:
            print(f"BARRIER ERROR after {time.time() - t0:.1f} s: {e}", flush=True)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    mode, args = sys.argv[1], sys.argv[2:]
    sys.exit({"cli": cli_worker, "profile": profile_worker, "render": render_worker,
              "barrier": barrier_worker}[mode](*args))


# ---------------------------------------------------------------- the test side

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from cips3d_tpu_torch.apps.render import (Draws, render_frame, render_sharded,  # noqa: E402
                                          seed_styles)
from cips3d_tpu_torch.models.generator import (GeneratorConfig, GeneratorNerfINR,  # noqa: E402
                                               RenderOptions)
from cips3d_tpu_torch.parallel.mesh import Mesh, host_barrier, initialize_multihost  # noqa: E402
from test_torch_parallel import launch_pair  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_OPTS = ["batch_size", "2", "fixed_z_bs", "2", "eval_batch_size", "4", "num_workers", "1",
             "grad_points", "null", "forward_points", "null", "render.num_steps", "3",
             "generator.z_dim_nerf", "16", "generator.z_dim_inr", "32",
             "generator.nerf_hidden_dim", "16", "generator.nerf_style_dim", "16",
             "generator.nerf_mapping_layers", "2", "generator.inr_hidden_dim", "32",
             "generator.inr_style_dim", "32", "generator.inr_mapping_layers", "2",
             "discriminator.max_size", "16", "discriminator.channels_override.4", "16",
             "discriminator.channels_override.8", "16",
             "discriminator.channels_override.16", "16", "img_size", str(IMG)]


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """Every pair of ranks started at once (the CLI with ray_shards 1 and 2,
    render, barrier); ``pairs(name)`` waits for one and returns its dir and
    the ranks' (returncode, output).  Teardown waits for the pairs no test
    asked for."""
    from cips3d_tpu_torch.data.synthetic import make_blob_dataset

    base = tmp_path_factory.mktemp("multihost")
    data = base / "d.zip"
    make_blob_dataset(str(data), 8, img_size=16, seed=0)
    me = os.path.abspath(__file__)
    started = {}
    for r in (1, 2):
        d = base / f"cli_r{r}"
        d.mkdir()
        args = ["cli", d / "record", "--config", os.path.join(ROOT, "configs", "ffhq.yaml"),
                "--command", "train_r32", "--debug", "--device", "cpu", "--opts", *TINY_OPTS,
                "data_path", data, "ray_shards", str(r), "outdir", d / "results"]
        started[f"cli_r{r}"] = (d, launch_pair(me, args))
    d = base / "profile"
    d.mkdir()
    args = ["profile", d / "record", "--config", os.path.join(ROOT, "configs", "ffhq.yaml"),
            "--command", "train_r32", "--device", "cpu", "--opts", *TINY_OPTS,
            "data_path", data, "outdir", d / "results", "total_iters", "7",
            "eval_every", "100", "dispatch_chunk", "2", "profile_steps", "2"]
    started["profile"] = (d, launch_pair(me, args))
    started["render"] = (base, launch_pair(me, ["render", base / "render.pt"]))
    started["barrier"] = (base, launch_pair(me, ["barrier"]))
    done = {}

    def get(name):
        if name not in done:
            d, wait = started[name]
            outs = wait()
            for rank, (rc, out) in enumerate(outs):
                assert rc == 0, f"{name} rank {rank} failed:\n{out[-4000:]}"
            done[name] = (d, outs)
        return done[name]

    yield get
    for name, (_, wait) in started.items():
        if name not in done:
            wait()


@pytest.mark.parametrize("ray_shards", [1, 2])
def test_two_ranks_run_the_training_cli(pairs, ray_shards):
    """Both ranks exit 0; rank 0 alone writes best_fid, resume and the
    backups and computes the FID; each rank writes its shard of the fakes,
    which together fill fid/fake; both ranks' reals are there."""
    d, outs = pairs(f"cli_r{ray_shards}")
    records = [(d / f"record.{r}").read_text().split("\n") for r in range(2)]
    snaps0 = {ln for ln in records[0] if ln.startswith("snapshot")}
    assert {"snapshot best_fid", "snapshot resume"} <= snaps0 and "backup" in records[0]
    assert not any(ln.startswith(("snapshot", "backup", "fid")) for ln in records[1])
    assert records[0].count("fid") == 2   # one FID an eval, two evals under --debug
    assert "fakes 0 of 2" in records[0] and "fakes 1 of 2" in records[1]
    assert "FID_surrogate=" in outs[0][1] and "FID_surrogate=" not in outs[1][1]
    assert "step 2: d_loss=" in outs[0][1]
    run = d / "results" / "train_r32"
    assert sorted(os.listdir(run / "fid" / "fake")) == [f"fake_{i:06d}.png" for i in range(16)]
    assert len(os.listdir(run / "fid" / "real")) == 8   # every image of the 8-image zip
    assert {"generator.npz", "G_ema.npz", "discriminator.npz"} <= set(
        os.listdir(run / "ckptdir" / "best_fid"))
    assert {"g_opt.npz", "d_opt.npz", "0Gz_ema.jpg"} <= set(
        os.listdir(run / "ckptdir" / "resume"))
    assert any(f.startswith("eval.FID") for f in os.listdir(run / "textdir"))


def test_two_ranks_capture_and_release_together_under_profile_steps(pairs):
    """``profile_steps`` in a group: every rank captures its chunk again
    before the profiled steps and releases it after, at the same steps (a
    capture's warm-up is a step, with its all-reduces, which the other
    ranks' steps pair with); the lead alone writes the profile."""
    d, outs = pairs("profile")
    records = [[ln for ln in (d / f"record.{r}").read_text().split("\n")
                if ln.startswith(("capture", "release"))] for r in range(2)]
    assert records[0] == records[1], records
    # step 0 alone, released for its eval; steps 1-2 a chunk; steps 3-4 profiled, captured
    # again before them and released after
    assert records[0][:6] == ["capture at step 0", "release at step 1", "capture at step 1",
                              "capture at step 3", "release at step 5", "capture at step 5"], \
        records[0]
    assert "profiler trace and summary written" in outs[0][1]
    assert "profiler trace" not in outs[1][1]
    assert os.path.exists(d / "results" / "train_r32" / "profile" / "summary.json")


def test_one_process_refuses_ray_shards(tmp_path):
    """ray_shards 2 without a second process: the JAX loop's ValueError."""
    from cips3d_tpu_torch.train.cli import main

    with pytest.raises(ValueError, match="ray_shards=2 must divide device count 1"):
        main(["--config", os.path.join(ROOT, "configs", "ffhq.yaml"), "--command", "train_r32",
              "--debug", "--device", "cpu", "--opts", *TINY_OPTS, "data_path", "none.zip",
              "ray_shards", "2", "outdir", str(tmp_path)])


def test_render_sharded_matches_render_frame(pairs):
    """Both ranks' `render_sharded` (over the world and over a ray group)
    against `render_frame` of the same seed, key and draws in one process,
    to the frame's 1e-5, and its program route (the default) against its
    eager call bit for bit; H x W not dividing by the shards raises."""
    d, _ = pairs("render")
    gen = GeneratorNerfINR(GeneratorConfig(**GCFG, **SERVING),
                           generator=torch.Generator().manual_seed(0))
    draws = Draws("cpu")
    styles = seed_styles(gen, 3, 1.0, draws)
    opts = RenderOptions(img_size=IMG, num_steps=4, h_stddev=0.0, v_stddev=0.0, nerf_noise=0.5)
    img, depth = render_frame(gen, styles, opts, 5, draws, forward_points=IMG * IMG,
                              return_depth=True)
    for rank in range(2):
        res = torch.load(d / f"render.pt.{rank}", weights_only=False)
        for (r, dispatch), (got, got_depth) in res.items():
            assert got.shape == (1, 3, IMG, IMG) and got_depth.shape == (1, 1, IMG, IMG)
            np.testing.assert_allclose(got.numpy(), img.numpy(), atol=1e-5, rtol=0)
            np.testing.assert_allclose(got_depth.numpy(), depth.numpy(), atol=1e-5, rtol=0)
            eager = res[r, "eager"]
            assert torch.equal(got, eager[0]) and torch.equal(got_depth, eager[1])
    with pytest.raises(ValueError, match="64 pixels do not divide by 3"):
        render_sharded(gen, styles, opts, 5, draws, Mesh(3, 0, 1))


def test_host_barrier_names_the_barrier_and_rank_on_timeout(pairs):
    _, outs = pairs("barrier")
    line = next(ln for ln in outs[0][1].splitlines() if ln.startswith(("BARRIER", "NO ERROR")))
    assert line.startswith("BARRIER ERROR"), line
    waited = float(line.split()[3])
    assert 2.0 <= waited < 30.0
    assert "'rank_1_never_comes'" in line and "process 0/2" in line and "timeout 2s" in line


def test_initialize_multihost_is_a_noop_without_the_env(monkeypatch):
    for k in ("CIPS3D_COORDINATOR", "CIPS3D_NUM_PROCESSES", "CIPS3D_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_multihost(device="cpu") is False
    monkeypatch.setenv("CIPS3D_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("CIPS3D_NUM_PROCESSES", "1")
    assert initialize_multihost(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert host_barrier("alone") is False
