"""The port's evaluation CLI (`python -m cips3d_tpu_torch.eval.cli`) on the
CPU: each of the JAX CLI's six modes, with ``--device cpu`` and a tiny
``--config`` YAML, on a snapshot the JAX package's writer wrote; ``fid``'s refusal
without InceptionV3 weights; the render server's ``--config/--command``.

The two packages draw their latents differently from a seed, so this file
checks what each mode writes (files, sizes, frame counts, metric names);
the apps' frames are held against the JAX package's in
`tests/test_torch_apps.py`.
"""

import ast
import json
import os
import re

import numpy as np
import pytest
import torch

from cips3d_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager
from cips3d_tpu_torch.data.zip_dataset import write_stylegan_zip
from cips3d_tpu_torch.eval import cli
from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR
from cips3d_tpu_torch.utils import image_io, video
from cips3d_tpu_torch.utils.convert import jax_tree_from_state_dict

TINY = dict(z_dim_nerf=16, z_dim_inr=32, nerf_hidden_dim=16, nerf_style_dim=16,
            nerf_rgb_dim=16, nerf_mapping_layers=2, inr_hidden_dim=32, inr_style_dim=32,
            inr_mapping_layers=2)
YAML = "train_base:\n  generator:\n" + "".join(f"    {k}: {v}\n" for k, v in TINY.items()) + \
    "train_r64:\n  base: train_base\n  generator:\n    fast_sin: true\n"
SIZE = 8


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A tiny config, a JAX-layout snapshot of it and a 6-image zip."""
    root = tmp_path_factory.mktemp("eval_cli")
    (root / "tiny.yaml").write_text(YAML)
    # weights from the port's seeded init, written by the JAX package's snapshot writer
    gen = GeneratorNerfINR(GeneratorConfig(**TINY), generator=torch.Generator().manual_seed(1))
    JaxCheckpointManager(str(root / "ckptdir")).save_snapshot(
        "best_fid", {"G_ema": jax_tree_from_state_dict(gen.state_dict())})
    rng = np.random.default_rng(0)
    write_stylegan_zip(str(root / "d.zip"),
                       [rng.integers(0, 255, (16, 16, 3), dtype=np.uint8) for _ in range(6)])
    common = ["--ckpt", str(root / "ckptdir" / "best_fid"), "--config", str(root / "tiny.yaml"),
              "--command", "train_r64", "--device", "cpu", "--img-size", str(SIZE),
              "--num-steps", "3"]
    return root, common


def _main(run, capsys, mode, *extra, serving=True):
    root, common = run
    assert cli.main([mode, *common, *(["--serving"] if serving else []), *extra]) == 0
    return capsys.readouterr().out


def test_generator_config_reads_the_command_node(run):
    root, _ = run
    assert cli.generator_config() == GeneratorConfig()
    got = cli.generator_config(str(root / "tiny.yaml"), "train_r64")
    assert got == GeneratorConfig(**TINY, fast_sin=True)
    assert cli.generator_config(str(root / "tiny.yaml")) == GeneratorConfig(**TINY)
    assert cli.serving_config(got) == GeneratorConfig(**TINY, fast_sin=True, fused_ray=True,
                                                      fused_inr=True)
    assert cli.parse_args(["gen", "--ckpt", "x"]).device == "cuda"


@pytest.mark.parametrize("serving", [True, False], ids=["serving", "plain"])
def test_fid_with_the_surrogate(run, capsys, serving, monkeypatch, tmp_path):
    monkeypatch.setenv("CIPS3D_INCEPTION_WEIGHTS", str(tmp_path / "absent.pth"))
    monkeypatch.setenv("HOME", str(tmp_path))
    root, _ = run
    out_dir = str(tmp_path / "ev")
    out = _main(run, capsys, "fid", "--data", str(root / "d.zip"), "--num-images", "6",
                "--batch-size", "4", "--out", out_dir, "--allow-surrogate", "--kid",
                serving=serving)
    metrics = ast.literal_eval(out.splitlines()[0])   # the dict the CLI prints
    assert set(metrics) == {"FID_surrogate", "KID_surrogate"}
    assert all(np.isfinite(v) for v in metrics.values())
    assert len(os.listdir(os.path.join(out_dir, "fid/real"))) == 6
    assert len(os.listdir(os.path.join(out_dir, "fid/fake"))) == 6


def test_fid_refuses_without_inception_weights(run, capsys, monkeypatch, tmp_path):
    """The JAX CLI's refusal (`eval/fid.py:134-140`), before any image is
    rendered."""
    monkeypatch.setenv("CIPS3D_INCEPTION_WEIGHTS", str(tmp_path / "absent.pth"))
    monkeypatch.setenv("HOME", str(tmp_path))
    root, _ = run
    with pytest.raises(SystemExit, match="InceptionV3 weights are unavailable"):
        _main(run, capsys, "fid", "--data", str(root / "d.zip"), "--num-images", "6",
              "--out", str(tmp_path / "ev"))
    assert not os.path.exists(tmp_path / "ev")


@pytest.mark.parametrize("mode", ["gen", "sample"])
def test_image_dumps(run, capsys, mode, tmp_path):
    out = _main(run, capsys, mode, "--num-images", "5", "--batch-size", "4", "--out",
                str(tmp_path))
    assert f"wrote 5 images to {tmp_path}" in out
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 5
    assert image_io.read_png(str(tmp_path / files[0])).shape == (SIZE, SIZE, 3)


def test_multiview_grid(run, capsys, tmp_path):
    path = str(tmp_path / "grid.png")
    _main(run, capsys, "multiview", "--seeds", "0", "3", "--out", path)
    grid = image_io.read_png(path)
    assert grid.shape == (2 * SIZE, 5 * SIZE, 3) and grid.std() > 0


def test_trajectory_video_with_depth(run, capsys, tmp_path):
    out = _main(run, capsys, "trajectory", "--trajectory-mode", "translate_rotate",
                "--num-frames", "6", "--depth", "--seeds", "2", "--out", str(tmp_path))
    assert "wrote 6 frames" in out and "MJPEG-AVI" in out
    names = set(os.listdir(tmp_path))
    assert {f"frame_{i:04d}.png" for i in range(6)} <= names
    assert {f"depth_{i:04d}.png" for i in range(6)} <= names
    for avi, prefix in (("video.avi", "frame"), ("depth.avi", "depth")):
        frames = video.read_mjpeg_avi(str(tmp_path / avi))
        assert len(frames) == 6
        for i, f in enumerate(frames):   # each JPEG frame decodes near its PNG
            png = image_io.to_rgb(image_io.read_png(str(tmp_path / f"{prefix}_{i:04d}.png")))
            assert f.shape == png.shape and np.abs(f.astype(np.int16) - png).mean() <= 2


def test_viewer_html(run, capsys, tmp_path):
    _main(run, capsys, "viewer", "--seeds", "0", "1", "--depth", "--out", str(tmp_path))
    html = (tmp_path / "viewer.html").read_text()
    for name in ("F", "D"):
        grid = json.loads(re.search(rf"const {name} = (.*?);", html).group(1))
        assert np.array(grid).shape == (2, 3, 9)   # seeds x pitches x yaws


def test_serve_reads_the_config(run, monkeypatch):
    """`apps/serve.py --config/--command`: the generator node of the YAML,
    with the serving flags (``--exact``: exact sine in the same kernels)."""
    from cips3d_tpu_torch.apps import serve

    root, _ = run
    seen = []

    class Stop(Exception):
        pass

    def fake_load(path, gen_cfg, module, device):
        seen.append(gen_cfg)
        raise Stop

    monkeypatch.setattr(cli, "load_generator", fake_load)
    for extra, fast_sin in (([], True), (["--exact"], False)):
        with pytest.raises(Stop):
            serve.main(["--ckpt", "x", "--config", str(root / "tiny.yaml"), "--command",
                        "train_r64", *extra])
        assert seen[-1] == GeneratorConfig(**TINY, fast_sin=fast_sin, fused_ray=True,
                                           fused_inr=True)
