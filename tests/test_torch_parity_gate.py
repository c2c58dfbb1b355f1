"""The port's preflight gate (`cips3d_tpu_torch/tools/parity_gate.py`),
counterpart of tests/test_parity_gate.py: with nothing present it exits 1
with a manifest naming the three artifacts; it reads a zip the JAX package
wrote; flags override the search; it validates a checkpoint the port
exported; and its self-test runs every stage on synthesized artifacts on
the CPU."""

import numpy as np
import pytest

from cips3d_tpu_torch.tools import parity_gate


@pytest.fixture
def bare(tmp_path, monkeypatch):
    """An empty working directory and home, no artifact variables."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path))
    for var in ("CIPS3D_INCEPTION_WEIGHTS", "CIPS3D_FFHQ_ZIP", "CIPS3D_REFERENCE_CKPT"):
        monkeypatch.delenv(var, raising=False)
    return tmp_path


def test_dry_run_names_all_missing(bare, capsys):
    rc = parity_gate.main(["--dry-run"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "FFHQ data:        MISSING" in out
    assert "weights-inception-2015-12-05-6726825d.pth" in out
    assert "train_ffhq_high-20220105_143314_190" in out
    assert "torch-fidelity/releases" in out
    assert "python -m cips3d_tpu_torch.data.dataset_tool" in out


def test_zip_probe(tmp_path, capsys):
    from cips3d_tpu.data.zip_dataset import write_stylegan_zip

    rng = np.random.default_rng(0)
    zp = tmp_path / "ffhq_256.zip"
    write_stylegan_zip(
        str(zp), [rng.integers(0, 255, (16, 16, 3), dtype=np.uint8) for _ in range(4)]
    )
    assert parity_gate.check_data(str(zp))
    assert "4 images at 16x16" in capsys.readouterr().out


def test_probe_flag_overrides(bare):
    from cips3d_tpu_torch.data.zip_dataset import write_stylegan_zip

    rng = np.random.default_rng(0)
    zp = bare / "d.zip"
    write_stylegan_zip(str(zp), [rng.integers(0, 255, (8, 8, 3), dtype=np.uint8)
                                 for _ in range(2)])
    ckpt = bare / "G.pth"
    ckpt.write_bytes(b"")
    ns = parity_gate.argparse.Namespace(data=str(zp), inception=str(ckpt), ckpt=[str(ckpt)])
    assert parity_gate.probe(ns) == (str(zp), str(ckpt), [str(ckpt)])
    ns = parity_gate.argparse.Namespace(data=str(bare / "absent.zip"), inception=None, ckpt=None)
    assert parity_gate.probe(ns) == (None, None, [])


def test_check_checkpoint_on_a_port_export(tmp_path, capsys):
    """A seeded full-width generator exported by the port passes the
    conversion, the exact round trip, the strict load and the forward."""
    import torch

    from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR
    from cips3d_tpu_torch.utils.convert_torch import export_reference_checkpoint_dir

    gen = GeneratorNerfINR(GeneratorConfig(), generator=torch.Generator().manual_seed(0))
    export_reference_checkpoint_dir(str(tmp_path), gen)
    assert parity_gate.check_checkpoint(str(tmp_path / "G_ema_model.pth"), device="cpu")
    out = capsys.readouterr().out
    assert "reverse round-trip: exact on 172 shared tensors" in out
    assert "strict load + forward on cpu: images (2, 3, 16, 16) (OK)" in out
    assert "reference-class check left out" in out


def test_self_test_end_to_end(tmp_path, capsys):
    """--self-test runs every stage (dataset check, Inception weights and
    features, checkpoint conversion and load, the N/N FID protocol) on
    synthesized artifacts."""
    rc = parity_gate.main(["--self-test", "--outdir", str(tmp_path / "gate"), "--device", "cpu",
                           "--num-images", "8", "--img-size", "16", "--num-steps", "3"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "self-test: ALL STAGES PASSED" in out and "FID = " in out
    assert len(list((tmp_path / "gate" / "fid" / "real").glob("*.png"))) == 8
    assert len(list((tmp_path / "gate" / "fid" / "fake").glob("*.png"))) == 8
