"""The port's InceptionV3 FID extractor (`cips3d_tpu_torch/eval/inception.py`)
against the JAX package's (`cips3d_tpu/eval/inception.py`), and the FID
extractor choice (`eval/fid.py::default_extractor`).

Random weights in torch-fidelity's layout (BN statistics and affine drawn
too, so inference BN is exercised) go through the JAX package's converter
into its tree, and from that tree through `utils/convert.py::
inception_state_dict` into the port, so both bridges are exercised.  One
uint8 image passes through each package's whole extractor (TF1 resize to
299, (x - 128) / 128, pool3).  Tolerances: the TF1 resize matrix equal,
the resize within fp32 rtol 1e-6; pool3 features rtol 1e-4 with atol
1e-5 x max|features| (f32 convolutions summed in another order).
"""

import numpy as np
import pytest
import torch

from cips3d_tpu.eval import inception as ji
from cips3d_tpu_torch.eval import fid as pf
from cips3d_tpu_torch.eval import inception as pi
from cips3d_tpu_torch.utils.convert import inception_state_dict, to_torch


@pytest.fixture(scope="module")
def weights():
    """torch-fidelity-named random weights: a state dict and the JAX tree."""
    rng = np.random.default_rng(0)
    sd = {}
    for k, v in pi.InceptionV3().state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        shape = tuple(v.shape)
        if k.endswith("conv.weight"):
            sd[k] = (rng.standard_normal(shape) * 0.05).astype(np.float32)
        elif k.endswith(("bn.weight", "bn.running_var")):
            sd[k] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:
            sd[k] = rng.uniform(-0.2, 0.2, shape).astype(np.float32)
    tree = {m: {k: np.asarray(v) for k, v in b.items()} if "w" in b else
            {br: {k: np.asarray(v) for k, v in p.items()} for br, p in b.items()}
            for m, b in ji.convert_inception_state_dict(sd).items()}
    return sd, tree


def test_bridge_round_trips_the_state_dict(weights):
    sd, tree = weights
    got = inception_state_dict(tree)
    assert sorted(got) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(got[k], sd[k])
    # strict: every parameter and statistic (BN adds its step counter itself)
    pi.InceptionV3().load_state_dict(to_torch(got), strict=True)


def test_tf1x_resize_matches_jax():
    for n_in, n_out in ((64, 299), (5, 11), (300, 299), (7, 3)):
        np.testing.assert_array_equal(pi.tf1x_resize_matrix(n_in, n_out),
                                      ji.tf1x_resize_matrix(n_in, n_out))
    x = np.random.default_rng(1).uniform(0, 255, (2, 9, 13, 3)).astype(np.float32)
    np.testing.assert_allclose(pi.tf1x_resize(torch.from_numpy(x), 17, 6).numpy(),
                               np.asarray(ji.tf1x_resize(x, 17, 6)), rtol=1e-6, atol=1e-4)


def test_pool3_features_match_jax(weights, tmp_path, monkeypatch):
    """One image through both whole extractors; then the real loading path:
    a torch-fidelity-style .pth (with its classifier head) found through
    ``$CIPS3D_INCEPTION_WEIGHTS`` makes `default_extractor` pick InceptionV3."""
    sd, tree = weights
    img = np.random.default_rng(2).integers(0, 256, (1, 24, 24, 3), dtype=np.uint8)
    ref = ji.InceptionV3Features(params=tree, batch_jit=False)(img)
    model = pi.InceptionV3()
    model.load_state_dict(to_torch(inception_state_dict(tree)), strict=True)
    got = pi.InceptionV3Features(model=model, device="cpu")(img)
    assert got.shape == ref.shape == (1, 2048)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())

    pth = tmp_path / "weights-inception-2015-12-05-6726825d.pth"
    torch.save(dict(to_torch(sd), **{"fc.weight": torch.zeros(1008, 2048),
                                     "fc.bias": torch.zeros(1008)}), pth)
    monkeypatch.setenv("CIPS3D_INCEPTION_WEIGHTS", str(pth))
    assert pi.find_weights() == str(pth) == ji.find_weights()
    extractor = pf.default_extractor(require_reference=True, device="cpu")
    assert isinstance(extractor, pi.InceptionV3Features)
    assert extractor.metric_name == "FID"
    np.testing.assert_array_equal(extractor(img), got)


def test_default_extractor_without_weights(monkeypatch, tmp_path):
    """Without the checkpoint: the surrogate, or the JAX package's refusal."""
    monkeypatch.setenv("CIPS3D_INCEPTION_WEIGHTS", str(tmp_path / "absent.pth"))
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    assert pi.find_weights() is None
    assert pf.default_extractor(device="cpu").metric_name == "FID_surrogate"
    with pytest.raises(RuntimeError, match=r"InceptionV3 weights are unavailable \(set "
                                           r"\$CIPS3D_INCEPTION_WEIGHTS\)"):
        pf.default_extractor(require_reference=True)
    with pytest.raises(FileNotFoundError):
        pi.InceptionV3Features(str(tmp_path / "absent.pth"), device="cpu")
