"""The port's reference-checkpoint path (`cips3d_tpu_torch/utils/convert_torch.py`)
against the JAX package's (`cips3d_tpu/utils/convert_torch.py`).

``.pth`` files are written by the JAX converter from JAX parameters (the
released checkpoints are not in the repository) in four forms: plain,
wrapped in ``{"state_dict": ...}``, with the ``to_rbgs`` spelling, and with
``out_linear`` (``inr_pre_rgb_dim`` 4).  The port's conversion equals JAX's
bit for bit, key for key; `load_reference_generator` loads strictly and its
forward matches JAX's on JAX-converted params (fp32 rtol 1e-4 / atol 1e-5,
as tests/test_torch_models.py); the JAX converter reads the port's
exported directory back to the original params bit for bit.  Last, the new
modules import with JAX and the JAX package blocked.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cips3d_tpu.apps.render import render_chunked_traced
from cips3d_tpu.models.generator import GeneratorConfig as JaxConfig
from cips3d_tpu.models.generator import GeneratorNerfINR as JaxGenerator
from cips3d_tpu.models.generator import RenderOptions as JaxOptions
from cips3d_tpu.models.generator import sample_zs as jax_sample_zs
from cips3d_tpu.utils import convert_torch as jct
from cips3d_tpu_torch.apps.render import render_chunked
from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR, RenderOptions
from cips3d_tpu_torch.ops.ray_tile import RayDraws
from cips3d_tpu_torch.utils import convert_torch as pct
from cips3d_tpu_torch.utils.checkpoint import flatten
from cips3d_tpu_torch.utils.convert import jax_tree_from_state_dict

MOD_TOL = dict(rtol=1e-4, atol=1e-5)
TINY = dict(z_dim_nerf=16, z_dim_inr=32, nerf_hidden_dim=32, nerf_style_dim=32,
            nerf_rgb_dim=16, nerf_mapping_layers=3, inr_hidden_dim=32, inr_style_dim=32,
            inr_mapping_layers=3)
LAYERS = dict(nerf_mapping_layers=3, inr_mapping_layers=3)
SERVING = dict(fused_ray=True, fused_inr=True, fast_sin=True)
FORMS = ["plain", "wrapped", "to_rbgs", "out_linear"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _init(pre_rgb):
    cfg = JaxConfig(**TINY, inr_pre_rgb_dim=pre_rgb)
    zs = jax_sample_zs(jax.random.PRNGKey(0), 1, cfg)
    params = JaxGenerator(cfg=cfg).init(jax.random.PRNGKey(10 + pre_rgb), zs,
                                        jax.random.PRNGKey(2), JaxOptions(img_size=8, num_steps=4))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """{form: (JAX params, .pth path)}, the files written by the JAX converter."""
    root = tmp_path_factory.mktemp("ckpts")
    p3, p4 = _init(3), _init(4)
    out = {}
    for form in FORMS:
        params = p4 if form == "out_linear" else p3
        path = str(root / f"{form}.pth")
        sd = jct.export_generator_state_dict(params, rgb_attr="to_rbgs" if form == "to_rbgs"
                                             else "to_rgbs")
        if form == "wrapped":
            torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v))
                                       for k, v in sd.items()}, "epoch": 3}, path)
        else:
            jct.save_torch_checkpoint(sd, path)
        out[form] = params, path
    return out


def _cfg(form, flags=None):
    return GeneratorConfig(**TINY, inr_pre_rgb_dim=4 if form == "out_linear" else 3,
                           **(flags or {}))


def _assert_trees_equal(got, ref):
    got, ref = flatten(got), flatten(ref)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("form", FORMS)
def test_convert_generator_state_dict_matches_jax(ckpts, form):
    _, path = ckpts[form]
    ref = jct.convert_generator_checkpoint(path, **LAYERS)
    _assert_trees_equal(pct.convert_generator_checkpoint(path, **LAYERS), ref)
    # a to_rgb for every block, the three dead ones too; out_linear from tanh.0
    inr = ref["params"]["inr_net"]
    assert sum(k.startswith("to_rgb_") for k in inr) == 9
    assert ("out_linear" in inr) == (form == "out_linear")


@pytest.mark.parametrize("rgb_attr", ["to_rgbs", "to_rbgs"])
def test_export_generator_state_dict_matches_jax(ckpts, rgb_attr):
    params, _ = ckpts["plain"]
    ref = jct.export_generator_state_dict(params, rgb_attr=rgb_attr)
    got = pct.export_generator_state_dict(params, rgb_attr=rgb_attr)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("form", FORMS)
def test_load_reference_generator_is_exact(ckpts, form):
    _, path = ckpts[form]
    gen = pct.load_reference_generator(path, _cfg(form), device="cpu")
    assert not gen.training and gen.device.type == "cpu"
    src = {k.replace("to_rbgs", "to_rgbs"): v for k, v in pct.load_torch_checkpoint(path).items()}
    own = gen.state_dict()
    assert sorted(own) == sorted(src)
    for k, v in own.items():
        np.testing.assert_array_equal(v.numpy(), src[k], err_msg=k)


def test_load_reference_generator_fills_and_refuses(ckpts, tmp_path):
    """The identity LayerNorms and dead heads a file leaves out are filled;
    a missing weight or an unexpected key raises, naming it."""
    params, path = ckpts["plain"]
    sd = pct.load_torch_checkpoint(path)
    thin = {k: v for k, v in sd.items()
            if ".norm." not in k and not k.startswith(("inr_net.to_rgbs.4.", "inr_net.to_rgbs.16."))}
    pct.save_torch_checkpoint(thin, str(tmp_path / "thin.pth"))
    gen = pct.load_reference_generator(str(tmp_path / "thin.pth"), _cfg("plain"), device="cpu")
    for k, v in gen.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    bad = dict(sd, extra_head=np.zeros(3, np.float32))
    del bad["siren.final_layer.weight"]
    pct.save_torch_checkpoint(bad, str(tmp_path / "bad.pth"))
    with pytest.raises(KeyError, match=r"siren\.final_layer\.weight.*extra_head"):
        pct.load_reference_generator(str(tmp_path / "bad.pth"), _cfg("plain"), device="cpu")


def _chunk_draws(key, b, chunk, S):
    k_pdf, _, _ = jax.random.split(key, 3)
    u = jax.random.uniform(k_pdf, (b * chunk, S), jnp.float32).reshape(b, chunk, S)
    return RayDraws(t(u), torch.zeros(b, chunk, S), torch.zeros(b, chunk, 2 * S))


@pytest.mark.parametrize("form,flags", [("to_rbgs", "serving"), ("out_linear", "unfused")])
def test_loaded_forward_matches_jax(ckpts, form, flags):
    """The loaded generator's chunked render (explicit camera, two chunks)
    against JAX's on the params JAX converts from the same file: the
    serving flags (their plain versions here) or the unfused path."""
    _, path = ckpts[form]
    fl = SERVING if flags == "serving" else {}
    jcfg = JaxConfig(**TINY, inr_pre_rgb_dim=4 if form == "out_linear" else 3, **fl)
    jgen = JaxGenerator(cfg=jcfg)
    params = jct.convert_generator_checkpoint(path, **LAYERS)
    gen = pct.load_reference_generator(path, _cfg(form, fl), device="cpu")

    size, S, fp, b = 8, 6, 32, 1
    opts = dict(img_size=size, num_steps=S, h_stddev=0.0, v_stddev=0.0,
                hierarchical_sample=flags == "serving")
    pos = np.array([[0.25, 0.15, 0.956]], np.float32)
    pos /= np.linalg.norm(pos)
    zs = jax_sample_zs(jax.random.PRNGKey(5), b, jcfg)
    jst = jgen.apply(params, zs["z_nerf"], zs["z_inr"], method=jgen.mapping)
    with torch.no_grad():
        st = gen.mapping(t(zs["z_nerf"]), t(zs["z_inr"]))
    for k in jst:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]), **MOD_TOL)

    key = jax.random.PRNGKey(7)
    ref_img, ref_dep = render_chunked_traced(
        params, jgen, jst, JaxOptions(**opts), key, fp, jnp.asarray(pos), jnp.asarray(-pos),
        None, True)
    k_rays, k_pts = jax.random.split(key)
    k_perturb, _ = jax.random.split(k_rays)
    uniform = jax.random.uniform(k_perturb, (b, size * size, S, 1), jnp.float32)
    draws = None
    if flags == "serving":
        draws = [_chunk_draws(k, b, fp, S) for k in jax.random.split(k_pts, size * size // fp)]
    with torch.no_grad():
        img, dep = render_chunked(gen, st, RenderOptions(**opts), None, fp, t(pos), t(-pos),
                                  None, return_depth=True, perturb_uniform=t(uniform),
                                  chunk_draws=draws)
    assert img.shape == (b, 3, size, size)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref_img), **MOD_TOL)
    np.testing.assert_allclose(dep.numpy(), np.asarray(ref_dep), **MOD_TOL)


def test_export_reference_checkpoint_dir_read_by_jax(ckpts, tmp_path):
    """The port's directory, from JAX trees and from a port generator, read
    by the JAX converter: the original params bit for bit, the JAX
    function's file names and its info.txt byte for byte."""
    params, _ = ckpts["plain"]
    ema = jax.tree_util.tree_map(lambda a: a * np.float32(0.5), params)
    d_sd = {"convs.0.weight": np.arange(6, dtype=np.float32).reshape(2, 3)}
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    pct.export_reference_checkpoint_dir(str(port_dir), ema, generator=params,
                                        info_msg="iter 645500", discriminator=d_sd)
    jct.export_reference_checkpoint_dir(str(jax_dir), ema, generator=params,
                                        info_msg="iter 645500", discriminator=d_sd)
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir)) == [
        "G_ema_model.pth", "discriminator_model.pth", "generator_model.pth", "info.txt"]
    assert (port_dir / "info.txt").read_bytes() == (jax_dir / "info.txt").read_bytes()
    for name, src in (("G_ema", ema), ("generator", params)):
        back = flatten(jct.convert_generator_checkpoint(str(port_dir / f"{name}_model.pth"),
                                                        **LAYERS))
        orig = flatten(src)
        for k, v in orig.items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)
        # beyond the original: the three dead heads, zero
        extra = sorted(set(back) - set(orig))
        assert len(extra) == 6 and all(not back[k].any() for k in extra)
    d_back = torch.load(str(port_dir / "discriminator_model.pth"))
    np.testing.assert_array_equal(d_back["convs.0.weight"].numpy(), d_sd["convs.0.weight"])

    # a port generator: its state dict as it is, read back by JAX key for key
    gen = GeneratorNerfINR(GeneratorConfig(**TINY), generator=torch.Generator().manual_seed(2))
    pct.export_reference_checkpoint_dir(str(tmp_path / "mod"), gen)
    back = jct.convert_generator_checkpoint(str(tmp_path / "mod" / "G_ema_model.pth"), **LAYERS)
    want = flatten(jax_tree_from_state_dict(gen.state_dict()))
    got = flatten(back)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    for res in ("4", "8", "16"):   # the dead heads travel too
        np.testing.assert_array_equal(back["params"]["inr_net"][f"to_rgb_{res}"]["linear"]["kernel"],
                                      gen.inr_net.to_rgbs[res].linear.weight.detach().numpy().T)


def test_new_modules_import_without_jax():
    """The port's new modules load with `jax`, `flax` and the JAX package
    blocked."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'cips3d_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import cips3d_tpu_torch.utils.convert_torch, cips3d_tpu_torch.tools.parity_gate\n"
            "import cips3d_tpu_torch.models.legacy, cips3d_tpu_torch.models.nerf_variants\n"
            "assert not any(m.split('.')[0] in ('jax', 'flax', 'cips3d_tpu') and sys.modules[m]\n"
            "               for m in sys.modules)\n"
            "print('imported')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       timeout=120, cwd=REPO)
    assert p.returncode == 0 and "imported" in p.stdout, p.stderr
