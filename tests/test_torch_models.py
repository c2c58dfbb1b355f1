"""Parity of the port's modules (`cips3d_tpu_torch/models`, `core/rays.py`,
the parameter bridge and snapshot reading) with the JAX package.

JAX parameters go through the bridge (`utils/convert.py`) into the port;
inputs come from a numpy seed.  Module tolerance: fp32 rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cips3d_tpu.core import rays as jax_rays
from cips3d_tpu.models import init as jax_init
from cips3d_tpu.models import layers as jax_layers
from cips3d_tpu.models.generator import GeneratorConfig as JaxConfig
from cips3d_tpu.models.generator import GeneratorNerfINR as JaxGenerator
from cips3d_tpu.models.generator import RenderOptions as JaxOptions
from cips3d_tpu.models.generator import sample_zs as jax_sample_zs
from cips3d_tpu.utils.convert_torch import export_generator_state_dict
from cips3d_tpu_torch.core import rays
from cips3d_tpu_torch.models import init as winit
from cips3d_tpu_torch.models import layers
from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR
from cips3d_tpu_torch.utils.convert import load_jax_params, state_dict_from_jax

MOD_TOL = dict(rtol=1e-4, atol=1e-5)
TINY = dict(z_dim_nerf=16, z_dim_inr=32, nerf_hidden_dim=32, nerf_style_dim=32,
            nerf_rgb_dim=16, nerf_mapping_layers=3, inr_hidden_dim=32, inr_style_dim=32,
            inr_mapping_layers=3)


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


@pytest.fixture(scope="module")
def generators():
    """The same tiny generator in both packages (JAX init, bridged)."""
    cfg = JaxConfig(**TINY)
    jgen = JaxGenerator(cfg=cfg)
    zs = jax_sample_zs(jax.random.PRNGKey(0), 2, cfg)
    params = jgen.init(jax.random.PRNGKey(1), zs, jax.random.PRNGKey(2),
                       JaxOptions(img_size=8, num_steps=4))
    params = jax.tree_util.tree_map(np.asarray, params)
    port = GeneratorNerfINR(GeneratorConfig(**TINY))
    load_jax_params(port, params)
    return jgen, params, port


# ---------------------------------------------------------------- bridge

def test_bridge_matches_export_generator_state_dict(generators):
    _, params, port = generators
    ref = export_generator_state_dict(params)
    ours = state_dict_from_jax(params)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    # the port's modules have exactly the reference's key layout
    assert sorted(port.state_dict()) == sorted(ref)


def test_snapshot_written_by_jax_loads(generators, tmp_path):
    from cips3d_tpu.utils.checkpoint import CheckpointManager
    from cips3d_tpu_torch.eval.cli import load_generator

    _, params, port = generators
    CheckpointManager(str(tmp_path)).save_snapshot("best_fid", {"G_ema": params})
    loaded = load_generator(str(tmp_path / "best_fid"), GeneratorConfig(**TINY), device="cpu")
    for k, v in port.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[k], v, rtol=0, atol=0)


# ---------------------------------------------------------------- modules

def test_mapping_matches_jax(generators):
    jgen, params, port = generators
    rng = np.random.default_rng(0)
    zn = rng.standard_normal((3, TINY["z_dim_nerf"])).astype(np.float32)
    zi = rng.standard_normal((3, TINY["z_dim_inr"])).astype(np.float32)
    ref = jgen.apply(params, jnp.asarray(zn), jnp.asarray(zi), method=jgen.mapping)
    with torch.no_grad():
        out = port.mapping(t(zn), t(zi))
    assert sorted(out) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **MOD_TOL, err_msg=k)


def _styles(generators, b=2, seed=1):
    jgen, params, port = generators
    rng = np.random.default_rng(seed)
    zn = rng.standard_normal((b, TINY["z_dim_nerf"])).astype(np.float32)
    zi = rng.standard_normal((b, TINY["z_dim_inr"])).astype(np.float32)
    st = jgen.apply(params, jnp.asarray(zn), jnp.asarray(zi), method=jgen.mapping)
    return {k: np.asarray(v) for k, v in st.items()}


@pytest.mark.parametrize("fast_sin", [False, True], ids=["sin", "fast_sin"])
def test_nerf_network_matches_jax(generators, fast_sin):
    from cips3d_tpu.models.nerf_net import NeRFNetwork as JaxNeRF

    _, params, port = generators
    st = _styles(generators)
    pts = np.random.default_rng(2).uniform(-0.15, 0.15, (2, 50, 3)).astype(np.float32)
    jnet = JaxNeRF(hidden_dim=32, hidden_layers=2, rgb_dim=16, fast_sin=fast_sin)
    ref_rgb, ref_sig = jnet.apply({"params": params["params"]["siren"]}, jnp.asarray(pts),
                                  {k: jnp.asarray(v) for k, v in st.items()}, split=True)
    for layer in (*port.siren.network, port.siren.color_layer_sine):
        layer.fast_sin = fast_sin
    with torch.no_grad():
        rgb, sig = port.siren(t(pts), {k: t(v) for k, v in st.items()})
    for layer in (*port.siren.network, port.siren.color_layer_sine):
        layer.fast_sin = False
    np.testing.assert_allclose(rgb.numpy(), np.asarray(ref_rgb), **MOD_TOL)
    np.testing.assert_allclose(sig.numpy(), np.asarray(ref_sig), **MOD_TOL)


@pytest.mark.parametrize("img_size", [1024, 32], ids=["all_blocks", "early_exit"])
def test_cips_net_matches_jax(generators, img_size):
    from cips3d_tpu.models.cips_net import CIPSNet as JaxCIPS

    _, params, port = generators
    st = _styles(generators)
    x = np.random.default_rng(3).standard_normal((2, 24, 16)).astype(np.float32)
    ref = JaxCIPS(hidden_dim=32).apply({"params": params["params"]["inr_net"]},
                                       jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()},
                                       img_size=img_size)
    with torch.no_grad():
        out = port.inr_net(t(x), {k: t(v) for k, v in st.items()}, img_size=img_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MOD_TOL)


def _copy_linear(lin, tree):
    with torch.no_grad():
        lin.weight.copy_(t(np.asarray(tree["kernel"]).T))
        if "bias" in tree:
            lin.bias.copy_(t(tree["bias"]))


@pytest.mark.parametrize("name", ["torch_linear", "pixel_norm", "film_sine", "sin_style_mod",
                                  "to_rgb", "box_warp"])
def test_layer_matches_jax(name):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    style = rng.standard_normal((2, 10)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    if name == "torch_linear":
        jm = jax_layers.TorchLinear(9)
        p = jm.init(key, jnp.asarray(x))
        ref = jm.apply(p, jnp.asarray(x))
        m = layers.TorchLinear(12, 9)
        _copy_linear(m, p["params"])
        out = m(t(x))
    elif name == "pixel_norm":
        ref = jax_layers.PixelNorm().apply({}, jnp.asarray(x))
        out = layers.PixelNorm()(t(x))
    elif name == "film_sine":
        jm = jax_layers.FiLMSineLayer(9)
        p = jm.init(key, jnp.asarray(x), jnp.asarray(style))
        ref = jm.apply(p, jnp.asarray(x), jnp.asarray(style))
        m = layers.FiLMSineLayer(12, 9, 10)
        for part in ("linear", "gain_fc", "bias_fc"):
            _copy_linear(getattr(m, part), p["params"][part])
        out = m(t(x), t(style))
    elif name == "sin_style_mod":
        jm = jax_layers.SinStyleMod(9)
        p = jm.init(key, jnp.asarray(x), jnp.asarray(style))
        ref = jm.apply(p, jnp.asarray(x), jnp.asarray(style))
        m = layers.SinStyleMod(12, 9, 10)
        with torch.no_grad():
            m.weight.copy_(t(p["params"]["weight"])[None])
        _copy_linear(m.modulation, p["params"]["modulation"])
        out = m(t(x), t(style))
    elif name == "to_rgb":
        jm = jax_layers.ToRGB(3)
        skip = rng.standard_normal((2, 7, 3)).astype(np.float32)
        p = jm.init(key, jnp.asarray(x))
        ref = jm.apply(p, jnp.asarray(x), jnp.asarray(skip))
        m = layers.ToRGB(12, 3)
        _copy_linear(m.linear, p["params"]["linear"])
        out = m(t(x), t(skip))
    else:
        ref = jax_layers.uniform_box_warp(jnp.asarray(x), 0.24)
        out = layers.uniform_box_warp(t(x), 0.24)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **MOD_TOL)


@pytest.mark.parametrize("name", ["torch_linear", "frequency", "kaiming_leaky",
                                  "kaiming_fanout", "scaled", "linear_bias"])
def test_init_distribution_matches_jax(name):
    """Same distribution family and scale as the JAX initializers (the
    generators differ, so compare bounds and moments of large draws)."""
    shape = (256, 512)
    pairs = {
        "torch_linear": (jax_init.torch_linear_kernel, winit.torch_linear_kernel),
        "frequency": (jax_init.frequency_kernel(25.0), winit.frequency_kernel(25.0)),
        "kaiming_leaky": (jax_init.kaiming_leaky_kernel, winit.kaiming_leaky_kernel),
        "kaiming_fanout": (jax_init.kaiming_leaky_fanout_kernel,
                           winit.kaiming_leaky_fanout_kernel),
        "scaled": (jax_init.scaled_kernel(jax_init.torch_linear_kernel, 0.25),
                   winit.scaled_kernel(winit.torch_linear_kernel, 0.25)),
        "linear_bias": (jax_init.torch_linear_bias(77), winit.torch_linear_bias(77)),
    }
    jfn, tfn = pairs[name]
    ref = np.asarray(jfn(jax.random.PRNGKey(0), shape))
    out = tfn(shape, torch.Generator().manual_seed(0)).numpy()
    assert out.shape == shape and out.dtype == np.float32
    np.testing.assert_allclose(out.std(), ref.std(), rtol=0.02)
    assert abs(out.mean()) < 0.02 * ref.std()
    if name not in ("kaiming_leaky", "kaiming_fanout"):   # uniform: same bound
        np.testing.assert_allclose(np.abs(out).max(), np.abs(ref).max(), rtol=0.01)


def test_port_init_is_seeded():
    a = GeneratorNerfINR(GeneratorConfig(**TINY), generator=torch.Generator().manual_seed(3))
    b = GeneratorNerfINR(GeneratorConfig(**TINY), generator=torch.Generator().manual_seed(3))
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)


# ---------------------------------------------------------------- rays

@pytest.mark.parametrize("camera", ["explicit", "normal", "mean"])
def test_world_rays_match_jax(camera):
    """Rays with injected perturbation offsets and camera draws, from the
    same key splits as `get_world_points_and_direction`."""
    key = jax.random.PRNGKey(9)
    b, S, size = 2, 5, 6
    kw = dict(num_steps=S, img_size=size, fov=12.0, ray_start=0.88, ray_end=1.12,
              h_stddev=0.3, v_stddev=0.155, h_mean=1.5, v_mean=1.6,
              sample_dist="gaussian" if camera == "explicit" else camera)
    cam = {}
    if camera == "explicit":
        pos = np.array([[0.3, 0.2, 0.93], [-0.2, 0.1, 0.97]], np.float32)
        cam = dict(camera_pos=pos, camera_lookup=-pos)
    ref = jax_rays.get_world_points_and_direction(
        key, batch_size=b, **kw, **{k: jnp.asarray(v) for k, v in cam.items()})
    k_perturb, k_cam = jax.random.split(key)
    uniform = jax.random.uniform(k_perturb, (b, size * size, S, 1), jnp.float32)
    k_theta, k_phi, _ = jax.random.split(k_cam, 3)
    draws = (t(jax.random.normal(k_theta, (b, 1))), t(jax.random.normal(k_phi, (b, 1))))
    out = rays.get_world_points_and_direction(
        b, **kw, **{k: t(v) for k, v in cam.items()}, perturb_uniform=t(uniform),
        camera_draws=draws)
    for name in rays.WorldRays._fields:
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-4, atol=2e-6, err_msg=name)


def test_cam2world_matches_jax():
    rng = np.random.default_rng(6)
    fwd = rng.standard_normal((4, 3)).astype(np.float32)
    org = rng.standard_normal((4, 3)).astype(np.float32)
    ref = jax_rays.create_cam2world_matrix(jnp.asarray(fwd), jnp.asarray(org))
    out = rays.create_cam2world_matrix(t(fwd), t(org))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MOD_TOL)
