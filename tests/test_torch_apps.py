"""The port's apps (`cips3d_tpu_torch/apps/`, `core/trajectories.py`, the
AVI container of `utils/video.py`, the discriminator's `features`) against
the JAX package's.

A tiny generator (the SKILL's narrow widths, fast_sin as configs/ffhq.yaml
ships it) is initialised in JAX and bridged into the port.  Every draw the
port's apps make goes through a `Draws`; `JaxDraws` rebuilds the JAX
package's draws from its key splits (`render.py:95,134`, `rays.py:83`,
`ray_tile.py:953-965`, `generator.py:492-503`), so both packages render the
same frames.  The float renders of both are recorded at `render_chunked`.
Tolerances: trajectories and camera paths bit for bit; frames, depths,
sigma and losses fp32 rtol 1e-4 (sigma 1e-5) with the atol each test
states; PNGs within one 8-bit level; the MJPEG-AVI frames within the
JPEG's error (mean |a-b| at most 2 levels); the MRC writer byte for byte.
"""

import base64
import io
import json
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from cips3d_tpu.apps import interpolation as j_interp
from cips3d_tpu.apps import inversion as j_inv
from cips3d_tpu.apps import render as j_render
from cips3d_tpu.apps import shapes as j_shapes
from cips3d_tpu.apps import viewer as j_viewer
from cips3d_tpu.apps import z_interpolation as j_zi
from cips3d_tpu.core import trajectories as j_traj
from cips3d_tpu.models.discriminator import DiscriminatorMultiScaleAux as JaxD
from cips3d_tpu.models.generator import GeneratorConfig as JaxConfig
from cips3d_tpu.models.generator import GeneratorNerfINR as JaxGenerator
from cips3d_tpu.models.generator import RenderOptions as JaxOptions
from cips3d_tpu.models.generator import sample_zs as jax_sample_zs
from cips3d_tpu.utils.video import read_mjpeg_avi as jax_read_avi
from cips3d_tpu_torch.apps import interpolation as p_interp
from cips3d_tpu_torch.apps import inversion as p_inv
from cips3d_tpu_torch.apps import render as p_render
from cips3d_tpu_torch.apps import shapes as p_shapes
from cips3d_tpu_torch.apps import viewer as p_viewer
from cips3d_tpu_torch.apps import z_interpolation as p_zi
from cips3d_tpu_torch.core import trajectories as p_traj
from cips3d_tpu_torch.models.discriminator import DiscriminatorMultiScaleAux
from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR
from cips3d_tpu_torch.ops.ray_tile import RayDraws
from cips3d_tpu_torch.utils import image_io, video
from cips3d_tpu_torch.utils.convert import load_jax_d_params, load_jax_params, state_dict_from_jax

TINY = dict(z_dim_nerf=16, z_dim_inr=32, nerf_hidden_dim=32, nerf_style_dim=32,
            nerf_rgb_dim=16, nerf_mapping_layers=2, inr_hidden_dim=32, inr_style_dim=32,
            inr_mapping_layers=2, fast_sin=True)
# the exact-sine recipe's kernel flags: the ray tile with residuals, its residual backward
EXACT = dict(TINY, fast_sin=False, fused_ray=True, fused_ray_vjp="pallas_residual")
FRAME_TOL = dict(rtol=1e-4, atol=1e-5)   # images in [-1, 1], depths in [0.88, 1.12]
SIZE, STEPS = 8, 6                       # every render of this file: r8, 6 + 6 samples a ray


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


class JaxDraws(p_render.Draws):
    """The JAX package's draws for each seed and key."""

    def __init__(self, jcfg):
        super().__init__("cpu")
        self.jcfg = jcfg

    def zs(self, seed, n, cfg):
        return {k: t(v) for k, v in jax_sample_zs(jax.random.PRNGKey(seed), n, self.jcfg).items()}

    def render(self, key, b, opts, chunk):
        k_rays, k_pts = jax.random.split(jax.random.PRNGKey(key))
        k_perturb, _ = jax.random.split(k_rays)
        n, S = opts.img_size ** 2, opts.num_steps
        uniform = jax.random.uniform(k_perturb, (b, n, S, 1), jnp.float32)
        draws = []
        for k in jax.random.split(k_pts, n // chunk):
            u = jax.random.uniform(jax.random.split(k, 3)[0], (b * chunk, S), jnp.float32)
            draws.append(RayDraws(t(u).reshape(b, chunk, S), torch.zeros(b, chunk, S),
                                  torch.zeros(b, chunk, 2 * S)))
        return dict(perturb_uniform=t(uniform), chunk_draws=draws)


def _pair(cfg_kwargs, init_key=1):
    cfg = JaxConfig(**cfg_kwargs)
    jgen = JaxGenerator(cfg=cfg)
    zs = jax_sample_zs(jax.random.PRNGKey(0), 1, cfg)
    params = jgen.init(jax.random.PRNGKey(init_key), zs, jax.random.PRNGKey(2),
                       JaxOptions(img_size=8, num_steps=4))
    params = jax.tree_util.tree_map(np.asarray, params)
    port = GeneratorNerfINR(GeneratorConfig(**cfg_kwargs))
    load_jax_params(port, params)
    return jgen, params, port.eval(), JaxDraws(cfg)


@pytest.fixture(scope="module")
def gens():
    return _pair(TINY)


@pytest.fixture
def recorded(monkeypatch):
    """The float outputs of every `render_chunked` call of each package."""
    out = {"jax": [], "port": []}

    def wrap(name, fn):
        def rec(*args, **kwargs):
            r = fn(*args, **kwargs)
            out[name].append([np.asarray(x) for x in (r if isinstance(r, tuple) else (r,))])
            return r
        return rec

    monkeypatch.setattr(j_render, "render_chunked", wrap("jax", j_render.render_chunked))
    monkeypatch.setattr(p_render, "render_chunked", wrap("port", p_render.render_chunked))
    return out


def _same_renders(rec):
    assert len(rec["port"]) == len(rec["jax"]) > 0
    for got, ref in zip(rec["port"], rec["jax"]):
        for g, r in zip(got, ref):   # JAX renders depth only when asked; the port always
            np.testing.assert_allclose(g, r, **FRAME_TOL)


def _png(path):
    return np.asarray(Image.open(path).convert("RGB")).astype(np.int16)


# ---------------------------------------------------------------- trajectories

def test_trajectories_bit_for_bit():
    """Every builder, every demo mode and the z-interpolation camera paths."""
    cases = [
        ("get_circle_camera_pos_and_lookup", dict(alpha=0.3, num_samples=7, periods=2)),
        ("get_translate_circle_camera_pos_and_lookup",
         dict(num_samples_translate=9, alpha=0.2, num_samples=5, periods=2)),
        ("get_translate_rotate", dict(num_samples_translate=12, num_samples=10, periods=1)),
        ("get_yaw_camera_pos_and_lookup", dict(num_samples=11)),
    ]
    for name, kw in cases:
        for a, b in zip(getattr(p_traj, name)(**kw), getattr(j_traj, name)(**kw)):
            np.testing.assert_array_equal(a, b)
    assert p_traj.get_yaw_pitch_by_xyz(0.3, -0.2, 0.9) == j_traj.get_yaw_pitch_by_xyz(0.3, -0.2, 0.9)
    assert p_render.TRAJECTORY_MODES == j_render.TRAJECTORY_MODES
    for mode in p_render.TRAJECTORY_MODES:
        for n in (7, 12, 30):
            got, ref = p_render.build_trajectory(mode, n), j_render.build_trajectory(mode, n)
            assert (got[2] is None) == (ref[2] is None) and len(got[0]) == len(ref[0])
            for a, b in zip(got, ref):
                if b is not None:
                    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown trajectory mode"):
        p_render.build_trajectory("spiral", 4)
    for mode in ("front", "orbit"):
        assert p_zi.build_camera_path(mode, 9, 12.0) == j_zi.build_camera_path(mode, 9, 12.0)
    assert p_zi.build_camera_path("orbit", 3, 12.0)[0][1] == 0.2 + math.pi / 4


# ---------------------------------------------------------------- renders

def test_render_multiview_matches_jax(gens, recorded, tmp_path):
    jgen, params, port, draws = gens
    kw = dict(seeds=(1,), yaw_offsets=(-0.5, 0.25), img_size=SIZE, num_steps=STEPS // 2, psi=0.7)
    ref = j_render.render_multiview(params, jgen, str(tmp_path / "j.png"), **kw)
    got = p_render.render_multiview(port, str(tmp_path / "p.png"), draws=draws, **kw)
    assert got.shape == ref.shape == (2, 3, SIZE, SIZE)
    np.testing.assert_allclose(got, ref, **FRAME_TOL)
    _same_renders(recorded)
    assert np.abs(_png(tmp_path / "p.png") - _png(tmp_path / "j.png")).max() <= 1


def test_render_trajectory_video_matches_jax(gens, recorded, tmp_path):
    """translate_rotate (an up vector that rolls) with depth frames; the
    port's MJPEG-AVI decodes with the JAX package's reader."""
    jgen, params, port, draws = gens
    kw = dict(seed=3, mode="translate_rotate", num_frames=3, img_size=SIZE, num_steps=STEPS,
              depth=True)
    ref = j_render.render_trajectory_video(params, jgen, str(tmp_path / "j"), **kw)
    got = p_render.render_trajectory_video(port, str(tmp_path / "p"), draws=draws, **kw)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in ref]
    _same_renders(recorded)
    names = sorted(os.listdir(tmp_path / "p"))
    assert names == ["depth.avi"] + [f"depth_{i:04d}.png" for i in range(3)] + \
        [f"frame_{i:04d}.png" for i in range(3)] + ["video.avi"]
    for name in names[1:-1]:
        assert np.abs(_png(tmp_path / "p" / name) - _png(tmp_path / "j" / name)).max() <= 1
    for avi, prefix in (("video.avi", "frame"), ("depth.avi", "depth")):
        frames = jax_read_avi(str(tmp_path / "p" / avi))
        assert len(frames) == 3 == len(video.read_mjpeg_avi(str(tmp_path / "p" / avi)))
        for i, f in enumerate(frames):
            png = _png(tmp_path / "p" / f"{prefix}_{i:04d}.png")
            assert f.shape == png.shape and np.abs(f.astype(np.int16) - png).mean() <= 2


def test_render_z_interpolation_video_matches_jax(gens, recorded, tmp_path):
    jgen, params, port, draws = gens
    kw = dict(seeds=(0, 2), num_frames=2, img_size=SIZE, num_steps=STEPS, psi=0.7,
              camera_mode="orbit")
    ref = j_zi.render_z_interpolation_video(params, jgen, str(tmp_path / "j"), **kw)
    got = p_zi.render_z_interpolation_video(port, str(tmp_path / "p"), draws=draws, **kw)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in ref]
    assert len(got) == 4 and os.path.exists(tmp_path / "p" / "interp.avi")
    _same_renders(recorded)
    for p in got:
        name = os.path.basename(p)
        assert np.abs(_png(tmp_path / "p" / name) - _png(tmp_path / "j" / name)).max() <= 1
    sa, sb = ({k: torch.full((1, 3), v) for k in "ab"} for v in (1.0, 3.0))
    assert all(torch.equal(v, torch.full((1, 3), 1.5)) for v in p_zi.style_lerp(sa, sb, 0.25).values())


def _frame_grid(html, name):
    return json.loads(re.search(rf"const {name} = (.*?);", html).group(1))


def test_viewer_matches_jax(gens, recorded, tmp_path):
    jgen, params, port, draws = gens
    kw = dict(seeds=(2,), n_yaw=2, n_pitch=1, img_size=SIZE, num_steps=STEPS, psi=0.7,
              depth=True)
    j_viewer.export_html_viewer(params, jgen, str(tmp_path / "j.html"), **kw)
    p_viewer.export_html_viewer(port, str(tmp_path / "p.html"), draws=draws, **kw)
    _same_renders(recorded)
    np.testing.assert_array_equal(p_viewer._camera_position(1.2, 1.4),
                                  j_viewer._camera_position(1.2, 1.4))
    ref_html, html = (open(tmp_path / f"{s}.html").read() for s in "jp")
    for name in ("F", "D"):
        ref, got = _frame_grid(ref_html, name), _frame_grid(html, name)
        assert np.array(got).shape == np.array(ref).shape == (1, 1, 2)
        for g, r in zip(np.ravel(got), np.ravel(ref)):
            dec = [np.asarray(Image.open(io.BytesIO(base64.b64decode(s))).convert("RGB"))
                   for s in (g, r)]
            assert np.abs(dec[0].astype(np.int16) - dec[1]).mean() <= 2
    assert "const NY = 2, NP = 1, SEEDS = [2];" in html


# ---------------------------------------------------------------- interpolation

def test_inr_layer_swapping_matches_jax(gens, tmp_path):
    jgen, src_params, src, draws = gens
    _, tgt_params, tgt, _ = _pair(TINY, init_key=5)
    layers, gamma = ("8", "32", "64"), 0.3
    ref = state_dict_from_jax(j_interp.inr_layer_swapping(src_params, tgt_params, gamma, layers))
    got = p_interp.inr_layer_swapping(src, tgt, gamma, layers).state_dict()
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    src_sd = src.state_dict()   # the source is not touched
    assert torch.equal(src_sd["inr_net.network.8.mod1.weight"],
                       t(state_dict_from_jax(src_params)["inr_net.network.8.mod1.weight"]))
    grid = p_interp.model_interpolation_demo(src, tgt, str(tmp_path), gamma=0.5, seeds=(0,),
                                             img_size=SIZE, num_steps=3, yaw_offsets=(0.0, 0.3),
                                             draws=draws)
    assert grid.shape == (6, 3, SIZE, SIZE) and np.isfinite(grid).all()
    assert os.listdir(tmp_path) == ["interp_seed0.png"]


# ---------------------------------------------------------------- shapes

def test_shapes_match_jax(gens, tmp_path):
    jgen, params, port, draws = gens
    np.testing.assert_array_equal(p_shapes.create_voxel_grid(5, 0.3),
                                  j_shapes.create_voxel_grid(5, 0.3))
    ref = j_shapes.sample_sigma_volume(params, jgen, seed=4, n=8, chunk=200, psi=0.7)
    got = p_shapes.sample_sigma_volume(port, seed=4, n=8, chunk=200, psi=0.7, draws=draws)
    assert got.shape == ref.shape == (8, 8, 8) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    j_shapes.write_mrc(str(tmp_path / "j.mrc"), ref, voxel_size=0.5)
    p_shapes.write_mrc(str(tmp_path / "p.mrc"), ref, voxel_size=0.5)
    assert open(tmp_path / "j.mrc", "rb").read() == open(tmp_path / "p.mrc", "rb").read()
    p_shapes.extract_shape(port, str(tmp_path / "e.mrc"), seed=4, n=8, psi=0.7, draws=draws)
    np.testing.assert_array_equal(j_shapes.read_mrc(str(tmp_path / "e.mrc")),
                                  p_shapes.read_mrc(str(tmp_path / "e.mrc")))
    np.testing.assert_allclose(p_shapes.read_mrc(str(tmp_path / "j.mrc")), ref)
    with pytest.raises(ValueError, match="mode"):
        (tmp_path / "bad.mrc").write_bytes(b"\x00" * 12 + b"\x01" + b"\x00" * 1011)
        p_shapes.read_mrc(str(tmp_path / "bad.mrc"))


# ---------------------------------------------------------------- inversion

D_TINY = {4: 16, 8: 16, 16: 16, 32: 16, 64: 16, 128: 16, 256: 16, 512: 16, 1024: 16}


@pytest.fixture(scope="module")
def discs():
    jd = JaxD(max_size=32, channels_override=D_TINY)
    params = jd.init(jax.random.PRNGKey(3), jnp.zeros((2, 3, 8, 8)), method=jd.init_all)
    params = jax.tree_util.tree_map(np.asarray, params)
    port = DiscriminatorMultiScaleAux(max_size=32, channels_override=D_TINY)
    load_jax_d_params(port, params)
    return jd, params, port


def test_features_multiscale_l2_and_percept_match_jax(discs):
    jd, params, port = discs
    rng = np.random.default_rng(6)
    a, b = (rng.uniform(-1, 1, (2, 3, 16, 16)).astype(np.float32) for _ in range(2))
    ref = jd.apply(params, jnp.asarray(a), method=jd.features)
    with torch.no_grad():
        got = port.features(t(a))
    assert [tuple(f.shape) for f in got] == [f.shape for f in ref] == [(2, 16, 8, 8),
                                                                      (2, 16, 4, 4)]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(p_inv.multiscale_l2(t(a), t(b))),
                               float(j_inv.multiscale_l2(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        got = p_inv.make_disc_percept_fn(port)(t(a)).numpy()
    ref = np.asarray(j_inv.make_disc_percept_fn(params, jd)(jnp.asarray(a)))
    assert got.shape == ref.shape == (2, 16 * 64 + 16 * 16)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def _inversion_draws(jgen, params, port, seed, steps, size, S, avg):
    """`project_image`'s draws as the JAX package makes them
    (`inversion.py:86-131`)."""
    k_avg, k_noise, k_render = jax.random.split(jax.random.PRNGKey(seed), 3)
    avg_zs = jax_sample_zs(k_avg, avg, jgen.cfg)
    styles = jgen.apply(params, avg_zs["z_nerf"], avg_zs["z_inr"], method=jgen.mapping)
    noise = {k: t(jax.random.normal(jax.random.fold_in(k_noise, i), (1,) + v.shape[1:]))
             for i, (k, v) in enumerate(styles.items())}
    rays = []
    for i in range(steps):
        k = jax.random.split(jax.random.fold_in(k_render, i), 3)[0]
        u = jax.random.uniform(k, (size * size, S), jnp.float32).reshape(1, size * size, S)
        rays.append(RayDraws(t(u), torch.zeros(1, size * size, S),
                             torch.zeros(1, size * size, 2 * S)))
    return p_inv.InversionDraws({k: t(v) for k, v in avg_zs.items()}, noise, rays)


def test_project_image_matches_jax(discs):
    """Three Adam steps on the exact-sine kernel flags (the ray tile's
    residual backward carries the gradient into the FiLM styles) with the
    discriminator's perceptual term: the loss history within rtol 1e-4."""
    jgen, params, port, _ = _pair(EXACT)
    jd, d_params, d_port = discs
    target = np.random.default_rng(7).uniform(-1, 1, (3, 16, 16)).astype(np.float32)
    kw = dict(num_steps_opt=3, img_size=16, num_steps=STEPS, avg_samples=64, log_every=1,
              seed=2)
    ref_st, ref_img, ref_hist = j_inv.project_image(
        params, jgen, target, percept_fn=j_inv.make_disc_percept_fn(d_params, jd), **kw)
    draws = _inversion_draws(jgen, params, port, 2, 3, 16, STEPS, 64)
    st, img, hist = p_inv.project_image(port, target, percept_fn=p_inv.make_disc_percept_fn(d_port),
                                        draws=draws, **kw)
    assert len(hist) == len(ref_hist) == 3 and hist[2] < hist[0]
    np.testing.assert_allclose(hist, ref_hist, rtol=1e-4)
    np.testing.assert_allclose(img, np.asarray(ref_img), **FRAME_TOL)
    for k in ref_st:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(ref_st[k]), rtol=1e-4, atol=1e-6)


def test_project_image_refuses_the_forward_only_decode():
    """Under the serving flags the INR decode is the forward-only kernel:
    the step's backward raises, as autodiff of the Pallas decode does."""
    port = GeneratorNerfINR(GeneratorConfig(**TINY, fused_ray=True, fused_inr=True),
                            generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="forward only"):
        p_inv.project_image(port, np.zeros((3, 8, 8), np.float32), num_steps_opt=1, img_size=8,
                            num_steps=3, avg_samples=4)
