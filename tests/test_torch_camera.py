"""The port's camera (`cips3d_tpu_torch/core/rays.py` camera modes,
`cips3d_tpu_torch/models/camera.py`) against the JAX package.

The JAX functions draw from keys; the port takes the same draws as tensors,
rebuilt from the key splits of `core/rays.py:127` (k_theta, k_phi, k_flip)
per mode.  Tolerance f32 rtol 1e-4 / atol 1e-6 (modules); the camera's
initial values and the snapshot round trips are bit for bit.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cips3d_tpu.core import rays as jrays
from cips3d_tpu.models import camera as jcam
from cips3d_tpu.utils.checkpoint import CheckpointManager as JaxManager
from cips3d_tpu_torch.core import rays as prays
from cips3d_tpu_torch.models import camera as pcam
from cips3d_tpu_torch.utils import convert
from cips3d_tpu_torch.utils.checkpoint import CheckpointManager

TOL = dict(rtol=1e-4, atol=1e-6)


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def jax_camera_draws(key, bs, mode):
    """The draws `sample_camera_positions(key, bs, mode=mode)` makes."""
    k_theta, k_phi, k_flip = jax.random.split(key, 3)
    shape = (bs, 1)
    if mode in ("normal", "gaussian"):
        return t(jax.random.normal(k_theta, shape)), t(jax.random.normal(k_phi, shape))
    if mode in ("uniform", "spherical_uniform"):
        return t(jax.random.uniform(k_theta, shape)), t(jax.random.uniform(k_phi, shape))
    if mode == "truncated_gaussian":
        return (t(jax.random.truncated_normal(k_theta, -2.0, 2.0, shape)),
                t(jax.random.truncated_normal(k_phi, -2.0, 2.0, shape)))
    if mode == "hybrid":
        return (t(jax.random.uniform(k_theta, shape)), t(jax.random.uniform(k_phi, shape)),
                t(jax.random.normal(k_theta, shape)), t(jax.random.normal(k_phi, shape)),
                torch.tensor(bool(jax.random.bernoulli(k_flip))))
    return ()


# the CARLA curriculum's spherical pose (wide, mean off the equator) and the CelebA one
SPREADS = {"carla": (math.pi, math.pi / 4 * 85 / 90, math.pi * 0.5, math.pi / 4 * 85 / 90),
           "celeba": (0.3, 0.155, math.pi * 0.5, math.pi * 0.5)}


@pytest.mark.parametrize("spread", sorted(SPREADS))
@pytest.mark.parametrize("mode", jrays.CAMERA_MODES)
def test_camera_modes_match_jax(mode, spread):
    assert prays.CAMERA_MODES == jrays.CAMERA_MODES
    h_sd, v_sd, h_mean, v_mean = SPREADS[spread]
    coins = set()
    for seed in range(6 if mode == "hybrid" else 1):   # both faces of hybrid's coin
        key = jax.random.PRNGKey(seed)
        ref = jrays.sample_camera_positions(key, 16, 1.2, h_sd, v_sd, h_mean, v_mean, mode)
        draws = jax_camera_draws(key, 16, mode)
        got = prays.sample_camera_positions(16, 1.2, h_sd, v_sd, h_mean, v_mean, mode,
                                            draws=draws)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        if mode == "hybrid":
            coins.add(bool(draws[4]))
    assert mode != "hybrid" or coins == {True, False}


@pytest.mark.parametrize("mode", jrays.CAMERA_MODES)
def test_port_camera_draws(mode):
    """The port's own draws: the shapes the mode takes, and the truncated
    normal inside (-2, 2) with the standard deviation of N(0, 1) cut
    there (0.8796)."""
    draws = prays.draw_camera(4096, mode, torch.Generator().manual_seed(0))
    assert len(draws) == {"mean": 0, "hybrid": 5}.get(mode, 2)
    for d in draws[:4]:
        assert d.shape == (4096, 1) and d.dtype == torch.float32
    if mode == "truncated_gaussian":
        x = torch.cat(draws)
        assert x.abs().max() < 2.0 and abs(x.std().item() - 0.8796) < 0.02
    pos, phi, theta = prays.sample_camera_positions(4096, mode=mode, draws=draws)
    np.testing.assert_allclose(pos.norm(dim=-1).numpy(), 1.0, rtol=1e-5)
    with pytest.raises(ValueError, match="unknown camera mode"):
        prays.draw_camera(2, "orbit")


def test_axis_angle_and_pinhole_match_jax():
    rng = np.random.default_rng(0)
    aa = rng.standard_normal((5, 3)).astype(np.float32)
    aa[0] = 0.0                     # the identity branch
    aa[1] *= 1e-9
    np.testing.assert_allclose(pcam.axis_angle_to_matrix(t(aa)).numpy(),
                               np.asarray(jcam.axis_angle_to_matrix(jnp.asarray(aa))), **TOL)
    rot = np.asarray(jcam.axis_angle_to_matrix(jnp.asarray(aa)))
    trans = rng.standard_normal((5, 3)).astype(np.float32)
    for fx, fy in ((60.0, 70.0), (np.float32([55.0]), np.float32([48.0]))):
        for H, W in ((6, 8), (8, 8)):
            ref = jcam.pinhole_rays(jnp.asarray(rot), jnp.asarray(trans), fx, fy, H, W)
            got = pcam.pinhole_rays(t(rot), t(trans), fx, fy, H, W)
            for a, b in zip(got, ref):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("kw", [dict(H0=8, W0=8), dict(H0=64, W0=64, fov0=12.0),
                                dict(H0=8, W0=8, fov0=60.0),   # focal0 < 30: the softplus inverse
                                dict(H0=8, W0=8, learn_intrinsics=False)],
                         ids=["r8", "r64", "wide", "frozen"])
def test_cam_params_match_jax(kw):
    """The initial intrinsics bit for bit (no random init); rays of a random
    pose and their grads with respect to the intrinsics."""
    jc, pc = jcam.CamParams(**kw), pcam.CamParams(**kw)
    key = jax.random.PRNGKey(3)
    params = jc.init(key, key, 2, 8, 8, method=jc.get_rays_random_pose)
    sd = pc.state_dict()
    assert set(sd) == set(params.get("params", {}))
    for k in sd:
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(params["params"][k]))
    for a, b in zip(pc.intrinsics(16, 12), jc.apply(params, 16, 12, method=jc.intrinsics)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))

    w = np.random.default_rng(1).standard_normal((3, 6, 8, 3)).astype(np.float32)

    def jloss(p):
        o, d, py = jc.apply(p, key, 3, 6, 8, h_stddev=0.4, method=jc.get_rays_random_pose)
        return jnp.sum(d * w) + jnp.sum(o) + jnp.sum(py), (o, d, py)

    (_, ref), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    o, d, py = pc.get_rays_random_pose(3, 6, 8, h_stddev=0.4,
                                       draws=jax_camera_draws(key, 3, "gaussian"))
    for a, b in zip((o, d, py), ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
    if kw.get("learn_intrinsics", True):
        (d * t(w)).sum().backward()
        for k in ("fx_raw", "fy_raw"):
            np.testing.assert_allclose(getattr(pc, k).grad.numpy(),
                                       np.asarray(jgrads["params"][k]), rtol=1e-4)


def test_cam_params_learnable_extrinsics_match_jax():
    jc, pc = jcam.CamParams(H0=8, W0=8, num_cams=3), pcam.CamParams(H0=8, W0=8, num_cams=3)
    idx = np.array([2, 0], np.int32)
    params = jc.init(jax.random.PRNGKey(0), jnp.asarray(idx), 8, 8)
    rng = np.random.default_rng(4)
    tree = jax.tree_util.tree_map(np.asarray, params)
    tree["params"]["so3"] = rng.standard_normal((3, 3)).astype(np.float32) * 0.3
    tree["params"]["trans"] = rng.standard_normal((3, 3)).astype(np.float32)
    pc.load_state_dict(convert.to_torch(convert.cam_state_dict(tree)), strict=True)
    ref = jc.apply(tree, jnp.asarray(idx), 6, 8)
    got = pc(torch.from_numpy(idx.astype(np.int64)), 6, 8)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)


def test_camera_and_cam_opt_round_trip_through_the_jax_layout(tmp_path):
    """The camera and its Adam (after two steps) through a snapshot the JAX
    package's CheckpointManager reads into its own refs, and back into a
    fresh camera and Adam: bit for bit."""
    cam = pcam.CamParams(H0=8, W0=8, num_cams=2)
    opt = torch.optim.Adam(cam.parameters(), lr=1e-2, betas=(0.0, 0.999), eps=1e-8)
    for i in range(2):
        _, d, _ = cam.get_rays_random_pose(2, 8, 8, generator=torch.Generator().manual_seed(i))
        o, d2 = cam(torch.tensor([1, 0]), 8, 8)
        (d.sum() + d2.sum() + o.sum()).backward()
        opt.step()
        opt.zero_grad()
    modules = {"cam_param": convert.cam_tree_from_state_dict(cam.state_dict()),
               "cam_opt": convert.optax_adam_state(opt, cam, convert.cam_tree_from_state_dict)}
    CheckpointManager(str(tmp_path)).save_snapshot("resume", modules, {"step": 2})

    jc = jcam.CamParams(H0=8, W0=8, num_cams=2)
    jparams = jc.init(jax.random.PRNGKey(0), jnp.asarray([0, 1]), 8, 8)
    loaded = JaxManager(str(tmp_path)).load_snapshot(
        "resume", {"cam_param": jparams, "cam_opt": optax.adam(1e-2).init(jparams)})
    assert int(loaded["cam_opt"][0].count) == 2
    for k, v in cam.state_dict().items():
        np.testing.assert_array_equal(np.asarray(loaded["cam_param"]["params"][k]), v.numpy())
        np.testing.assert_array_equal(np.asarray(loaded["cam_opt"][0].mu["params"][k]),
                                      opt.state[getattr(cam, k)]["exp_avg"].numpy())

    back = CheckpointManager(str(tmp_path)).load_snapshot("resume", ("cam_param", "cam_opt"))
    fresh = pcam.CamParams(H0=8, W0=8, num_cams=2)
    fresh.load_state_dict(convert.to_torch(convert.cam_state_dict(back["cam_param"])),
                          strict=True)
    fopt = torch.optim.Adam(fresh.parameters(), lr=1e-2, betas=(0.0, 0.999), eps=1e-8)
    convert.load_optax_adam_state(fopt, fresh, back["cam_opt"], convert.cam_state_dict)
    for (k, a), b in zip(cam.named_parameters(), fresh.parameters()):
        assert torch.equal(a, b), k
        for m in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[a][m], fopt.state[b][m]), (k, m)
        assert float(fopt.state[b]["step"]) == 2.0
