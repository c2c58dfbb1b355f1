"""The ray tile's plain version past 32 samples a ray, against JAX.

The Pallas `fused_ray_render` takes any sample count S; the port's kernels
take S up to `ray_tile.MAX_STEPS` (`tests/test_torch_kernels.py` holds them
against the plain version on the card).  Here the plain version at S = 48,
forward and VJP (weights, FiLM gains and shifts, coarse points), against the
Pallas module's `_jnp_core`, the reference its kernel and its custom VJP are
held to (`tests/test_pallas_ray.py`), on the same weights and draws: rtol
2e-4 / atol 2e-5 for the outputs, the normalised error max|a-b| / (max|b| +
1) < 1e-4 for the gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cips3d_tpu.models.nerf_net import NeRFNetwork as JaxNeRFNetwork
from cips3d_tpu.ops.pallas import ray_tile as jax_ray_tile
from cips3d_tpu_torch.models.nerf_net import NeRFNetwork
from cips3d_tpu_torch.ops import ray_tile
from cips3d_tpu_torch.utils.convert import siren_state_dict, to_torch

B, N, S, H, R = 2, 16, 48, 32, 16
KERNEL_TOL = dict(rtol=2e-4, atol=2e-5)


def _grad_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1.0)


@pytest.fixture(scope="module")
def long_rays():
    """A tiny SIREN in both packages with the same weights; 48 samples a ray."""
    rng = np.random.default_rng(7)
    siren = JaxNeRFNetwork(hidden_dim=H, hidden_layers=2, rgb_dim=R)
    styles = {k: rng.standard_normal((B, H)).astype(np.float32)
              for k in ("nerf_w0", "nerf_w1", "nerf_rgb")}
    jstyles = {k: jnp.asarray(v) for k, v in styles.items()}
    params = siren.init(jax.random.PRNGKey(3), jnp.zeros((B, 8, 3)), jstyles)["params"]
    port = NeRFNetwork(hidden_dim=H, hidden_layers=2, rgb_dim=R, style_dim=H)
    port.load_state_dict(to_torch(siren_state_dict(params)))
    origins = rng.standard_normal((B, N, 3)).astype(np.float32) * 0.05
    d = rng.standard_normal((B, N, 3)).astype(np.float32) + np.array([0, 0, -1], np.float32)
    dirs = d / np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.sort(np.linspace(0.88, 1.12, S, dtype=np.float32)
                + rng.uniform(0, 0.24 / S, (B, N, S)).astype(np.float32), -1)
    pts = origins[:, :, None] + dirs[:, :, None] * z[..., None]
    draws = (rng.uniform(0, 1, (B, N, S)).astype(np.float32),
             rng.standard_normal((B, N, S)).astype(np.float32),
             rng.standard_normal((B, N, 2 * S)).astype(np.float32))
    # the flat weights `fused_ray_render` builds (ray_tile.py:967-984)
    w = jax_ray_tile.extract_siren_weights(params)
    f = jax_ray_tile.compute_films(params, jstyles)
    jwt = []
    for i in range(2):
        jwt += [w[f"w{i}"], w[f"b{i}"].reshape(1, -1), f[f"g{i}"], f[f"f{i}"]]
    jwt += [w["wc"], w["bc"].reshape(1, -1), f["gc"], f["fc"], w["wr"], w["br"].reshape(1, -1),
            jnp.pad(w["ws"], ((0, 0), (0, 7))), jnp.pad(w["bs"].reshape(1, 1), ((0, 0), (0, 7)))]
    wt = [t.detach() for t in ray_tile.flat_weights(port, {k: torch.from_numpy(v)
                                                           for k, v in styles.items()})]
    return dict(jwt=tuple(jwt), wt=wt, arrays=(pts, origins, dirs, z) + draws)


@pytest.mark.parametrize("kwargs", [
    dict(noise_std=0.0),
    dict(noise_std=0.4, clamp_mode="softplus", white_back=True, last_back=True, fast_sin=True),
], ids=["relu", "noise_softplus_white_last_back_fast_sin"])
def test_plain_matches_jax_past_32_steps(long_rays, kwargs):
    kw = dict(kwargs)
    ns = kw.pop("noise_std")
    opts = dict(clamp_mode="relu", white_back=False, last_back=False, fast_sin=False)
    opts.update(kw)
    arrays = long_rays["arrays"]
    jargs = [jnp.asarray(a) for a in arrays]

    def core(wt, pts):
        return jax_ray_tile._jnp_core(
            wt, pts, *jargs[1:], jnp.full((1, 1), ns, jnp.float32), use_noise=ns != 0,
            mm_dtype=jnp.float32, warp_scale=2.0 / 0.24, out_dtype=jnp.float32, **opts)

    @jax.jit
    def forward_and_vjp(wt, pts, cot):
        out, vjp = jax.vjp(core, wt, pts)
        return out, vjp(cot)

    rng = np.random.default_rng(8)
    d_fea = rng.standard_normal((B, N, R)).astype(np.float32)
    d_dep = rng.standard_normal((B, N, 1)).astype(np.float32)
    (ref_fea, ref_dep), (ref_wt, ref_pts) = forward_and_vjp(
        long_rays["jwt"], jargs[0], (jnp.asarray(d_fea), jnp.asarray(d_dep)))

    args = [torch.from_numpy(a) for a in arrays] + [ns]
    fea, dep = ray_tile.ray_tile_plain(long_rays["wt"], *args, **opts)
    np.testing.assert_allclose(fea.numpy(), np.asarray(ref_fea), **KERNEL_TOL)
    np.testing.assert_allclose(dep.numpy(), np.asarray(ref_dep), **KERNEL_TOL)
    grads, d_pts = ray_tile.ray_tile_bwd_plain(long_rays["wt"], *args, torch.from_numpy(d_fea),
                                               torch.from_numpy(d_dep), **opts)
    for i, (g, r) in enumerate(zip(grads, ref_wt)):
        r = np.asarray(r)
        if r.shape != tuple(g.shape):   # JAX's (1, dim) biases; its lane-padded sigma head
            r = r[:, :1] if r.shape[-1] == 8 and g.shape[-1] == 1 else r
            r = r.reshape(g.shape)
        assert _grad_err(g.numpy(), r) < 1e-4, f"grad {i}"
    assert _grad_err(d_pts.numpy(), ref_pts) < 1e-4
