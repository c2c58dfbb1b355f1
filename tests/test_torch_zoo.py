"""The port's model zoo (`cips3d_tpu_torch/models/legacy.py`,
`models/nerf_variants.py`) against the JAX package's, on the same weights.

Each case mirrors one of `tests/test_legacy.py` and
`tests/test_nerf_variants.py` (plus `INRNetworkSkipProg` and `NeRFNetworkL`,
which those files do not reach): the JAX module is initialised, its tree is
carried across by `utils/convert.py::tree_state_dict` (or
`siren_state_dict` for the `NeRFNetwork` variants) with a strict load, and
the port's outputs are held to JAX's at the module tolerance, fp32 rtol
1e-4 / atol 1e-5; gradients by the normalised error max|a-b| / (max|b| + 1)
< 1e-4.  Inputs come from a numpy seed.  Also the `NeRFNetwork` colour
width and the `normal_kernel` initializer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cips3d_tpu.models import init as jax_init
from cips3d_tpu.models import legacy as jl
from cips3d_tpu.models import nerf_variants as jv
from cips3d_tpu.models.nerf_net import NeRFNetwork as JaxNeRF
from cips3d_tpu_torch.models import init as winit
from cips3d_tpu_torch.models import legacy as tl
from cips3d_tpu_torch.models import nerf_variants as tv
from cips3d_tpu_torch.models.nerf_net import NeRFNetwork
from cips3d_tpu_torch.utils.convert import siren_state_dict, to_torch, tree_state_dict

MOD_TOL = dict(rtol=1e-4, atol=1e-5)
KEY = jax.random.PRNGKey(0)


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def normal(shape, seed, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale + shift).astype(np.float32)


def ported(module, params, sd_fn=tree_state_dict):
    """``module`` with the JAX tree's weights, loaded strictly."""
    module.load_state_dict(to_torch(sd_fn(jax.tree_util.tree_map(np.asarray, params))),
                           strict=True)
    return module


def close(out, ref):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **MOD_TOL)


def grad_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1.0))


# ---------------------------------------------------------------- legacy.py

class TestCLN:
    def test_normalization_and_style(self):
        x, style = normal((2, 5, 8), 0, 3.0, 1.0), normal((2, 4), 1)
        jm = jl.CLN()
        p = jm.init(KEY, x, style)
        m = ported(tl.CLN(8, 4), p)
        close(m(t(x), t(style)), jm.apply(p, x, style))
        # zero style FCs: a plain LayerNorm, in both packages
        zeroed = jax.tree_util.tree_map(jnp.zeros_like, p)
        out0 = ported(tl.CLN(8, 4), zeroed)(t(x), t(style)).detach().numpy()
        close(torch.from_numpy(out0), jm.apply(zeroed, x, style))
        np.testing.assert_allclose(out0.mean(-1), 0.0, atol=1e-5)
        np.testing.assert_allclose(out0.var(-1), 1.0, atol=1e-3)

    def test_cln_layer(self):
        x, style = normal((2, 5, 8), 2), normal((2, 4), 3)
        jm = jl.CLNLayer(16)
        p = jm.init(KEY, x, style)
        out = ported(tl.CLNLayer(8, 16, 4), p)(t(x), t(style))
        assert out.shape == (2, 5, 16)
        close(out, jm.apply(p, x, style))


class TestINRNetworks:
    def test_inr_network(self):
        x = normal((2, 7, 32), 4)
        styles = {f"inr_w{i}": normal((2, 8), 10 + i) for i in range(3)}
        jm = jl.INRNetwork(hidden_dim=16, hidden_layers=3, rgb_dim=3)
        p = jm.init(KEY, x, styles)
        out = ported(tl.INRNetwork(32, 16, 3, 8), p)(t(x), {k: t(v) for k, v in styles.items()})
        assert out.shape == (2, 7, 3) and out.abs().max() <= 1
        close(out, jm.apply(p, x, styles))

    def test_inr_network_skip(self):
        x = normal((1, 5, 32), 5)
        styles = {f"inr_w{i}_{j}": normal((1, 8), 20 + 2 * i + j) for i in range(3) for j in (0, 1)}
        jm = jl.INRNetworkSkip(hidden_layers=3, dim_scale=1 / 32)
        p = jm.init(KEY, x, styles)
        out = ported(tl.INRNetworkSkip(32, 3, 8, dim_scale=1 / 32), p)(
            t(x), {k: t(v) for k, v in styles.items()})
        assert out.shape == (1, 5, 3)
        close(out, jm.apply(p, x, styles))


def _prog_styles(prefix, resolutions, b, dim, seed):
    return {f"{prefix}_w{res}_{j}": normal((b, dim), seed + 2 * i + j)
            for i, res in enumerate(resolutions) for j in (0, 1)}


class TestMisc:
    def test_pos_embedding(self):
        x = normal((5, 3), 6)
        m = tl.PosEmbedding(max_logscale=3, n_freqs=4)
        out = m(t(x))
        assert out.shape == (5, m.out_dim) == (5, 27)
        close(out, jl.PosEmbedding(max_logscale=3, n_freqs=4)(jnp.asarray(x)))
        np.testing.assert_allclose(out[:, :3].numpy(), x)
        np.testing.assert_allclose(out[:, 3:6].numpy(), np.sin(x), atol=1e-6)

    def test_fcnet(self):
        x = normal((2, 4, 8), 7)
        jm = jl.FCNet(hidden_dim=16, hidden_layers=2)
        p = jm.init(KEY, x)
        out = ported(tl.FCNet(8, 16, 2), p)(t(x))
        assert out.shape == (2, 4, 3) and out.abs().max() <= 1
        close(out, jm.apply(p, x))

    @pytest.mark.parametrize("points", [6, None], ids=["3d", "2d"])
    def test_modulated_fc_conv(self, points):
        x = normal((2, points, 8) if points else (2, 8), 8)
        style = normal((2, 4), 9)
        jm = jl.ModulatedFCConv(out_channel=12)
        p = jm.init(KEY, x, style)
        out = ported(tl.ModulatedFCConv(8, 12, 4), p)(t(x), t(style))
        assert out.shape == ((2, points, 12) if points else (2, 12))
        # demodulation: unit column norms of the per-sample weight
        assert out.std() < 10
        close(out, jm.apply(p, x, style))

    def test_inr_skip_prog_early_exit(self):
        x = normal((2, 9, 8), 10)
        styles = _prog_styles("inr", jl.PROG_RESOLUTIONS, 2, 12, 100)
        jm = jl.INRNetworkSkipProg(dim_scale=1 / 16)   # ch 16: the skip from the second block
        p = jm.init(KEY, x, styles)
        m = ported(tl.INRNetworkSkipProg(8, 12, dim_scale=1 / 16), p)
        ts = {k: t(v) for k, v in styles.items()}
        for img_size in (1024, 64, 100):
            close(m(t(x), ts, img_size=img_size), jm.apply(p, x, styles, img_size=img_size))


class TestModSinLayer:
    def test_norm_path(self):
        x, style = normal((2, 5, 8), 11, 3.0), normal((2, 4), 12)
        jm = jl.ModSinLayer()
        p = jm.init(KEY, x, style)
        out = ported(tl.ModSinLayer(8, 4), p)(t(x), t(style))
        assert out.shape == x.shape
        close(out, jm.apply(p, x, style))

    def test_sine_path(self):
        x, style = normal((2, 5, 8), 13), normal((2, 4), 14)
        jm = jl.ModSinLayer(use_sine=True, freq=2.0)
        p = jm.init(KEY, x, style)
        out = ported(tl.ModSinLayer(8, 4, use_sine=True, freq=2.0), p)(t(x), t(style))
        assert torch.isfinite(out).all()
        close(out, jm.apply(p, x, style))


class TestCLNINRVariants:
    def test_inr_skip_cln_early_exit(self):
        x = normal((2, 9, 8), 15)
        styles = _prog_styles("inr", jl.CLN_RESOLUTIONS, 2, 12, 200)
        jm = jl.INRNetworkSkipCLN(dim_scale=1 / 16)
        p = jm.init(KEY, x, styles)
        m = ported(tl.INRNetworkSkipCLN(8, 12, dim_scale=1 / 16), p)
        ts = {k: t(v) for k, v in styles.items()}
        out_full = m(t(x), ts)
        assert out_full.shape == (2, 9, 3) and out_full.abs().max() <= 1
        close(out_full, jm.apply(p, x, styles))
        out_64 = m(t(x), ts, img_size=64)   # the first three blocks only
        close(out_64, jm.apply(p, x, styles, img_size=64))
        assert not torch.allclose(out_64, out_full)

    def test_linear_skip_prog(self):
        x = normal((2, 9, 8), 16)
        styles = {"linear_w": normal((2, 12), 17)}
        jm = jl.LinearSkipProg(hidden_dim=16)
        p = jm.init(KEY, x, styles)
        m = ported(tl.LinearSkipProg(8, 12, hidden_dim=16), p)
        style = t(styles["linear_w"]).requires_grad_(True)
        out = m(t(x), {"linear_w": style}, img_size=256)
        assert out.shape == (2, 9, 3)
        close(out, jm.apply(p, x, styles, img_size=256))
        # the CLN input layer is the only style dependence
        g = jax.grad(lambda s: jnp.sum(jm.apply(p, x, s, img_size=256)))(styles)["linear_w"]
        out.sum().backward()
        assert float(jnp.abs(g).max()) > 0
        assert grad_err(style.grad.numpy(), g) < 1e-4

    def test_cln_block_skip(self):
        x, s0, s1 = normal((2, 5, 8), 18), normal((2, 6), 19), normal((2, 6), 20)
        jm = jl.CLNBlock(8)
        p = jm.init(KEY, x, s0, s1)
        m = ported(tl.CLNBlock(8, 8, 6), p)
        no_skip = m(t(x), t(s0), t(s1), skip=False)
        with_skip = m(t(x), t(s0), t(s1), skip=True)
        close(no_skip, jm.apply(p, x, s0, s1, skip=False))
        close(with_skip, jm.apply(p, x, s0, s1, skip=True))
        torch.testing.assert_close(with_skip, no_skip + t(x), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- nerf_variants.py

def _pts_styles(style_dim, freq_phase=False, hidden=16):
    pts = normal((2, 10, 3), 30, 0.05)
    d = {}
    for i, name in enumerate(("nerf_w0", "nerf_w1")):
        d[name] = normal((2, 2 * hidden if freq_phase else style_dim), 31 + i)
    d["nerf_rgb"] = normal((2, 2 * (hidden // 2) if freq_phase else style_dim), 39)
    return pts, d


class TestVariants:
    def test_cln_nerf(self):
        pts, styles = _pts_styles(12)
        jm = jv.NeRFNetworkCLN(hidden_dim=16, hidden_layers=2, rgb_dim=8)
        p = jm.init(KEY, pts, styles)
        out = ported(tv.NeRFNetworkCLN(hidden_dim=16, hidden_layers=2, rgb_dim=8, style_dim=12),
                     p)(t(pts), {k: t(v) for k, v in styles.items()})
        assert out.shape == (2, 10, 9) and torch.isfinite(out).all()
        close(out, jm.apply(p, pts, styles))

    @pytest.mark.parametrize("pos_embed", [False, True], ids=["xyz", "pos_embed"])
    def test_freq_phase_nerf(self, pos_embed):
        pts, styles = _pts_styles(None, freq_phase=True, hidden=16)
        rgb = 4 if pos_embed else 8
        jm = jv.NeRFNetworkFreqPhase(hidden_dim=16, hidden_layers=2, rgb_dim=rgb,
                                     use_pos_embed=pos_embed)
        p = jm.init(KEY, pts, styles)
        out = ported(tv.NeRFNetworkFreqPhase(hidden_dim=16, hidden_layers=2, rgb_dim=rgb,
                                             use_pos_embed=pos_embed), p)(
            t(pts), {k: t(v) for k, v in styles.items()})
        assert out.shape == (2, 10, rgb + 1)
        close(out, jm.apply(p, pts, styles))

    def test_small(self):
        pts = normal((1, 6, 3), 40)
        styles = {"nerf_w0": normal((1, 16), 41), "nerf_rgb": normal((1, 16), 42)}
        jm = jv.NeRFNetworkSmall(rgb_dim=8)
        p = jm.init(KEY, pts, styles)
        m = ported(tv.NeRFNetworkSmall(rgb_dim=8, style_dim=16), p["params"], siren_state_dict)
        rgb, sigma = m(t(pts), {k: t(v) for k, v in styles.items()})
        assert len(m.network) == 1 and rgb.shape == (1, 6, 8)
        close(torch.cat([rgb, sigma], -1), jm.apply(p, pts, styles))

    @pytest.mark.parametrize("variant", ["L", "color_hidden_dim"])
    def test_wide_colour(self, variant):
        """NeRFNetworkL, and NeRFNetwork's ``color_hidden_dim`` itself."""
        pts, styles = _pts_styles(12)
        if variant == "L":
            jm, m = jv.NeRFNetworkL(rgb_dim=8), tv.NeRFNetworkL(rgb_dim=8, style_dim=12)
            width = 128
        else:
            width = 24
            jm = JaxNeRF(hidden_dim=16, rgb_dim=8, color_hidden_dim=width)
            m = NeRFNetwork(hidden_dim=16, rgb_dim=8, style_dim=12, color_hidden_dim=width)
        p = jm.init(KEY, pts, styles)
        m = ported(m, p["params"], siren_state_dict)
        assert m.color_layer_sine.linear.weight.shape[0] == width
        rgb, sigma = m(t(pts), {k: t(v) for k, v in styles.items()})
        close(torch.cat([rgb, sigma], -1), jm.apply(p, pts, styles))


class TestNeRFNetworkSigma:
    def test_forward_and_grads(self):
        pts = normal((2, 10, 3), 50, 0.1)
        styles = {f"nerf_w{i}": normal((2, 16), 51 + i) for i in range(2)}
        jm = jv.NeRFNetworkSigma(hidden_dim=16, hidden_layers=2, rgb_dim=8)
        p = jm.init(KEY, pts, styles)
        m = ported(tv.NeRFNetworkSigma(hidden_dim=16, hidden_layers=2, rgb_dim=8, style_dim=16),
                   p)
        ts = {k: t(v).requires_grad_(True) for k, v in styles.items()}
        out = m(t(pts), ts)
        assert out.shape == (2, 10, 9)
        close(out, jm.apply(p, pts, styles))
        # only the sigma path is style-conditioned: d(sigma)/d(style) != 0,
        # d(rgb)/d(style) == 0; the parameter grads of the whole output
        for part, sl in (("sigma", np.s_[..., -1]), ("rgb", np.s_[..., :-1])):
            ref = jax.grad(lambda s: jnp.sum(jm.apply(p, pts, s)[sl]))(styles)
            got = torch.autograd.grad(out[sl].sum(), list(ts.values()), retain_graph=True)
            for (k, r), g in zip(ref.items(), got):
                assert grad_err(g.numpy(), r) < 1e-4, (part, k)
            peak = max(float(jnp.abs(v).max()) for v in ref.values())
            if part == "sigma":
                assert peak > 0
            else:
                assert peak == 0 and all(g.abs().max() == 0 for g in got)
        ref_p = jax.grad(lambda q: jnp.sum(jm.apply(q, pts, styles)))(p)
        out.sum().backward()
        ref_sd = tree_state_dict(jax.tree_util.tree_map(np.asarray, ref_p))
        for name, param in m.named_parameters():
            assert grad_err(param.grad.numpy(), ref_sd[name]) < 1e-4, name


# ---------------------------------------------------------------- initializers

def test_normal_kernel_matches_jax():
    shape = (256, 512)
    ref = np.asarray(jax_init.normal_kernel(0.5)(jax.random.PRNGKey(0), shape))
    out = winit.normal_kernel(0.5)(shape, torch.Generator().manual_seed(0)).numpy()
    assert out.shape == shape and out.dtype == np.float32
    np.testing.assert_allclose(out.std(), ref.std(), rtol=0.02)
    assert abs(out.mean()) < 0.02 * ref.std()
    a = winit.normal_kernel(0.5)(shape, torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, winit.normal_kernel(0.5)(shape, torch.Generator().manual_seed(3)),
                               rtol=0, atol=0)
