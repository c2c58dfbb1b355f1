"""The port's serving render as a whole, against the JAX package.

`cips3d_tpu_torch.apps.render.render_chunked` against
`cips3d_tpu.apps.render.render_chunked_traced` with the shipped serving flags
(fused ray tile + fused INR + fast_sin), an explicit camera and more than
one chunk, on the same (bridged) weights.  The depth jitter and each chunk's
ray-tile draws are rebuilt from the JAX key splits (`render.py:95,134`,
`rays.py:83`, `ray_tile.py:953-965`).  Then `RenderService` and its HTTP
handlers on the CPU with a tiny config.
"""

import http.client
import io
import json
import threading

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
from cips3d_tpu_torch.apps.render import render_chunked
from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR, RenderOptions
from cips3d_tpu_torch.ops.ray_tile import RayDraws
from cips3d_tpu_torch.utils.convert import load_jax_params

TINY = dict(z_dim_nerf=16, z_dim_inr=32, nerf_hidden_dim=32, nerf_style_dim=32,
            nerf_rgb_dim=16, nerf_mapping_layers=2, inr_hidden_dim=32, inr_style_dim=32,
            inr_mapping_layers=2)
# the serving flags, in both packages: both forward kernels and fast_sin
SERVING = dict(fused_ray=True, fused_inr=True, fast_sin=True)
JAX_SERVING = SERVING
KERNEL_TOL = dict(rtol=2e-4, atol=2e-5)


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _chunk_draws(key, b, chunk, S):
    k_pdf, _, _ = jax.random.split(key, 3)
    u = jax.random.uniform(k_pdf, (b * chunk, S), jnp.float32).reshape(b, chunk, S)
    return RayDraws(t(u), torch.zeros(b, chunk, S), torch.zeros(b, chunk, 2 * S))


@pytest.mark.parametrize("psi", [1.0, 0.7])
def test_render_chunked_matches_jax(psi):
    cfg = JaxConfig(**TINY, **JAX_SERVING)
    jgen = JaxGenerator(cfg=cfg)
    zs = jax_sample_zs(jax.random.PRNGKey(0), 1, cfg)
    params = jgen.init(jax.random.PRNGKey(1), zs, jax.random.PRNGKey(2),
                       JaxOptions(img_size=8, num_steps=4))
    params = jax.tree_util.tree_map(np.asarray, params)
    port = GeneratorNerfINR(GeneratorConfig(**TINY, **SERVING))
    load_jax_params(port, params)

    size, S, fp, b = 8, 6, 32, 1
    opts = dict(img_size=size, num_steps=S, h_stddev=0.0, v_stddev=0.0)
    pos = np.array([[0.25, 0.15, 0.956]], np.float32)
    pos /= np.linalg.norm(pos)
    jst = jgen.apply(params, zs["z_nerf"], zs["z_inr"], method=jgen.mapping)
    with torch.no_grad():
        st = port.mapping(t(zs["z_nerf"]), t(zs["z_inr"]))
        if psi < 1.0:   # truncation toward a shared mean style
            avg = {k: np.asarray(v).mean(0, keepdims=True) * 0.5 for k, v in jst.items()}
            jst = {k: avg[k] + psi * (v - avg[k]) for k, v in jst.items()}
            st = {k: t(avg[k]) + psi * (v - t(avg[k])) for k, v in st.items()}
    for k in jst:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]), rtol=1e-4, atol=1e-5)

    key = jax.random.PRNGKey(7)
    ref_img, ref_dep = render_chunked_traced(
        params, jgen, jst, JaxOptions(**opts), key, fp, jnp.asarray(pos), jnp.asarray(-pos),
        None, True)
    k_rays, k_pts = jax.random.split(key)
    k_perturb, _ = jax.random.split(k_rays)
    uniform = jax.random.uniform(k_perturb, (b, size * size, S, 1), jnp.float32)
    n_chunks = size * size // fp
    draws = [_chunk_draws(k, b, fp, S) for k in jax.random.split(k_pts, n_chunks)]
    img, dep = render_chunked(port, st, RenderOptions(**opts), None, fp, t(pos), t(-pos),
                              None, return_depth=True, perturb_uniform=t(uniform),
                              chunk_draws=draws)
    assert img.shape == (b, 3, size, size) and dep.shape == (b, 1, size, size)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref_img), **KERNEL_TOL)
    np.testing.assert_allclose(dep.numpy(), np.asarray(ref_dep), **KERNEL_TOL)


def test_generator_forward_and_truncation():
    from cips3d_tpu_torch.models.generator import (generate_avg_styles, sample_zs,
                                                   truncate_styles)

    port = GeneratorNerfINR(GeneratorConfig(**TINY, **SERVING),
                            generator=torch.Generator().manual_seed(4))
    cfg = port.cfg
    zs = sample_zs(2, cfg, torch.Generator().manual_seed(5))
    avg_zs = sample_zs(16, cfg, torch.Generator().manual_seed(6))
    avg = generate_avg_styles(port, zs=avg_zs)
    with torch.no_grad():
        mapped = port.mapping(avg_zs["z_nerf"], avg_zs["z_inr"])
    for k, v in avg.items():
        torch.testing.assert_close(v, mapped[k].mean(0, keepdim=True))
    with torch.no_grad():
        st = port.mapping(zs["z_nerf"], zs["z_inr"])
    for k, v in truncate_styles(st, avg, 1.0).items():
        torch.testing.assert_close(v, st[k])
    opts = RenderOptions(img_size=8, num_steps=4, psi=0.5)
    imgs, pitch_yaw = port(zs, opts, torch.Generator().manual_seed(7), return_aux_img=True,
                           avg_styles=avg)
    assert imgs.shape == (4, 3, 8, 8) and pitch_yaw.shape == (4, 2)
    assert torch.isfinite(imgs).all() and imgs.abs().max() <= 1.0
    # the same styles and draws through forward_with_rays give the same image
    world = port.sample_world(2, opts, torch.Generator().manual_seed(8))
    draws = RayDraws(torch.rand(2, 64, 4), torch.zeros(2, 64, 4), torch.zeros(2, 64, 8))
    a, _ = port.forward_with_rays(st, world, opts, draws=draws)
    inr, _ = port.points_forward(st, world, opts, draws=draws)
    torch.testing.assert_close(a, inr.transpose(1, 2).reshape(2, 3, 8, 8))


def test_to_uint8_matches_jax():
    from cips3d_tpu.eval.images import to_uint8 as jax_to_uint8
    from cips3d_tpu_torch.eval.images import to_uint8

    img = np.random.default_rng(0).uniform(-1.2, 1.2, (3, 5, 7)).astype(np.float32)
    np.testing.assert_array_equal(to_uint8(img), jax_to_uint8(img))


def test_points_forward_needs_the_fused_ray_path():
    """Without fused_ray (or without hierarchical sampling) the chunked
    render takes the unfused NeRF stage (it raised before that stage was
    ported); depth 0 is refused only with fused_ray, and the INR-tile
    envelope still holds."""
    port = GeneratorNerfINR(GeneratorConfig(**TINY), generator=torch.Generator().manual_seed(0))
    img = render_chunked(port, port.mapping(torch.zeros(1, 16), torch.zeros(1, 32)),
                         RenderOptions(img_size=4, num_steps=3, hierarchical_sample=False),
                         torch.Generator().manual_seed(1), forward_points=8)
    assert img.shape == (1, 3, 4, 4) and torch.isfinite(img).all()
    GeneratorConfig(**TINY, nerf_hidden_layers=0)
    with pytest.raises(ValueError, match="nerf_hidden_layers"):
        GeneratorConfig(**TINY, nerf_hidden_layers=0, fused_ray=True)
    with pytest.raises(ValueError, match="INR-tile kernel"):
        GeneratorConfig(**TINY, fused_inr=True, inr_pre_rgb_dim=4)


# ---------------------------------------------------------------- service

@pytest.fixture(scope="module")
def service():
    from cips3d_tpu_torch.apps.serve import RenderService

    models = {name: GeneratorNerfINR(GeneratorConfig(**TINY, **SERVING),
                                     generator=torch.Generator().manual_seed(s))
              for name, s in (("ffhq", 0), ("afhq", 7))}
    return RenderService(models, img_size=8, num_steps=3, forward_points=32)


class TestRenderService:
    def test_frame(self, service):
        f = service.frame(seed=0)
        assert f.shape == (8, 8, 3) and f.dtype == np.uint8
        assert f.std() > 0

    def test_depth_frame(self, service):
        d = service.frame(seed=0, depth=True)
        assert d.shape == (8, 8, 3)
        assert (d[..., 0] == d[..., 1]).all()

    def test_pose_changes_frame(self, service):
        # compare the float render: at random init the tiny decoder's output
        # moves by less than one 8-bit level across poses
        a, da = service.render(seed=0, yaw=np.pi / 2 - 0.4)
        b, db = service.render(seed=0, yaw=np.pi / 2 + 0.4)
        assert not torch.equal(a, b) and not torch.equal(da, db)

    def test_same_request_same_frame(self, service):
        np.testing.assert_array_equal(service.frame(seed=2, psi=1.0),
                                      service.frame(seed=2, psi=1.0))

    def test_style_cache(self, service):
        service.frame(seed=3, psi=0.5)
        assert ("ffhq", 3, 0.5) in service._styles_cache

    def test_model_switch(self, service):
        a = service.frame(seed=0, model="ffhq")
        b = service.frame(seed=0, model="afhq")
        assert not np.array_equal(a, b)
        assert service.default_model == "ffhq"
        with pytest.raises(KeyError, match="afhq"):
            service.frame(seed=0, model="nope")


class TestHttpServer:
    @pytest.fixture(scope="class")
    def server(self, service):
        from cips3d_tpu_torch.apps.serve import serve

        httpd = serve(service, host="127.0.0.1", port=0)
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        yield httpd.server_address
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=10)
        assert not th.is_alive()

    def _get(self, addr, path):
        conn = http.client.HTTPConnection(*addr, timeout=60)
        conn.request("GET", path)
        r = conn.getresponse()
        body = r.read()
        conn.close()
        return r.status, r.getheader("Content-Type"), body

    def test_healthz(self, server):
        status, ctype, body = self._get(server, "/healthz")
        assert status == 200 and ctype == "application/json"
        info = json.loads(body)
        assert info["ok"] and info["devices"] >= 1 and info["device"]
        assert info["models"] == ["afhq", "ffhq"]

    def test_models_endpoint(self, server):
        status, _, body = self._get(server, "/models")
        info = json.loads(body)
        assert status == 200 and info == {"models": ["ffhq", "afhq"], "default": "ffhq"}

    def test_render_jpeg(self, server):
        from PIL import Image

        status, ctype, body = self._get(server, "/render?seed=1&yaw=1.2&pitch=1.6&depth=0")
        assert status == 200 and ctype == "image/jpeg"
        assert Image.open(io.BytesIO(body)).size == (8, 8)

    def test_render_errors(self, server):
        status, _, body = self._get(server, "/render?seed=1&model=nope")
        assert status == 404 and "available" in json.loads(body)["error"]
        status, ctype, _ = self._get(server, "/render?seed=abc")
        assert status == 400 and ctype == "application/json"
        assert self._get(server, "/nope")[0] == 404

    def test_index(self, server):
        status, ctype, body = self._get(server, "/")
        assert status == 200 and ctype == "text/html" and b"/render?seed=" in body
