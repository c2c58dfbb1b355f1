"""The port's host side against the JAX package (and PIL, which the JAX
package uses for images): the JPEG and PNG codecs, the Lanczos resize, the
YAML reader and command resolution, the dataset and loader, the text logs,
snapshots in both directions and the resume state, the FID machinery, and
the training CLI on the CPU at tiny widths.

Tolerances: PNG, resize, dataset items, YAML and resume states exact; the
JPEG within 1 dB PSNR of PIL's own encoding at the same quality; the
Fréchet distance and KID to 1e-10 relative on the same features; the
surrogate features to 1e-5 absolute (f32 convolutions summed in another
order) and the FID over image directories to 1e-4 relative; the JAX
generator on a port snapshot at rtol 1e-4 / atol 1e-5.
"""

import glob
import io
import json
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from cips3d_tpu_torch.utils import image_io
from cips3d_tpu_torch.utils.video import encode_jpeg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_OPTS = ["batch_size", "2", "fixed_z_bs", "2", "eval_batch_size", "4", "num_workers", "1",
             "grad_points", "null", "forward_points", "null", "render.num_steps", "3",
             "generator.z_dim_nerf", "16", "generator.z_dim_inr", "32",
             "generator.nerf_hidden_dim", "16", "generator.nerf_style_dim", "16",
             "generator.nerf_mapping_layers", "2", "generator.inr_hidden_dim", "32",
             "generator.inr_style_dim", "32", "generator.inr_mapping_layers", "2",
             "discriminator.max_size", "16", "discriminator.channels_override.4", "16",
             "discriminator.channels_override.8", "16", "discriminator.channels_override.16",
             "16"]


def _psnr(a, b):
    return 10 * np.log10(255.0 ** 2 / np.mean((a.astype(np.float64) - b) ** 2))


def _test_image(h, w, seed=0):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(xx / 9.0), 128 + 90 * np.cos(yy / 7.0),
                    (2 * xx + yy) % 256], -1)
    noise = np.random.default_rng(seed).integers(-12, 12, img.shape)
    return np.clip(img + noise, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------- JPEG

@pytest.mark.parametrize("quality", [50, 75, 90, 95])
@pytest.mark.parametrize("shape", [(128, 128), (37, 61)])
def test_jpeg_decodes_in_pil_close_to_pil_encoding(quality, shape):
    img = _test_image(*shape)
    data = encode_jpeg(img, quality)
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    ours = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality, subsampling=0)
    pil = np.asarray(Image.open(buf).convert("RGB"))
    assert ours.shape == img.shape
    assert _psnr(img, ours) >= _psnr(img, pil) - 1.0


def test_jpeg_tables_match_pil():
    """The quality-scaled quantization tables and the Huffman tables are
    the ones PIL writes."""
    img = _test_image(16, 16)

    def segments(d, marker):
        out, i = [], 2
        while d[i + 1] != 0xDA:
            n = int.from_bytes(d[i + 2:i + 4], "big")
            if d[i + 1] == marker:
                out.append(d[i + 4:i + 2 + n])
            i += 2 + n
        return b"".join(out)

    for q in (30, 90):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=q, subsampling=0)
        for marker in (0xDB, 0xC4):
            assert segments(encode_jpeg(img, q), marker) == segments(buf.getvalue(), marker)


# ---------------------------------------------------------------- PNG and resize

def _filtered_png(img, ftype):
    """A PNG whose every row uses filter ``ftype`` (a plain encoder)."""
    h, w, c = img.shape
    raw = img.reshape(h, w * c).astype(np.int64)
    rows = []
    for y in range(h):
        x, up = raw[y], raw[y - 1] if y else np.zeros_like(raw[0])
        left = np.concatenate([np.zeros(c, np.int64), x[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if ftype == 0:
            f = x
        elif ftype == 1:
            f = x - left
        elif ftype == 2:
            f = x - up
        elif ftype == 3:
            f = x - (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
            f = x - pred
        rows.append(bytes([ftype]) + (f % 256).astype(np.uint8).tobytes())
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (image_io.PNG_SIGNATURE
            + image_io._chunk(b"IHDR", np.array([w, h], ">u4").tobytes()
                              + bytes([8, ctype, 0, 0, 0]))
            + image_io._chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + image_io._chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_round_trips_and_pil_agrees(channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (13, 17, channels), dtype=np.uint8)
    data = image_io.encode_png(img)
    np.testing.assert_array_equal(image_io.decode_png(data), img)
    mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[channels]
    pil_img = Image.open(io.BytesIO(data))
    assert pil_img.mode == mode
    np.testing.assert_array_equal(np.asarray(pil_img).reshape(img.shape), img)
    for optimize in (False, True):
        buf = io.BytesIO()
        Image.fromarray(img[..., 0] if channels == 1 else img, mode).save(
            buf, format="PNG", optimize=optimize)
        got = image_io.decode_png(buf.getvalue())
        np.testing.assert_array_equal(got, img)
        np.testing.assert_array_equal(image_io.to_rgb(got),
                                      np.asarray(Image.open(buf).convert("RGB")))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "average", "paeth"])
def test_png_filters_decode_as_pil(ftype):
    img = _test_image(11, 9)[..., :3]
    data = _filtered_png(img, ftype)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    np.testing.assert_array_equal(image_io.decode_png(data), img)


@pytest.mark.parametrize("src,dst", [((64, 64), (32, 32)), ((256, 256), (64, 64)),
                                     ((37, 53), (20, 31)), ((16, 16), (64, 64)),
                                     ((50, 40), (50, 13))])
def test_lanczos_resize_matches_pil(src, dst):
    img = np.random.default_rng(3).integers(0, 256, src + (3,), dtype=np.uint8)
    ref = np.asarray(Image.fromarray(img).resize((dst[1], dst[0]), Image.LANCZOS))
    np.testing.assert_array_equal(image_io.resize_lanczos(img, dst[1], dst[0]), ref)


def test_image_grid_writes_png_and_jpeg(tmp_path):
    from cips3d_tpu.eval.images import save_image_grid as jax_grid

    imgs = np.random.default_rng(4).uniform(-1, 1, (5, 3, 8, 8)).astype(np.float32)
    image_io.save_image_grid(imgs, str(tmp_path / "a.png"), 2)
    jax_grid(imgs, str(tmp_path / "b.png"), 2)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")),
                                  np.asarray(Image.open(tmp_path / "b.png")))
    image_io.save_image_grid(imgs, str(tmp_path / "a.jpg"), 2)
    assert Image.open(tmp_path / "a.jpg").size == (16, 24)


# ---------------------------------------------------------------- YAML and configs

CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_yaml_reader_matches_pyyaml(path):
    from cips3d_tpu_torch.config import yaml_lite

    with open(path) as f:
        text = f.read()
    doc = yaml_lite.safe_load(text)
    assert doc == yaml.safe_load(text)
    assert yaml_lite.safe_load(yaml_lite.safe_dump(doc)) == doc


def _commands(name):
    with open(os.path.join(ROOT, "configs", name)) as f:
        doc = yaml.safe_load(f)
    return [(name, k) for k, v in doc.items() if isinstance(v, dict)]


@pytest.mark.parametrize("name,command", [
    c for name in ("ffhq.yaml", "synthetic.yaml", "finetune.yaml", "synthetic_progressive.yaml",
                   "diffcam.yaml", "pigan.yaml") for c in _commands(name)])
def test_resolve_command_matches_jax(name, command):
    from cips3d_tpu.config.config import resolve_command as jax_resolve
    from cips3d_tpu_torch.config.config import resolve_command

    path = os.path.join(ROOT, "configs", name)
    opts = ["generator.fast_sin", "false", "gen_lr", "1e-5", "discriminator.channels_override.4",
            "16", "outdir", "x/y"]
    assert resolve_command(path, command, opts).to_dict() == jax_resolve(path, command,
                                                                         opts).to_dict()


def test_yaml_scalars_and_overrides_match_pyyaml():
    from cips3d_tpu.config.config import _parse_value as jax_parse
    from cips3d_tpu_torch.config import yaml_lite
    from cips3d_tpu_torch.config.config import _parse_value

    text = ("a: [1, 2.5, x, 'y z']\nb: {p: 1, q: null}\nc:\n  - 1\n  - e: 2\n    f: 3\n"
            "  - - 4\n    - 5\nd: ~\ne: yes\nf: 1e-5\ng: 1.0e-5\nh: 0x1F\ni: 017\n"
            "j: \"a\\tb\"\nk: 'it''s'\nl: .inf\nm: -3_000\nn: a # c\no: a#b\np: &x\n  q: 1\n"
            "r: *x\ns: []\nt: {}\n")
    assert yaml_lite.safe_load(text) == yaml.safe_load(text)
    for v in ("true", "8", "1e-4", "0.5", "null", "abc", "[1, 2]", "-3", "1_000", "off"):
        assert _parse_value(v) == jax_parse(v), v


# ---------------------------------------------------------------- data

@pytest.fixture(scope="module")
def blob_zips(tmp_path_factory):
    from cips3d_tpu.data.synthetic import make_blob_dataset as jax_blobs
    from cips3d_tpu_torch.data.synthetic import make_blob_dataset

    d = tmp_path_factory.mktemp("blobs")
    return (make_blob_dataset(str(d / "port.zip"), 6, img_size=16, seed=3),
            jax_blobs(str(d / "jax.zip"), 6, img_size=16, seed=3))


def test_blob_dataset_matches_jax(blob_zips):
    from cips3d_tpu.data.zip_dataset import ZipImageDataset as JaxDataset
    from cips3d_tpu_torch.data.zip_dataset import ZipImageDataset

    port, ref = blob_zips
    a, b = ZipImageDataset(port), JaxDataset(ref, use_native=False)
    assert len(a) == len(b) == 6
    for i in range(6):
        np.testing.assert_array_equal(a[i][0], b[i][0])


@pytest.mark.parametrize("resize,xflip,cache", [(None, False, False), (8, True, False),
                                                (8, True, True)])
def test_zip_dataset_items_match_jax(blob_zips, resize, xflip, cache, tmp_path):
    import shutil

    from cips3d_tpu.data.zip_dataset import DataLoader as JaxLoader
    from cips3d_tpu.data.zip_dataset import ZipImageDataset as JaxDataset
    from cips3d_tpu.data.zip_dataset import to_norm_tensor as jax_norm
    from cips3d_tpu_torch.data.zip_dataset import DataLoader, ZipImageDataset, to_norm_tensor

    path = str(tmp_path / "d.zip")
    shutil.copy(blob_zips[1], path)   # the JAX package's zip (PIL's PNGs)
    a = ZipImageDataset(path, resize_resolution=resize, xflip=xflip, cache_decoded=cache)
    b = JaxDataset(path, resize_resolution=resize, xflip=xflip, use_native=False)
    assert len(a) == len(b)
    for i in range(len(a)):
        np.testing.assert_array_equal(a[i][0], b[i][0])
        assert a[i][1] == b[i][1]
    la = DataLoader(a, batch_size=3, seed=5, num_workers=1)
    lb = JaxLoader(b, batch_size=3, seed=5, num_workers=1)
    try:
        for _ in range(3):
            xa, xb = next(la)[0], next(lb)[0]
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(to_norm_tensor(xa), jax_norm(xb))
    finally:
        la.close()
        lb.close()


# ---------------------------------------------------------------- text logs

def test_jax_reads_the_port_text_logs(tmp_path):
    from cips3d_tpu.utils.textlogger import read_log as jax_read_log
    from cips3d_tpu_torch.utils.textlogger import TextLogger, read_log, summary_defaultdict

    log = TextLogger(str(tmp_path))
    summary = summary_defaultdict()
    summary["d_loss"]["d_loss"] = 1.25
    for step in (10, 20):
        log.log_dict(summary, prefix="train", step=step)
    log.log_scalar("eval.FID.FID", 20, 3.14159265)
    log.close()
    for name, want in (("train.d_loss.d_loss", ([10, 20], [1.25, 1.25])),
                       ("eval.FID.FID", ([20], [3.14159]))):
        path = str(tmp_path / f"{name}.log")
        assert jax_read_log(path) == read_log(path) == want


# ---------------------------------------------------------------- snapshots

def _port_state(gflags=None, seed=0):
    from cips3d_tpu_torch.models.discriminator import DiscriminatorMultiScaleAux
    from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR
    from cips3d_tpu_torch.train.state import TrainConfig
    from cips3d_tpu_torch.train.step import init_train_state
    from test_torch_volume import GCFG

    tiny = {r: 16 for r in (4, 8, 16, 32, 64, 128, 256, 512, 1024)}
    gen = GeneratorNerfINR(GeneratorConfig(**GCFG, **(gflags or {})),
                           generator=torch.Generator().manual_seed(seed))
    disc = DiscriminatorMultiScaleAux(max_size=16, channels_override=tiny,
                                      generator=torch.Generator().manual_seed(seed + 1))
    return init_train_state(gen, disc, TrainConfig(img_size=8, batch_size=2, grad_points=None,
                                                   ema_start_itr=0))


def test_port_snapshot_loads_in_jax_and_reproduces_the_forward(tmp_path):
    """A port snapshot through the JAX package's CheckpointManager: the
    JAX generator on those weights renders what the port renders."""
    from cips3d_tpu.models.generator import GeneratorConfig as JaxConfig
    from cips3d_tpu.models.generator import GeneratorNerfINR as JaxG
    from cips3d_tpu.models.generator import RenderOptions as JaxOptions
    from cips3d_tpu.utils.checkpoint import CheckpointManager as JaxManager
    from cips3d_tpu_torch.models.generator import RenderOptions, sample_zs
    from cips3d_tpu_torch.train.loop import _modules
    from cips3d_tpu_torch.utils.checkpoint import CheckpointManager
    from test_torch_volume import GCFG, _jax_params, forward_draws

    state = _port_state()
    with torch.no_grad():   # move the EMA away from G so the modules differ
        for p in state.ema.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=torch.Generator().manual_seed(9)))
    CheckpointManager(str(tmp_path)).save_snapshot("best_fid", _modules(state), {"step": 3})
    ref = _jax_params(2)
    loaded = JaxManager(str(tmp_path)).load_snapshot("best_fid", {"G_ema": ref,
                                                                  "generator": ref})
    zs = {k: v.numpy() for k, v in sample_zs(2, state.ema.cfg,
                                             torch.Generator().manual_seed(4)).items()}
    key = jax.random.PRNGKey(5)
    opts = dict(img_size=8, num_steps=4, nerf_noise=0.5)
    jgen = JaxG(cfg=JaxConfig(**GCFG))
    render = jax.jit(lambda p: jgen.apply(p, zs, key, JaxOptions(**opts), return_aux_img=True))
    for name, module in (("G_ema", state.ema), ("generator", state.generator)):
        ref_imgs, _ = render(loaded[name])
        with torch.no_grad():
            imgs, _ = module({k: torch.from_numpy(v) for k, v in zs.items()},
                             RenderOptions(**opts), return_aux_img=True,
                             draws=forward_draws(key, 2, None))
        np.testing.assert_allclose(imgs.numpy(), np.asarray(ref_imgs), rtol=1e-4, atol=1e-5)


def test_jax_snapshot_loads_in_the_port(tmp_path):
    from cips3d_tpu.utils.checkpoint import CheckpointManager as JaxManager
    from cips3d_tpu_torch.utils import convert
    from cips3d_tpu_torch.utils.checkpoint import CheckpointManager, load_snapshot_module
    from test_torch_volume import _jax_params

    params = _jax_params(2)
    JaxManager(str(tmp_path)).save_snapshot("best_fid", {"G_ema": params}, {"step": 1})
    got = CheckpointManager(str(tmp_path)).load_snapshot("best_fid", ("G_ema",))["G_ema"]
    want = convert.state_dict_from_jax(params)
    sd = convert.state_dict_from_jax(got)
    assert sd.keys() == want.keys()
    for k in sd:
        np.testing.assert_array_equal(sd[k], want[k])
    assert load_snapshot_module(str(tmp_path / "best_fid"))["params"].keys() == \
        params["params"].keys()


def test_resume_state_round_trips_bit_for_bit(tmp_path):
    """Two steps, then the resume tree (G, EMA, D, both Adam states, the
    step) into a fresh state: every tensor equal; the JAX package reads the
    Adam states into optax's structure."""
    import optax

    from cips3d_tpu.utils.checkpoint import CheckpointManager as JaxManager
    from cips3d_tpu_torch.models.generator import RenderOptions
    from cips3d_tpu_torch.train.loop import _load_modules, _modules, _opt_states
    from cips3d_tpu_torch.train.step import make_train_step
    from cips3d_tpu_torch.utils import convert
    from cips3d_tpu_torch.utils.checkpoint import CheckpointManager
    from test_torch_volume import _jax_params

    state = _port_state()
    fn = make_train_step(state.generator, state.discriminator, _train_cfg(), RenderOptions(
        num_steps=3), aux_reg=True)
    rng = torch.Generator().manual_seed(6)
    for _ in range(2):
        state, _ = fn(state, torch.rand((2, 3, 8, 8), generator=rng) * 2 - 1, rng=rng)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_snapshot("resume", dict(_modules(state), **_opt_states(state)), {"step": state.step})

    fresh = _port_state(seed=7)
    loaded = mgr.load_snapshot("resume", ("generator", "G_ema", "discriminator", "g_opt",
                                          "d_opt"))
    _load_modules(fresh, loaded)
    convert.load_optax_adam_state(fresh.g_opt, fresh.generator, loaded["g_opt"],
                                  convert.state_dict_from_jax)
    convert.load_optax_adam_state(fresh.d_opt, fresh.discriminator, loaded["d_opt"],
                                  convert.discriminator_state_dict)
    # the JAX layout carries every parameter the forward reads; the reference's unused
    # LayerNorms and the ToRGB heads before block FIRST_RGB come back as placeholders
    carried = set(convert.state_dict_from_jax(_modules(state)["generator"])) - {
        k for k in convert.state_dict_from_jax(_modules(state)["generator"])
        if ".norm." in k or any(f"to_rgbs.{r}." in k for r in ("4", "8", "16"))}
    for a, b in ((state.generator, fresh.generator), (state.ema, fresh.ema),
                 (state.discriminator, fresh.discriminator)):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            if a is state.discriminator or k in carried:
                assert torch.equal(x, y), k
    for opt_a, opt_b, mod_a, mod_b in ((state.g_opt, fresh.g_opt, state.generator,
                                        fresh.generator),
                                       (state.d_opt, fresh.d_opt, state.discriminator,
                                        fresh.discriminator)):
        for (name, pa), pb in zip(mod_a.named_parameters(), mod_b.parameters()):
            if mod_a is state.generator and name not in carried:
                continue   # unused: zero gradients, zero moments either way
            sa, sb = opt_a.state[pa], opt_b.state[pb]
            assert float(sa["step"]) == float(sb["step"]) == 2.0
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(sa[k], sb[k]), (name, k)

    ref = jax.tree_util.tree_map(jnp.asarray, _jax_params(2))
    jopt = JaxManager(str(tmp_path)).load_snapshot(
        "resume", {"g_opt": optax.adam(1e-3).init(ref)})["g_opt"]
    assert int(jopt[0].count) == 2
    mu = convert.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jopt[0].mu))
    for name, p in state.generator.named_parameters():
        if name in carried:
            np.testing.assert_array_equal(mu[name], state.g_opt.state[p]["exp_avg"].numpy())


def _train_cfg():
    from cips3d_tpu_torch.train.state import TrainConfig

    return TrainConfig(img_size=8, batch_size=2, grad_points=None, ema_start_itr=0)


# ---------------------------------------------------------------- FID

def test_frechet_and_kid_match_jax():
    from cips3d_tpu.eval import fid as jf
    from cips3d_tpu_torch.eval import fid as pf

    rng = np.random.default_rng(8)
    a = rng.standard_normal((60, 12))
    b = rng.standard_normal((50, 12)) * 1.3 + 0.2
    sa, sb = pf.activation_statistics(a), pf.activation_statistics(b)
    for x, y in zip(sa + sb, jf.activation_statistics(a) + jf.activation_statistics(b)):
        np.testing.assert_array_equal(x, y)
    ref = jf.frechet_distance(*jf.activation_statistics(a), *jf.activation_statistics(b))
    assert abs(pf.frechet_distance(*sa, *sb) - ref) <= 1e-10 * abs(ref)
    ref = jf.kid_mmd(a, b, subset_size=20, n_subsets=5)
    assert abs(pf.kid_mmd(a, b, subset_size=20, n_subsets=5) - ref) <= 1e-10 * abs(ref)


@pytest.mark.parametrize("size", [32, 64, 96])
def test_surrogate_features_match_jax(size):
    from cips3d_tpu.eval import fid as jf
    from cips3d_tpu_torch.eval import fid as pf

    x = np.random.default_rng(size).integers(0, 256, (3, size, size, 3), dtype=np.uint8)
    np.testing.assert_allclose(pf.surrogate_extractor(device="cpu")(x),
                               jf.surrogate_extractor()(x), rtol=0, atol=1e-5)


def test_eval_fid_over_directories_matches_jax(tmp_path):
    from cips3d_tpu.eval import fid as jf
    from cips3d_tpu_torch.eval import fid as pf

    rng = np.random.default_rng(10)
    for name, shift in (("real", 0), ("fake", 40)):
        os.makedirs(tmp_path / name)
        for i in range(12):
            img = np.clip(rng.integers(0, 200, (16, 16, 3)) + shift, 0, 255).astype(np.uint8)
            image_io.write_png(str(tmp_path / name / f"{i:03d}.png"), img)
    got = pf.eval_fid(str(tmp_path / "real"), str(tmp_path / "fake"), kid=True, device="cpu")
    ref = jf.eval_fid(str(tmp_path / "real"), str(tmp_path / "fake"),
                      extractor=jf.surrogate_extractor(), kid=True)
    assert got.keys() == ref.keys() == {"FID_surrogate", "KID_surrogate"}
    for k in got:
        assert abs(got[k] - ref[k]) <= 1e-4 * abs(ref[k]), (k, got[k], ref[k])
    with pytest.raises(RuntimeError, match="surrogate"):
        pf.eval_fid(str(tmp_path / "real"), str(tmp_path / "fake"), require_reference=True,
                    device="cpu")


# ---------------------------------------------------------------- the CLI

def test_cli_trains_r32_then_finetunes_r64_on_the_cpu(tmp_path, capsys, monkeypatch):
    """`train_r32 --debug` then `train_r64 --debug` from configs/ffhq.yaml on
    the CPU at tiny widths: step and FID lines, the text logs, the
    snapshots (which the JAX package's reader loads), and the finetune;
    then configs/diffcam.yaml's `train_r32 --debug`."""
    from cips3d_tpu.utils.checkpoint import load_pytree as jax_load_pytree
    from cips3d_tpu_torch.data.synthetic import make_blob_dataset
    from cips3d_tpu_torch.train import cli

    monkeypatch.chdir(tmp_path)
    make_blob_dataset("d.zip", 8, img_size=16, seed=0)
    for command, size in (("train_r32", 8), ("train_r64", 16)):
        assert cli.main(["--config", os.path.join(ROOT, "configs", "ffhq.yaml"), "--command",
                         command, "--debug", "--device", "cpu", "--opts", *TINY_OPTS,
                         "img_size", str(size), "data_path", "d.zip"]) == 0
        out = capsys.readouterr().out
        assert "step 2: d_loss=" in out and "FID_surrogate=" in out
        run = tmp_path / "results" / "ffhq" / command
        logs = os.listdir(run / "textdir")
        assert "train.d_loss.d_loss.log" in logs and "eval.FID_surrogate.FID_surrogate.log" in logs
        best = run / "ckptdir" / "best_fid"
        assert {"generator.npz", "G_ema.npz", "discriminator.npz"} <= set(os.listdir(best))
        assert "['params']['siren']['film_0']['linear']['kernel']" in np.load(
            best / "G_ema.npz").files
        assert jax_load_pytree(str(best / "G_ema.npz"))["params"]["inr_net"]
        assert {"g_opt.npz", "d_opt.npz", "0Gz_ema.jpg"} <= set(os.listdir(run / "ckptdir" /
                                                                          "resume"))
    assert "loading finetune weights from results/ffhq/train_r32/ckptdir/best_fid" in out
    # train_r512's 2-D layout (ray_shards 4) in one process: the JAX loop's ValueError
    with pytest.raises(ValueError, match="ray_shards=4 must divide device count 1"):
        cli.main(["--config", os.path.join(ROOT, "configs", "ffhq.yaml"), "--command",
                  "train_r512", "--device", "cpu", "--opts", "data_path", "d.zip"])
    # the diffcam pipeline trains too (it was refused before the variants were ported):
    # its camera in every snapshot tree, its Adam in resume
    assert cli.main(["--config", os.path.join(ROOT, "configs", "diffcam.yaml"), "--command",
                     "train_r32", "--debug", "--device", "cpu", "--opts", *TINY_OPTS,
                     "nerf_kwargs.n_samples", "3", "nerf_kwargs.n_importance", "3",
                     "img_size", "8", "data_path", "d.zip"]) == 0
    out = capsys.readouterr().out
    assert "step 2: d_loss=" in out and "FID_surrogate=" in out
    ckpt = tmp_path / "results" / "diffcam" / "train_r32" / "ckptdir"
    for tree in ("best_fid", "resume", "ckpt_00000000"):
        assert "['params']['fx_raw']" in np.load(ckpt / tree / "cam_param.npz").files
    assert "[0].mu['params']['fx_raw']" in np.load(ckpt / "resume" / "cam_opt.npz").files


def test_cli_finetunes_afhq_from_an_r32_snapshot_on_the_cpu(tmp_path, capsys, monkeypatch):
    """configs/finetune.yaml's `finetune_afhq` through the port's CLI at tiny
    widths, as the JAX package's slow `test_finetune_end_to_end`: an r32
    debug snapshot of configs/ffhq.yaml, then the finetune on another zip
    from it.  It loads the snapshot, copies the EMA's NeRF into G
    (`load_nerf_ema`) and keeps it frozen: G's siren, NeRF mapping and aux
    head in the finetune's resume tree equal the source G_ema's bit for bit,
    while G's INR has moved from the source G's."""
    from cips3d_tpu_torch.data.synthetic import make_blob_dataset
    from cips3d_tpu_torch.train import cli
    from cips3d_tpu_torch.utils.checkpoint import CheckpointManager

    monkeypatch.chdir(tmp_path)
    make_blob_dataset("ffhq.zip", 4, img_size=8, seed=0)
    make_blob_dataset("afhq.zip", 4, img_size=8, seed=1)
    common = ["--debug", "--device", "cpu", "--opts", *TINY_OPTS, "img_size", "8"]
    assert cli.main(["--config", os.path.join(ROOT, "configs", "ffhq.yaml"), "--command",
                     "train_r32", *common, "data_path", "ffhq.zip"]) == 0
    best = "results/ffhq/train_r32/ckptdir/best_fid"
    capsys.readouterr()
    assert cli.main(["--config", os.path.join(ROOT, "configs", "finetune.yaml"), "--command",
                     "finetune_afhq", *common, "data_path", "afhq.zip", "finetune_dir",
                     best]) == 0
    out = capsys.readouterr().out
    assert f"loading finetune weights from {best}" in out and "step 2: d_loss=" in out
    src = CheckpointManager("results/ffhq/train_r32/ckptdir").load_snapshot(
        "best_fid", ("generator", "G_ema"))
    got = CheckpointManager("results/finetune/finetune_afhq/ckptdir").load_snapshot(
        "resume", ("generator",))["generator"]["params"]

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield prefix + k, np.asarray(v)

    for mod in ("siren", "mapping_network_nerf", "aux_to_rgb"):
        ema = dict(leaves(src["G_ema"]["params"][mod]))
        assert ema and all(np.array_equal(v, ema[k]) for k, v in leaves(got[mod])), mod
    src_g = dict(leaves(src["generator"]["params"]["siren"]))   # the EMA's, not G's, NeRF
    assert any(not np.array_equal(v, src_g[k]) for k, v in leaves(got["siren"]))
    src_inr = dict(leaves(src["generator"]["params"]["inr_net"]))
    assert any(not np.array_equal(v, src_inr[k]) for k, v in leaves(got["inr_net"]))


def test_loop_resume_nerf_ema_guard_and_sealed_outdir(tmp_path):
    """`train` on the CPU at tiny widths: a run, then a resume from its
    resume tree (step, weights and Adam moments picked up), a run with
    lr 1e8 whose non-finite steps dump ``*_crupted`` snapshots, a profiled
    run (its chunk's dispatch and the step's phases in the trace),
    ``load_nerf_ema`` (G's NeRF from the EMA), and the refusal of a sealed
    outdir."""
    from cips3d_tpu_torch.data.synthetic import make_blob_dataset
    from cips3d_tpu_torch.models.generator import GeneratorConfig, RenderOptions
    from cips3d_tpu_torch.train.loop import LoopConfig, train
    from cips3d_tpu_torch.train.state import TrainConfig
    from cips3d_tpu_torch.utils.checkpoint import CheckpointManager
    from test_torch_volume import GCFG

    data = make_blob_dataset(str(tmp_path / "d.zip"), 6, img_size=8, seed=1)
    tiny = {r: 16 for r in (4, 8, 16)}

    def run(outdir, total, **kw):
        loop = LoopConfig(outdir=str(tmp_path / outdir), data_path=data, eval_every=2,
                          log_every=1, num_images_real_eval=4, num_images_gen_eval=4,
                          eval_batch_size=2, fixed_z_bs=2, num_workers=1, device="cpu",
                          profile_steps=kw.pop("profile_steps", 0))
        tcfg = TrainConfig(img_size=8, batch_size=2, grad_points=None, forward_points=None,
                           total_iters=total, **kw.pop("tcfg", {}))
        return train(GeneratorConfig(**GCFG), tcfg, RenderOptions(num_steps=3), loop,
                     disc_kwargs=dict(max_size=16, channels_override=tiny), **kw)

    state = run("a", 2)
    assert state.step == 2
    mgr = CheckpointManager(str(tmp_path / "a" / "ckptdir"))
    assert mgr.load_state("resume")["step"] == 2
    resumed = run("a", 3, resume=True)
    assert resumed.step == 3 and mgr.load_state("resume")["step"] == 3
    assert all(float(s["step"]) == 3.0 for s in resumed.g_opt.state.values())

    run("b", 2, tcfg=dict(gen_lr=1e8, disc_lr=1e8), profile_steps=1)
    names = os.listdir(tmp_path / "b" / "ckptdir")
    assert "D_crupted" in names or "G_crupted" in names
    # the chunked path profiled, with the program's spans and the step's phases in the trace
    with open(tmp_path / "b" / "profile" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "chunk.dispatch" in names and "step.d" in names, sorted(map(str, names))[:40]
    with open(tmp_path / "b" / "profile" / "summary.json") as f:
        summary = json.load(f)
    assert set(summary["phases_ms"]) == {"step.d_gen", "step.d", "step.g", "step.update"}

    # no steps: the finetuned G carries the EMA's NeRF, siren, NeRF mapping and aux head,
    # and its own INR (the EMA has not moved from G's start, G has)
    nerf = run("c", 0, finetune_dir=str(tmp_path / "a" / "ckptdir" / "best_fid"),
               load_nerf_ema=True)
    for mod in ("siren", "mapping_network_nerf", "aux_to_rbg"):
        for p, e in zip(getattr(nerf.generator, mod).parameters(),
                        getattr(nerf.ema, mod).parameters()):
            assert torch.equal(p, e), mod
    assert not all(torch.equal(p, e) for p, e in zip(nerf.generator.inr_net.parameters(),
                                                     nerf.ema.inr_net.parameters()))

    (tmp_path / "sealed").mkdir()
    (tmp_path / "sealed" / "CAMPAIGN_SEALED").write_text("")
    with pytest.raises(RuntimeError, match="sealed"):
        run("sealed/run", 1)


def test_eval_image_dumps(blob_zips, tmp_path):
    """`setup_evaluation` writes the JAX package's real images (resized
    with PIL's Lanczos there, the port's here); `gen_images` and
    `sample_images` write the asked count of PNGs at img_size."""
    from cips3d_tpu.data.zip_dataset import ZipImageDataset as JaxDataset
    from cips3d_tpu.eval.images import setup_evaluation as jax_setup
    from cips3d_tpu_torch.data.zip_dataset import ZipImageDataset
    from cips3d_tpu_torch.eval.images import gen_images, sample_images, setup_evaluation
    from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR
    from test_torch_volume import GCFG

    port, ref = blob_zips
    assert setup_evaluation(ZipImageDataset(port), str(tmp_path / "p"), 5, 8) == 5
    jax_setup(JaxDataset(port, use_native=False), str(tmp_path / "j"), 5, 8)
    for name in sorted(os.listdir(tmp_path / "j")):
        np.testing.assert_array_equal(image_io.read_png(str(tmp_path / "p" / name)),
                                      np.asarray(Image.open(tmp_path / "j" / name)))
    gen = GeneratorNerfINR(GeneratorConfig(**GCFG), generator=torch.Generator().manual_seed(0))
    assert gen_images(gen, str(tmp_path / "fake"), 5, 8, batch_size=2, num_steps=3) == 5
    assert sample_images(gen, str(tmp_path / "s"), 3, 8, batch_size=2, num_steps=3) == 3
    for d, n in (("fake", 5), ("s", 3)):
        files = sorted(os.listdir(tmp_path / d))
        assert len(files) == n
        assert image_io.read_png(str(tmp_path / d / files[0])).shape == (8, 8, 3)
