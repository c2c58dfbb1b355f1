"""The port's data tools against the JAX package and PIL (which the JAX
package reads and writes images with): the native library's PNG and JPEG
decode and its zip reader, `encode_png` and the resize filters, the
dataset tool, the named datasets, `ZipImageDataset` native and plain,
`read_mjpeg_avi`, `plot_logs` and the shape-debug traces; and the native
build (two processes at once; a failed build raises).

Tolerances: PNG, resize, dataset members, named-dataset items and loader
batches exact; JPEG exact against PIL (libjpeg-turbo's defaults: the islow
IDCT, fancy upsampling, its fixed-point colour conversion).  The library is
built with g++ from the repo's source; a test fails, not skips, if it
cannot be built.

    python tests/test_torch_data.py     # rewrites the JPEG fixtures with PIL
"""

import gzip
import io
import json
import os
import pickle
import re
import subprocess
import sys
import tarfile
import zipfile
import zlib

import numpy as np
import pytest
import torch._dynamo  # noqa: F401  (see the note below)
from PIL import Image

from cips3d_tpu.data import dataset_tool as jax_tool
from cips3d_tpu.data import named_datasets as jax_named
from cips3d_tpu.data.zip_dataset import DataLoader as JaxLoader
from cips3d_tpu.data.zip_dataset import ZipImageDataset as JaxDataset
from cips3d_tpu_torch import native
from cips3d_tpu_torch.data import dataset_tool, named_datasets
from cips3d_tpu_torch.data.zip_dataset import DataLoader, ZipImageDataset
from cips3d_tpu_torch.utils import image_io, video

# Note: a process's first torch optimizer imports torch._dynamo, and that import
# scans sys.modules with `inspect`.  tests/tl2_stub.py (the reference-parity files'
# stub) leaves modules there that answer every attribute, ``__file__`` too, with a
# function, and the scan then raises in whichever later test of that worker builds
# the first optimizer.  Every worker collects every test file before it runs any
# test, so the import above, made while this file is collected, keeps all of them
# clear of it.
#
# Likewise for the cores: each torch process sizes its OpenMP pool to all of them, so
# n workers run n threads a core, and the port's tests, many small ops each, then spend
# about half their time waiting on one another's threads.  Under pytest-xdist every
# worker, and every process its tests start, gets an even share of the cores, at least
# two, when this file is collected.
_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _WORKERS:
    _THREADS = max(2, (os.cpu_count() or 2) // _WORKERS)
    torch.set_num_threads(_THREADS)
    os.environ.setdefault("OMP_NUM_THREADS", str(_THREADS))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "cips3d_tpu_torch", "native", "fixtures")
# (name, size (h, w), grey, PIL save options): the JPEG flavours the card's build is held to
FIXTURE_SPECS = [
    ("yuv420_q90", (40, 48), False, dict(quality=90, subsampling=2)),
    ("yuv422_q75", (29, 37), False, dict(quality=75, subsampling=1)),
    ("yuv444_q95", (24, 24), False, dict(quality=95, subsampling=0)),
    ("grey_q85", (45, 33), True, dict(quality=85)),
    ("yuv420_restart3", (56, 40), False, dict(quality=80, subsampling=2,
                                              restart_marker_blocks=3)),
]


def photo(seed, h, w, c=3):
    """A smooth, noisy image: PIL's PNG encoder picks a mix of row filters
    for it, and its JPEG has AC energy in every block."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    phase = rng.uniform(0, 6, 3)
    base = np.stack([128 + 100 * np.sin(xx / 7 + yy / 11 + phase[0]),
                     128 + 90 * np.cos(yy / 5 + phase[1]),
                     128 + 80 * np.sin((xx - yy) / 9 + phase[2]),
                     128 + 60 * np.cos(xx / 3)], -1)[..., :c]
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)


def pil_bytes(img, fmt, **kw):
    buf = io.BytesIO()
    Image.fromarray(img[..., 0] if img.ndim == 3 and img.shape[-1] == 1 else img).save(
        buf, format=fmt, **kw)
    return buf.getvalue()


def pil_rgb(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def forced_png(img, ftype):
    """PNG bytes with filter ``ftype`` on every row."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int32)
    up = np.vstack([np.zeros((1, w * c), np.int32), x[:-1]])
    left = np.hstack([np.zeros((h, c), np.int32), x[:, :-c]])
    ul = np.hstack([np.zeros((h, c), np.int32), up[:, :-c]])
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
    pred = [0, left, up, (left + up) >> 1, paeth][ftype]
    raw = np.concatenate([np.full((h, 1), ftype), (x - pred) & 255], 1).astype(np.uint8)
    ihdr = np.array([w, h], ">u4").tobytes() + bytes([8, image_io._COLOR_TYPE[c], 0, 0, 0])
    return (image_io.PNG_SIGNATURE + image_io._chunk(b"IHDR", ihdr)
            + image_io._chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + image_io._chunk(b"IEND", b""))


def idat_payload(data):
    pos, out = 8, b""
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        if data[pos + 4:pos + 8] == b"IDAT":
            out += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    return out


def zip_pixels(path):
    """{member: PIL's RGB pixels} of an image zip, and its dataset.json."""
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        meta = json.loads(zf.read("dataset.json")) if "dataset.json" in names else None
        return {n: pil_rgb(zf.read(n)) for n in names if n != "dataset.json"}, meta


# ---------------------------------------------------------------- PNG

@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "average", "paeth"])
def test_native_png_forced_filters(ftype, channels):
    img = photo(ftype * 4 + channels, 13, 17, channels)
    data = forced_png(img, ftype)
    want = pil_rgb(data)
    np.testing.assert_array_equal(native.decode_image(data), want)
    np.testing.assert_array_equal(image_io.to_rgb(image_io.decode_png(data)), want)


@pytest.fixture(scope="module")
def jax_reader(tmp_path_factory):
    """The JAX package's native reader, built from its own source into a
    directory of this test (its shared path is not touched)."""
    import cips3d_tpu.native as jn

    d = tmp_path_factory.mktemp("jax_native")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jn, "_SO", str(d / "libzipreader.so"))
        mp.setattr(jn, "_LIB", None)
        mp.setattr(jn, "_LIB_FAILED", False)
        assert jn.get_lib() is not None, "the JAX package's zipreader.cpp did not build"
        yield jn.NativeZipReader


@pytest.mark.parametrize("method", [zipfile.ZIP_STORED, zipfile.ZIP_DEFLATED],
                         ids=["stored", "deflated"])
def test_native_zip_members_match_plain_and_jax_reader(method, jax_reader, tmp_path):
    members = {}
    for ftype in range(5):
        for c in (1, 2, 3, 4):
            members[f"forced_{ftype}_{c}.png"] = forced_png(photo(ftype + 10 * c, 9, 14, c), ftype)
    for c in (1, 3, 4):
        members[f"pil_{c}.png"] = pil_bytes(photo(50 + c, 21, 18, c), "PNG")
    pal = Image.fromarray(photo(60, 12, 10)).convert("P", palette=Image.ADAPTIVE, colors=200)
    buf = io.BytesIO()
    pal.save(buf, format="PNG")
    members["palette.png"] = buf.getvalue()
    path = str(tmp_path / "m.zip")
    with zipfile.ZipFile(path, "w", method) as zf:
        for n, d in members.items():
            zf.writestr(n, d)
    port, ref = native.NativeZipReader(path), jax_reader(path)
    assert port.names == ref.names == list(members)
    for i, (n, d) in enumerate(members.items()):
        assert port.read_raw(i) == d
        got = port.read_image(i)
        np.testing.assert_array_equal(got, ref.read_image(i), err_msg=n)
        np.testing.assert_array_equal(got, pil_rgb(d), err_msg=n)
        np.testing.assert_array_equal(got, native.decode_image(port.read_raw(i)), err_msg=n)
        if n != "palette.png":   # the plain decoder reads no palette PNGs
            np.testing.assert_array_equal(got, image_io.to_rgb(image_io.decode_png(d)))
    port.close()
    ref.close()


@pytest.mark.parametrize("shape", [(64, 64, 3), (37, 53, 3), (20, 30, 1), (20, 30, 2),
                                   (50, 70, 4), (256, 96, 3), (1, 1, 3), (3, 1, 1)])
@pytest.mark.parametrize("kind", ["photo", "noise", "flat"])
def test_encode_png_writes_as_pil(shape, kind):
    rng = np.random.default_rng(sum(shape))
    if kind == "photo":
        img = photo(sum(shape), *shape)
    elif kind == "noise":
        img = rng.integers(0, 256, shape, dtype=np.uint8)
    else:
        img = (rng.integers(0, 3, shape) * 60).astype(np.uint8)
    mine, pil = image_io.encode_png(img), pil_bytes(img, "PNG")
    assert zlib.decompress(idat_payload(mine)) == zlib.decompress(idat_payload(pil))  # filters
    assert idat_payload(mine) == idat_payload(pil)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(mine))).reshape(shape), img)


# ---------------------------------------------------------------- JPEG

JPEG_CASES = {f"{h}x{w}-sub{sub}-q{q}": ((h, w), False, dict(quality=q, subsampling=sub))
              for (h, w) in ((37, 53), (64, 48)) for sub in (0, 1, 2) for q in (50, 95)}
JPEG_CASES.update({
    "grey-37x53": ((37, 53), True, dict(quality=75)),
    "grey-64x64-q95": ((64, 64), True, dict(quality=95)),
    "restart-blocks": ((40, 56), False, dict(quality=80, restart_marker_blocks=2)),
    "restart-rows-420": ((53, 37), False, dict(quality=80, subsampling=2, restart_marker_rows=1)),
    "optimized-tables": ((48, 48), False, dict(quality=90, optimize=True)),
    "1x1": ((1, 1), False, dict(quality=90)),
    "narrow-3x2-420": ((3, 2), False, dict(quality=90, subsampling=2)),
    "celeba-218x178": ((218, 178), False, dict(quality=90)),
})


@pytest.mark.parametrize("case", list(JPEG_CASES))
def test_jpeg_matches_pil(case):
    (h, w), grey, kw = JPEG_CASES[case]
    img = photo(len(case), h, w)
    data = pil_bytes(img[..., :1] if grey else img, "JPEG", **kw)
    np.testing.assert_array_equal(native.decode_image(data), pil_rgb(data))


@pytest.mark.parametrize("fmt", ["JPEG", "PNG"])
def test_truncated_and_corrupt_files_raise_or_decode(fmt):
    """Cut files raise; files with flipped bytes raise or decode to the
    header's size, never crash."""
    data = pil_bytes(photo(8, 40, 36), fmt, **({"quality": 90} if fmt == "JPEG" else {}))
    for cut in (len(data) // 3, len(data) // 2, len(data) - 40):
        with pytest.raises(ValueError, match="truncated|inflate|no frame"):
            native.decode_image(data[:cut])
    rng = np.random.default_rng(9)
    for _ in range(200):
        bad = bytearray(data)
        for pos in rng.integers(2, len(bad), 4):
            bad[pos] = int(rng.integers(0, 256))
        try:
            assert native.decode_image(bytes(bad)).shape[2] == 3
        except ValueError:
            pass


def test_jpeg_of_the_ports_encoder_matches_pil():
    data = video.encode_jpeg(photo(7, 45, 61), 85)
    np.testing.assert_array_equal(native.decode_image(data), pil_rgb(data))


@pytest.mark.parametrize("flavour,match", [("progressive", "SOF2, progressive"),
                                           ("cmyk", "4 components.*CMYK"),
                                           ("gif", "neither a PNG nor a JPEG")])
def test_other_flavours_raise_naming_the_file(flavour, match):
    img = photo(3, 16, 16)
    if flavour == "progressive":
        data = pil_bytes(img, "JPEG", progressive=True)
    elif flavour == "cmyk":
        buf = io.BytesIO()
        Image.fromarray(img).convert("CMYK").save(buf, format="JPEG")
        data = buf.getvalue()
    else:
        data = pil_bytes(img, "GIF")
    with pytest.raises(ValueError, match=f"faces/{flavour}.jpg: .*{match}"):
        native.decode_image(data, f"faces/{flavour}.jpg")


@pytest.mark.parametrize("name", [s[0] for s in FIXTURE_SPECS])
def test_jpeg_fixtures_are_pils(name):
    """The fixtures `chip_smoke.py` decodes on the card: PIL's pixels."""
    with open(os.path.join(FIXTURES, f"{name}.jpg"), "rb") as f:
        data = f.read()
    want = np.load(os.path.join(FIXTURES, f"{name}.npy"))
    np.testing.assert_array_equal(pil_rgb(data), want)
    np.testing.assert_array_equal(native.decode_image(data), want)


def test_read_mjpeg_avi_decodes_the_frames_as_jax(tmp_path):
    from cips3d_tpu.utils.video import read_mjpeg_avi as jax_read

    frames = [photo(i, 24, 40) for i in range(3)]
    path = video.write_mjpeg_avi(frames, str(tmp_path / "v.avi"))
    got, ref = video.read_mjpeg_avi(path), jax_read(path)
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- resize

RESIZE_SIZES = [((256, 256), (64, 64)), ((37, 53), (20, 31)), ((16, 16), (64, 48)),
                ((50, 40), (50, 13)), ((218, 178), (320, 262)), ((7, 5), (7, 5))]


@pytest.mark.parametrize("src,dst", RESIZE_SIZES)
@pytest.mark.parametrize("method", ["lanczos", "bilinear", "nearest"])
def test_resize_matches_pil(method, src, dst):
    img = np.random.default_rng(src[0]).integers(0, 256, src + (3,), dtype=np.uint8)
    pil_filter = {"lanczos": Image.LANCZOS, "bilinear": Image.BILINEAR,
                  "nearest": Image.NEAREST}[method]
    ref = np.asarray(Image.fromarray(img).resize((dst[1], dst[0]), pil_filter))
    np.testing.assert_array_equal(getattr(image_io, f"resize_{method}")(img, dst[1], dst[0]), ref)
    np.testing.assert_array_equal(native.resize(img, dst[1], dst[0], method), ref)


# ---------------------------------------------------------------- dataset tool

@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """One source of each kind this sandbox can make."""
    d = tmp_path_factory.mktemp("sources")
    folder = d / "folder"
    (folder / "sub").mkdir(parents=True)
    files = []
    for i, (h, w, c) in enumerate([(30, 40, 3), (50, 25, 3), (33, 33, 1), (24, 36, 4)]):
        p = folder / ("sub" if i % 2 else "") / f"p{i}.png"
        p.write_bytes(pil_bytes(photo(i, h, w, c), "PNG"))
        files.append(p)
    for i, (h, w, sub) in enumerate([(40, 30, 2), (29, 45, 1), (32, 32, 0)]):
        p = folder / f"j{i}.jpg"
        p.write_bytes(pil_bytes(photo(10 + i, h, w), "JPEG", quality=90, subsampling=sub))
        files.append(p)
    zpath = d / "src.zip"
    with zipfile.ZipFile(zpath, "w") as zf:
        for i, p in enumerate(files):
            zf.writestr(f"m{i}{p.suffix}", p.read_bytes())
        zf.writestr("dataset.json", json.dumps(
            {"labels": [[f"m{i}{p.suffix}", i % 3] for i, p in enumerate(files)]}))
    lst = d / "list.txt"
    lst.write_text("\n".join([os.path.relpath(p, d) for p in files[1:]] + [str(files[0]), ""]))
    rng = np.random.default_rng(5)
    cifar = d / "cifar-10-python.tar.gz"
    with tarfile.open(cifar, "w:gz") as tar:
        for name in ("cifar-10-batches-py/data_batch_1", "cifar-10-batches-py/test_batch"):
            blob = pickle.dumps({"data": rng.integers(0, 256, (3, 3072), dtype=np.uint8),
                                 "labels": [int(v) for v in rng.integers(0, 10, 3)]})
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))
    mnist = d / "train-images-idx3-ubyte.gz"
    with gzip.open(mnist, "wb") as f:
        f.write(b"\0" * 16 + rng.integers(0, 256, (4, 28, 28), dtype=np.uint8).tobytes())
    with gzip.open(d / "train-labels-idx1-ubyte.gz", "wb") as f:
        f.write(b"\0" * 8 + bytes([3, 1, 4, 1]))
    return {"folder": str(folder), "zip": str(zpath), "list": str(lst), "cifar10": str(cifar),
            "mnist": str(mnist)}


@pytest.mark.parametrize("transform", [None, "scale", "center-crop", "center-crop-wide",
                                       "pad-zero", "pad-mirror"])
@pytest.mark.parametrize("source", ["folder", "zip", "list", "cifar10", "mnist"])
def test_dataset_tool_matches_jax(source, transform, sources, tmp_path):
    res = None if transform is None else 24
    src = sources[source]
    n = dataset_tool.convert_dataset(src, str(tmp_path / "p.zip"), res, transform)
    assert n == jax_tool.convert_dataset(src, str(tmp_path / "j.zip"), res, transform)
    got, got_meta = zip_pixels(tmp_path / "p.zip")
    ref, ref_meta = zip_pixels(tmp_path / "j.zip")
    assert list(got) == list(ref) == [f"img{i:08d}.png" for i in range(n)]
    assert got_meta == ref_meta
    for name in ref:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)


def test_dataset_tool_cli_exits_0(sources, tmp_path):
    dest = str(tmp_path / "out.zip")
    p = subprocess.run([sys.executable, "-m", "cips3d_tpu_torch.data.dataset_tool", "--source",
                        sources["folder"], "--dest", dest, "--resolution", "16", "--transform",
                        "center-crop", "--max-images", "5"],
                       capture_output=True, text=True, cwd=ROOT, timeout=300,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert p.returncode == 0, p.stderr
    assert f"wrote 5 images to {dest}" in p.stdout
    pixels, meta = zip_pixels(dest)
    assert len(pixels) == 5 and meta is None
    assert {a.shape for a in pixels.values()} == {(16, 16, 3)}


def test_dataset_tool_refuses_other_formats(tmp_path):
    (tmp_path / "a.png").write_bytes(pil_bytes(photo(1, 8, 8), "PNG"))
    (tmp_path / "b.bmp").write_bytes(pil_bytes(photo(2, 8, 8), "BMP"))
    with pytest.raises(ValueError, match="b.bmp: the port decodes PNG and JPEG only"):
        dataset_tool.convert_dataset(str(tmp_path), str(tmp_path / "o.zip"))


# ---------------------------------------------------------------- datasets and loaders

@pytest.fixture(scope="module")
def named_sources(tmp_path_factory):
    d = tmp_path_factory.mktemp("named")
    celeba, cats, carla = d / "celeba", d / "cats", d / "carla"
    for sub in (celeba, cats, carla):
        sub.mkdir()
    for i in range(3):
        (celeba / f"{i:06d}.jpg").write_bytes(pil_bytes(photo(i, 218, 178), "JPEG", quality=90))
        (cats / f"c{i}.jpg").write_bytes(pil_bytes(photo(5 + i, 40 + i, 36), "JPEG",
                                                   quality=85, subsampling=1))
        (carla / f"r{i}.png").write_bytes(pil_bytes(photo(9 + i, 30, 30 + 2 * i), "PNG"))
    (cats / "not_a_cat.png").write_bytes(pil_bytes(photo(20, 8, 8), "PNG"))
    (d / "celeba.txt").write_text("\n".join(f"celeba/{i:06d}.jpg" for i in range(3)))
    (d / "ffhq.txt").write_text("\n".join(["carla/r0.png", "cats/c1.jpg", "celeba/000002.jpg"]))
    return {"FFHQ": dict(image_list_file=str(d / "ffhq.txt")),
            "CelebA": dict(image_list_file=str(d / "celeba.txt")),
            "Cats": dict(source=str(cats)), "Carla": dict(source=str(carla))}


@pytest.mark.parametrize("name", ["FFHQ", "CelebA", "Cats", "Carla"])
def test_named_datasets_match_jax(name, named_sources):
    port = named_datasets.get_dataset(name, 16, **named_sources[name])
    ref = jax_named.get_dataset(name, 16, **named_sources[name])
    assert len(port) == len(ref) == 3 * (1 if name == "Carla" else 2)
    assert port.resolution == ref.resolution == 16
    for i in range(len(ref)):
        a, b = port[i], ref[i]
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1] == 0
    la = DataLoader(port, batch_size=2, seed=3, num_workers=2)
    lb = JaxLoader(ref, batch_size=2, seed=3, num_workers=2)
    try:
        for _ in range(4):
            np.testing.assert_array_equal(next(la)[0], next(lb)[0])
    finally:
        la.close()
        lb.close()


@pytest.fixture(scope="module")
def mixed_zip(tmp_path_factory):
    """A zip of PIL-written PNG and JPEG members."""
    path = str(tmp_path_factory.mktemp("mixed") / "mixed.zip")
    with zipfile.ZipFile(path, "w") as zf:
        for i in range(6):
            img = photo(30 + i, 20, 20, (3, 1, 4)[i % 3])
            zf.writestr(f"img{i:08d}.png", pil_bytes(img, "PNG"))
        for i in range(6, 10):
            zf.writestr(f"img{i:08d}.jpg", pil_bytes(photo(30 + i, 20, 20), "JPEG",
                                                     quality=80, subsampling=i % 3))
    return path


@pytest.mark.parametrize("resize,xflip", [(None, False), (8, True), (32, False)])
def test_zip_dataset_native_plain_and_jax(mixed_zip, resize, xflip):
    nat = ZipImageDataset(mixed_zip, resize_resolution=resize, xflip=xflip)
    plain = ZipImageDataset(mixed_zip, resize_resolution=resize, xflip=xflip, use_native=False)
    ref = JaxDataset(mixed_zip, resize_resolution=resize, xflip=xflip, use_native=False)
    assert len(nat) == len(plain) == len(ref) == 10 * (2 if xflip else 1)
    for i in range(len(ref)):
        np.testing.assert_array_equal(nat[i][0], ref[i][0])
        if nat._names[i % 10].endswith(".png"):
            np.testing.assert_array_equal(plain[i][0], ref[i][0])
        else:
            with pytest.raises(ValueError, match="decodes PNG members only"):
                plain[i]
    la = DataLoader(nat, batch_size=4, seed=7, num_workers=4)
    lb = JaxLoader(ref, batch_size=4, seed=7, num_workers=1)
    try:
        for _ in range(3):
            np.testing.assert_array_equal(next(la)[0], next(lb)[0])
    finally:
        la.close()
        lb.close()


def test_one_reader_shared_by_more_threads_than_cores(mixed_zip):
    """The reader's lock covers only the seek and read: 32 threads decoding
    the members of one reader at once get every image right."""
    from concurrent.futures import ThreadPoolExecutor

    reader = native.NativeZipReader(mixed_zip)
    with zipfile.ZipFile(mixed_zip) as zf:
        want = [pil_rgb(zf.read(n)) for n in reader.names]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(32) as pool:
            idx = [i % len(want) for i in range(640)]
            got = list(pool.map(reader.read_image, idx, timeout=120))
    finally:
        sys.setswitchinterval(interval)
    for i, g in zip(idx, got):
        np.testing.assert_array_equal(g, want[i])
    reader.close()


def test_zip_dataset_raises_on_a_member_it_cannot_decode(tmp_path):
    path = str(tmp_path / "bad.zip")
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("a.png", pil_bytes(photo(1, 8, 8), "PNG"))
        zf.writestr("b.jpg", pil_bytes(photo(2, 8, 8), "JPEG", progressive=True))
    ds = ZipImageDataset(path)
    assert ds[0][0].shape == (3, 8, 8)
    with pytest.raises(ValueError, match="b.jpg: JPEG: SOF2, progressive"):
        ds[1]


# ---------------------------------------------------------------- plot_logs, debug shapes

def test_plot_logs_counts_as_jax_and_draws(tmp_path):
    from cips3d_tpu.utils.textlogger import plot_logs as jax_plot
    from cips3d_tpu_torch.utils.textlogger import TextLogger, plot_logs

    logger = TextLogger(str(tmp_path / "t"))
    for step in range(20):
        logger.log_dict({"d_loss": {"d_loss": 1.0 / (step + 1)}, "g_loss": {"g_loss": step % 5}},
                        "train", step)
        if step % 5 == 0:
            logger.log_scalar("eval.FID_surrogate.FID_surrogate", step, 100 - step)
    logger.close()
    for pattern in ("", "loss", "FID"):
        n = plot_logs(str(tmp_path / "t"), str(tmp_path / f"p{pattern}.png"), pattern)
        assert n == jax_plot(str(tmp_path / "t"), str(tmp_path / f"j{pattern}.png"), pattern) > 0
        img = native.read_image(str(tmp_path / f"p{pattern}.png"))
        np.testing.assert_array_equal(img, pil_rgb((tmp_path / f"p{pattern}.png").read_bytes()))
        colours = {tuple(c) for c in img.reshape(-1, 3)}
        drawn = colours - {(255, 255, 255), (0, 0, 0)}
        assert len(drawn) == n, (pattern, drawn)
    assert plot_logs(str(tmp_path / "t"), str(tmp_path / "none.png"), "nothing") == 0
    assert jax_plot(str(tmp_path / "t"), str(tmp_path / "jnone.png"), "nothing") == 0
    assert not (tmp_path / "none.png").exists()


def _shape_lines(text):
    return [re.sub(r"torch\.", "", line) for line in text.splitlines()
            if line.startswith("[shape]")]


def test_debug_shapes_prints_the_jax_trace_lines(capsys):
    import jax
    import jax.numpy as jnp
    import torch

    from cips3d_tpu.models.discriminator import DiscriminatorMultiScaleAux as JaxD
    from cips3d_tpu.models.generator import GeneratorConfig as JaxConfig
    from cips3d_tpu.models.generator import GeneratorNerfINR as JaxG
    from cips3d_tpu.models.generator import RenderOptions as JaxOptions
    from cips3d_tpu.models.generator import sample_zs as jax_sample_zs
    from cips3d_tpu.utils import debug as jax_debug
    from cips3d_tpu_torch.models.discriminator import DiscriminatorMultiScaleAux
    from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR, RenderOptions
    from cips3d_tpu_torch.utils import debug

    gcfg = dict(z_dim_nerf=16, z_dim_inr=32, nerf_hidden_dim=16, nerf_style_dim=16,
                nerf_mapping_layers=2, inr_hidden_dim=32, inr_style_dim=32, inr_mapping_layers=2)
    opts = dict(img_size=4, num_steps=3)
    tiny = {r: 16 for r in (4, 8, 16, 32, 64, 128, 256, 512, 1024)}
    jgen, jcfg = JaxG(cfg=JaxConfig(**gcfg)), JaxConfig(**gcfg)
    zs = jax_sample_zs(jax.random.PRNGKey(0), 2, jcfg)
    params = jgen.init(jax.random.PRNGKey(1), zs, jax.random.PRNGKey(2), JaxOptions(**opts))
    jd = JaxD(max_size=16, channels_override=tiny)
    dparams = jd.init(jax.random.PRNGKey(3), jnp.zeros((2, 3, 8, 8)), method=jd.init_all)
    capsys.readouterr()
    with jax_debug.shape_debug():
        jgen.apply(params, zs, jax.random.PRNGKey(4), JaxOptions(**opts), return_aux_img=True)
        jd.apply(dparams, jnp.zeros((2, 3, 8, 8)), 1.0, fade_in=False)
    ref = _shape_lines(capsys.readouterr().out)
    gen = GeneratorNerfINR(GeneratorConfig(**gcfg), generator=torch.Generator().manual_seed(0))
    disc = DiscriminatorMultiScaleAux(max_size=16, channels_override=tiny,
                                      generator=torch.Generator().manual_seed(1))
    zt = {k: torch.from_numpy(np.array(v)) for k, v in zs.items()}
    assert not debug.enabled()
    with torch.no_grad(), debug.shape_debug():
        gen(zt, RenderOptions(**opts), generator=torch.Generator().manual_seed(2),
            return_aux_img=True)
        disc(torch.zeros((2, 3, 8, 8)), 1.0, fade_in=False)
    assert not debug.enabled()
    got = _shape_lines(capsys.readouterr().out)
    names = [line.split(":")[0] for line in ref]
    assert names == ["[shape] mapping", "[shape] points_forward.in",
                     "[shape] points_forward.coarse", "[shape] points_forward.pixels_fea",
                     "[shape] points_forward.inr_img", "[shape] disc.in", "[shape] disc.block_8",
                     "[shape] disc.logits"]
    assert got == ref


def test_debug_shapes_from_the_training_cli(tmp_path, capsys, monkeypatch):
    from test_torch_loop import TINY_OPTS

    from cips3d_tpu_torch.data.synthetic import make_blob_dataset
    from cips3d_tpu_torch.train import cli
    from cips3d_tpu_torch.utils import debug

    monkeypatch.chdir(tmp_path)
    make_blob_dataset("d.zip", 8, img_size=8, seed=0)
    try:
        assert cli.main(["--config", os.path.join(ROOT, "configs", "ffhq.yaml"), "--command",
                         "train_r32", "--debug", "--device", "cpu", "--opts", *TINY_OPTS,
                         "img_size", "8", "data_path", "d.zip", "debug_shapes", "true"]) == 0
    finally:
        debug.enable(False)
    names = {line.split(":")[0] for line in _shape_lines(capsys.readouterr().out)}
    assert {"[shape] mapping", "[shape] points_forward.pixels_fea", "[shape] disc.in",
            "[shape] disc.logits"} <= names


# ---------------------------------------------------------------- the native build

_PROBE = """
import sys
from pathlib import Path
import cips3d_tpu_torch.native as n
n.BUILD_DIR = Path(sys.argv[1])
img = n.decode_image(open(sys.argv[2], "rb").read())
print(n.build().name, img.shape, int(img.astype(int).sum()))
"""


def test_two_processes_build_at_once_and_both_decode(tmp_path):
    img = photo(4, 30, 20)
    (tmp_path / "x.jpg").write_bytes(pil_bytes(img, "JPEG", quality=90, subsampling=2))
    build_dir = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _PROBE, str(build_dir),
                               str(tmp_path / "x.jpg")], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1] for o in outs]
    want = pil_rgb((tmp_path / "x.jpg").read_bytes())
    line = f"{native.build().name} {want.shape} {int(want.astype(int).sum())}"
    assert [o[0].strip() for o in outs] == [line, line]
    assert sorted(os.listdir(build_dir)) == [native.build().name]   # no temporary left


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    broken = tmp_path / "zipreader.cpp"
    broken.write_text(native.SRC.read_text() + "\nthis is not C++;\n")
    monkeypatch.setattr(native, "SRC", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match=r"building zipreader.cpp failed:(.|\n)*error"):
        native.build()
    assert os.listdir(tmp_path / "build") == []


def _write_fixtures():
    """Write the JPEG fixtures (PIL's encoder) and PIL's decode of each."""
    os.makedirs(FIXTURES, exist_ok=True)
    for i, (name, (h, w), grey, kw) in enumerate(FIXTURE_SPECS):
        img = photo(100 + i, h, w)
        data = pil_bytes(img[..., :1] if grey else img, "JPEG", **kw)
        with open(os.path.join(FIXTURES, f"{name}.jpg"), "wb") as f:
            f.write(data)
        np.save(os.path.join(FIXTURES, f"{name}.npy"), pil_rgb(data))


if __name__ == "__main__":
    _write_fixtures()
