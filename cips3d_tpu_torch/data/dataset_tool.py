"""Dataset conversion tool: image sources -> StyleGAN-format image zip.
Counterpart of `cips3d_tpu/data/dataset_tool.py`.

Sources are an image folder, an existing zip, a text file listing image
paths, CIFAR-10 / MNIST archives, or an LMDB database (when `lmdb` is
installed); transforms are scale, center-crop, center-crop-wide, and
zero/mirror padding to square, all on PIL's Lanczos; the output is a zip of
PNGs (``img%08d.png``, written as PIL writes them) plus ``dataset.json``
labels.  Images decode with the native library (PNG and baseline JPEG); a
member or file of any other image format raises naming it.

Usage:
  python -m cips3d_tpu_torch.data.dataset_tool --source DIR_OR_FILE --dest out.zip \
      [--resolution 256] [--transform scale|center-crop|center-crop-wide|pad-zero|pad-mirror]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import zipfile
from typing import Iterator, Optional, Tuple

import numpy as np

from cips3d_tpu_torch import native
from cips3d_tpu_torch.utils.image_io import encode_png

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp", ".ppm", ".tif", ".tiff")
DECODED_EXTS = (".png", ".jpg", ".jpeg")


def _decode(data: bytes, name: str) -> np.ndarray:
    if not name.lower().endswith(DECODED_EXTS):
        raise ValueError(f"{name}: the port decodes PNG and JPEG only")
    return native.decode_image(data, name)


def _read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return _decode(f.read(), path)


# --------------------------------------------------------------------- #
# sources: yield (HWC uint8 array, label or None)

def _iter_folder(path: str) -> Iterator[Tuple[np.ndarray, Optional[int]]]:
    files = sorted(os.path.join(root, n) for root, _, names in os.walk(path)
                   for n in names if n.lower().endswith(IMAGE_EXTS))
    for f in files:
        yield _read(f), None


def _iter_zip(path: str) -> Iterator[Tuple[np.ndarray, Optional[int]]]:
    with zipfile.ZipFile(path) as zf:
        labels = {}
        if "dataset.json" in zf.namelist():
            labels = dict(json.loads(zf.read("dataset.json")).get("labels") or [])
        for n in sorted(zf.namelist()):
            if n.lower().endswith(IMAGE_EXTS):
                yield _decode(zf.read(n), n), labels.get(n)


def _iter_image_list(path: str) -> Iterator[Tuple[np.ndarray, Optional[int]]]:
    """Text file with one image path per line (the FFHQ list format);
    relative paths resolve against the file's directory."""
    base = os.path.dirname(path)
    with open(path) as f:
        for line in f:
            p = line.strip().split()[0] if line.strip() else ""
            if p:
                yield _read(p if os.path.isabs(p) else os.path.join(base, p)), None


def _iter_cifar10(path: str) -> Iterator[Tuple[np.ndarray, Optional[int]]]:
    """cifar-10-python.tar.gz batches -> images and labels."""
    import pickle
    import tarfile

    with tarfile.open(path) as tar:
        for name in sorted(tar.getnames()):
            if "data_batch" not in name and "test_batch" not in name:
                continue
            d = pickle.load(tar.extractfile(name), encoding="latin1")
            data = d["data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            for img, label in zip(data, d["labels"]):
                yield np.ascontiguousarray(img, np.uint8), int(label)


def _iter_mnist(path: str) -> Iterator[Tuple[np.ndarray, Optional[int]]]:
    """MNIST idx (train-images-idx3-ubyte.gz, labels beside it)."""
    import gzip

    with gzip.open(path, "rb") as f:
        images = np.frombuffer(f.read(), np.uint8, offset=16).reshape(-1, 28, 28)
    labels_path = path.replace("images-idx3", "labels-idx1")
    labels = None
    if os.path.exists(labels_path):
        with gzip.open(labels_path, "rb") as f:
            labels = np.frombuffer(f.read(), np.uint8, offset=8)
    for i, img in enumerate(images):
        yield np.stack([img] * 3, axis=-1), (int(labels[i]) if labels is not None else None)


def _iter_lmdb(path: str) -> Iterator[Tuple[np.ndarray, Optional[int]]]:
    try:
        import lmdb  # not installed everywhere
    except ImportError as e:
        raise RuntimeError("lmdb is not available in this environment") from e
    with lmdb.open(path, readonly=True, lock=False).begin() as txn:
        for key, value in txn.cursor():
            # values that are neither PNG nor JPEG are skipped, as the JAX tool skips
            # what PIL cannot open; a JPEG flavour the decoder refuses raises
            if value[:8] == b"\x89PNG\r\n\x1a\n" or value[:3] == b"\xff\xd8\xff":
                yield native.decode_image(value, f"{path}:{key!r}"), None


def open_source(source: str):
    if os.path.isdir(source):
        return _iter_folder(source)
    low = source.lower()
    if low.endswith(".zip"):
        return _iter_zip(source)
    if low.endswith(".txt"):
        return _iter_image_list(source)
    if "cifar-10" in low and low.endswith((".tar.gz", ".tgz")):
        return _iter_cifar10(source)
    if "idx3-ubyte" in low:
        return _iter_mnist(source)
    if low.endswith(".mdb") or os.path.exists(os.path.join(source, "data.mdb")):
        return _iter_lmdb(source)
    raise ValueError(f"unrecognized source: {source}")


# --------------------------------------------------------------------- #
# transforms

def _lanczos(img: np.ndarray, width: int, height: int) -> np.ndarray:
    return native.resize(img, width, height, "lanczos")


def center_crop(img: np.ndarray, res: int) -> np.ndarray:
    h, w = img.shape[:2]
    s = min(h, w)
    y0, x0 = (h - s) // 2, (w - s) // 2
    return _lanczos(img[y0: y0 + s, x0: x0 + s], res, res)


def center_crop_wide(img: np.ndarray, res: int) -> np.ndarray:
    """Scale to the width, then crop or zero-pad the height to square."""
    h, w = img.shape[:2]
    if w < res:
        return center_crop(img, res)
    ratio = res / w
    arr = _lanczos(img, res, max(1, round(h * ratio)))
    hh = arr.shape[0]
    if hh > res:
        y0 = (hh - res) // 2
        arr = arr[y0: y0 + res]
    elif hh < res:
        pad = res - hh
        arr = np.pad(arr, ((pad // 2, pad - pad // 2), (0, 0), (0, 0)))
    return arr


def pad_to_square(img: np.ndarray, res: int, mode: str = "constant") -> np.ndarray:
    h, w = img.shape[:2]
    s = max(h, w)
    ph, pw = s - h, s - w
    img = np.pad(img, ((ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2), (0, 0)),
                 mode="reflect" if mode == "mirror" else "constant")
    return _lanczos(img, res, res)


def make_transform(name: Optional[str], resolution: Optional[int]):
    if resolution is None:
        return lambda img: img
    if name in (None, "scale"):
        return lambda img: _lanczos(img, resolution, resolution)
    if name == "center-crop":
        return lambda img: center_crop(img, resolution)
    if name == "center-crop-wide":
        return lambda img: center_crop_wide(img, resolution)
    if name == "pad-zero":
        return lambda img: pad_to_square(img, resolution, "constant")
    if name == "pad-mirror":
        return lambda img: pad_to_square(img, resolution, "mirror")
    raise ValueError(f"unknown transform {name!r}")


# --------------------------------------------------------------------- #

def convert_dataset(source: str, dest: str, resolution: Optional[int] = None,
                    transform: Optional[str] = None, max_images: Optional[int] = None) -> int:
    """Convert ``source`` into a StyleGAN zip at ``dest``; returns the image
    count."""
    tf = make_transform(transform, resolution)
    count = 0
    labels = []
    have_labels = False
    with zipfile.ZipFile(dest, "w", zipfile.ZIP_STORED) as zf:
        for img, label in open_source(source):
            if max_images is not None and count >= max_images:
                break
            name = f"img{count:08d}.png"
            zf.writestr(name, encode_png(tf(img)))
            have_labels |= label is not None
            labels.append([name, int(label) if label is not None else 0])
            count += 1
        if have_labels:
            zf.writestr("dataset.json", json.dumps({"labels": labels}))
    return count


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--source", required=True)
    p.add_argument("--dest", required=True)
    p.add_argument("--resolution", type=int, default=None)
    p.add_argument("--transform", default=None,
                   choices=["scale", "center-crop", "center-crop-wide", "pad-zero", "pad-mirror"])
    p.add_argument("--max-images", type=int, default=None)
    args = p.parse_args(argv)
    n = convert_dataset(args.source, args.dest, args.resolution, args.transform, args.max_images)
    print(f"wrote {n} images to {args.dest}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
