"""Image files without PIL: PNG read and write, PIL's resize filters, and
image grids.

The JAX package reads and writes images through PIL
(`cips3d_tpu/data/zip_dataset.py:30`, `eval/images.py:29`,
`eval/fid.py:27`).  The port does it with numpy, `struct` and `zlib`:

  * `encode_png` / `write_png`: 8-bit grey, grey+alpha, RGB or RGBA, as
    PIL writes them: each row's filter chosen as PIL's encoder chooses it
    (None, Up, Sub, Paeth, tried in that order; the least sum of the bytes
    read as signed wins, ties keep the earlier), the rows deflated at the
    default level with ``Z_FILTERED`` and memory level 9; the IDAT payload
    is PIL's byte for byte (PIL may split it into several chunks);
  * `read_png`: 8-bit grey, grey+alpha, RGB or RGBA, not interlaced, all
    five row filters (None, Sub, Up, Average, Paeth);
  * `to_rgb`: the three colour channels as PIL's ``convert("RGB")`` gives
    them (grey repeated, alpha dropped);
  * `resize_lanczos`, `resize_bilinear`, `resize_nearest`: PIL's
    ``Image.resize`` with ``LANCZOS``, ``BILINEAR`` and ``NEAREST`` on uint8
    images, bit for bit: the same support, the same 22-bit fixed-point
    coefficients and rounding, the horizontal pass first (nearest: PIL's
    affine scale, its source positions summed in double).  These are the
    plain versions of `native.resize`, which the data path calls;
  * `save_image_grid`: a (b, 3, h, w) batch in [-1, 1] tiled into one
    image, written as PNG or, for ``.jpg``, as JPEG (`utils/video.py`).

The native library (`cips3d_tpu_torch/native/`) decodes PNG and JPEG in
C++; `read_png` here is its plain version for PNG.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Optional

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}           # PNG colour type -> channels
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _filter_rows(x: np.ndarray, bpp: int) -> np.ndarray:
    """(h, stride) uint8 rows -> (h, 1 + stride): each row behind the PNG
    filter PIL's encoder picks for it (`ZipEncode.c`: None, then Up, Sub
    and Paeth, kept where the sum of |byte as signed| drops; Average is
    tried only under ``optimize``)."""
    h, stride = x.shape
    cur = x.astype(np.int16)
    up = np.zeros_like(cur)
    up[1:] = cur[:-1]
    left = np.zeros_like(cur)
    left[:, bpp:] = cur[:, :-bpp]
    upleft = np.zeros_like(cur)
    upleft[:, bpp:] = up[:, :-bpp]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    types = (0, 2, 1, 4)
    cands = np.stack([cur, cur - up, cur - left, cur - paeth]).astype(np.uint8)
    signed = cands.astype(np.int32)
    cost = np.minimum(signed, 256 - signed).sum(-1)          # (4, h)
    best = np.zeros(h, np.int64)
    for i in range(1, 4):   # strictly less replaces: ties keep the earlier filter
        best = np.where(cost[i] < cost[best, np.arange(h)], i, best)
    rows = cands[best, np.arange(h)]
    return np.concatenate([np.array(types, np.uint8)[best][:, None], rows], 1)


def encode_png(img: np.ndarray) -> bytes:
    """HW, HW1, HW3 or HW4 uint8 -> PNG bytes, filtered and deflated as PIL
    writes them."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png needs uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"encode_png: {c} channels")
    raw = _filter_rows(img.reshape(h, w * c), c)
    z = zlib.compressobj(zlib.Z_DEFAULT_COMPRESSION, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", z.compress(raw.tobytes()) + z.flush()) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _unfilter(data: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    stride = w * bpp
    if len(data) < h * (stride + 1):
        raise ValueError("PNG: image data is short")
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(h):
        ftype = data[pos]
        line = np.frombuffer(data, np.uint8, stride, pos + 1)
        pos += stride + 1
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:     # Sub: a running sum per channel, mod 256
            cur = np.cumsum(line.reshape(w, bpp).astype(np.uint32), 0).astype(np.uint8).reshape(-1)
        elif ftype == 2:     # Up
            cur = line + prior
        elif ftype in (3, 4):
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:   # Average
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                else:            # Paeth
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                    cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG: unknown filter type {ftype}")
        out[y] = cur
        prior = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> HWC uint8 (C = 1, 2, 3 or 4 as stored)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG: no IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"PNG: only 8-bit, non-interlaced grey/RGB(A) is supported "
                         f"(bit depth {depth}, colour type {ctype}, interlace {interlace})")
    c = _CHANNELS[ctype]
    return _unfilter(zlib.decompress(b"".join(idat)), h, w, c).reshape(h, w, c)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def to_rgb(img: np.ndarray) -> np.ndarray:
    """HWC uint8 of 1-4 channels -> HW3, as PIL's convert("RGB")."""
    c = img.shape[-1]
    if c in (1, 2):
        return np.repeat(img[..., :1], 3, -1)
    return np.ascontiguousarray(img[..., :3])


# ---------------------------------------------------------------- resize

_PRECISION_BITS = 32 - 8 - 2


def _lanczos(x: np.ndarray) -> np.ndarray:
    out = np.sinc(x) * np.sinc(x / 3.0)
    return np.where((x >= -3.0) & (x < 3.0), out, 0.0)


def _bilinear(x: np.ndarray) -> np.ndarray:
    return np.maximum(1.0 - np.abs(x), 0.0)


_FILTERS = {"lanczos": (_lanczos, 3.0), "bilinear": (_bilinear, 1.0)}


def _coefficients(in_size: int, out_size: int, method: str = "lanczos") -> np.ndarray:
    """(out, in) int64 fixed-point weights of PIL's resample
    (`Resample.c` precompute_coeffs, normalize_coeffs_8bpc)."""
    fn, fsupport = _FILTERS[method]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = fsupport * filterscale
    ss = 1.0 / filterscale
    k = np.zeros((out_size, in_size), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        w = fn((np.arange(xmin, xmax) - center + 0.5) * ss)
        ww = np.add.accumulate(w)[-1] if len(w) else 0.0   # summed in order, as PIL sums
        if ww != 0.0:
            w = w / ww
        k[xx, xmin:xmax] = np.where(w < 0, np.trunc(-0.5 + w * (1 << _PRECISION_BITS)),
                                    np.trunc(0.5 + w * (1 << _PRECISION_BITS))).astype(np.int64)
    return k


def _resample(img: np.ndarray, k: np.ndarray, axis: int) -> np.ndarray:
    x = np.moveaxis(img, axis, -1).astype(np.int64)
    acc = x @ k.T + (1 << (_PRECISION_BITS - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, -1, axis)


def _resize_filtered(img: np.ndarray, width: int, height: int, method: str) -> np.ndarray:
    h, w = img.shape[:2]
    out = img
    if width != w:
        out = _resample(out, _coefficients(w, width, method), 1)
    if height != h:
        out = _resample(out, _coefficients(h, height, method), 0)
    return np.ascontiguousarray(out)


def resize_lanczos(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """HWC uint8 -> (height, width, C) uint8, as PIL's Lanczos resize."""
    return _resize_filtered(img, width, height, "lanczos")


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """HWC uint8 -> (height, width, C) uint8, as PIL's bilinear resize."""
    return _resize_filtered(img, width, height, "bilinear")


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """PIL's source index per output position (`Geometry.c`
    ImagingScaleAffine): the position starts at half a step and adds the
    step in double, one output at a time; -1 lies outside."""
    step = in_size / out_size
    pos = np.add.accumulate(np.concatenate([[step * 0.5], np.full(out_size - 1, step)]))
    idx = pos.astype(np.int64)
    return np.where(idx < in_size, idx, -1)


def resize_nearest(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """HWC uint8 -> (height, width, C) uint8, as PIL's nearest resize."""
    h, w = img.shape[:2]
    if (width, height) == (w, h):
        return np.ascontiguousarray(img)
    ys, xs = _nearest_index(h, height), _nearest_index(w, width)
    out = img[np.maximum(ys, 0)][:, np.maximum(xs, 0)]
    out[ys < 0] = 0
    out[:, xs < 0] = 0
    return np.ascontiguousarray(out)


# ---------------------------------------------------------------- grids

def to_uint8(img) -> np.ndarray:
    """(c, h, w) float [-1, 1] -> (h, w, c) uint8."""
    img = np.clip((np.asarray(img, np.float32) + 1.0) * 127.5, 0, 255).astype(np.uint8)
    return img.transpose(1, 2, 0)


def save_image_grid(imgs, path: str, nrow: Optional[int] = None) -> None:
    """(b, 3, h, w) in [-1, 1] -> one image of ``nrow`` per row: JPEG for a
    ``.jpg``/``.jpeg`` path, else PNG."""
    from cips3d_tpu_torch.utils.video import encode_jpeg

    imgs = np.asarray(imgs, np.float32)
    b, c, h, w = imgs.shape
    nrow = nrow or int(math.sqrt(b)) or 1
    ncol = (b + nrow - 1) // nrow
    grid = np.zeros((ncol * h, nrow * w, c), np.uint8)
    for i in range(b):
        r, col = divmod(i, nrow)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = to_uint8(imgs[i])
    data = (encode_jpeg(grid, 90) if path.lower().endswith((".jpg", ".jpeg"))
            else encode_png(grid))
    with open(path, "wb") as f:
        f.write(data)
