"""The training cells' image data: seeded smooth RGB images, written as PNG
members of a StyleGAN-layout zip (``dataset.json`` without labels), which
the program's own zip dataset and loader then read.

The images are low-frequency colour fields (a few seeded cosine waves and
blobs), so PNG's deflate packs them small and a run writes some MB.
"""

from __future__ import annotations

import json
import os
import struct
import zipfile
import zlib

import numpy as np


def _png(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (8-bit RGB, filter 0 on every row)."""
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], 1).tobytes()

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def images(seed: int, num: int, size: int) -> np.ndarray:
    """``num`` distinct (size, size, 3) uint8 images from ``seed``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, size, dtype=np.float32),
                         np.linspace(0, 1, size, dtype=np.float32), indexing="ij")
    out = np.empty((num, size, size, 3), np.uint8)
    for i in range(num):
        img = np.zeros((size, size, 3), np.float32) + rng.uniform(0.2, 0.8, 3).astype(np.float32)
        for _ in range(3):
            f = rng.uniform(0.5, 4.0, 2).astype(np.float32)
            ph = rng.uniform(0, 2 * np.pi)
            amp = rng.uniform(-0.25, 0.25, 3).astype(np.float32)
            img += np.cos(2 * np.pi * (f[0] * xx + f[1] * yy) + ph)[..., None] * amp
        for _ in range(2):
            c = rng.uniform(0.2, 0.8, 2).astype(np.float32)
            r = np.float32(rng.uniform(0.05, 0.25))
            d2 = (xx - c[0]) ** 2 + (yy - c[1]) ** 2
            img += np.exp(-d2 / (2 * r * r))[..., None] * rng.uniform(-0.5, 0.5, 3).astype(np.float32)
        out[i] = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    return out


def write_zip(path: str, seed: int, num: int, size: int) -> str:
    """Write the zip of ``num`` images of ``size`` from ``seed``; returns ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        for i, img in enumerate(images(seed, num, size)):
            zf.writestr(f"{i // 1000:05d}/img{i:08d}.png", _png(img))
        zf.writestr("dataset.json", json.dumps({"labels": None}))
    return path

