"""Image conversion: counterpart of `cips3d_tpu/eval/images.py::to_uint8`."""

from __future__ import annotations

import numpy as np


def to_uint8(img) -> np.ndarray:
    """(c, h, w) float [-1, 1] → (h, w, c) uint8."""
    img = np.clip((np.asarray(img, np.float32) + 1.0) * 127.5, 0, 255).astype(np.uint8)
    return img.transpose(1, 2, 0)
