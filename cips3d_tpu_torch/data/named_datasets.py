"""Named pi-GAN datasets (FFHQ, CelebA, Cats, Carla): counterpart of
`cips3d_tpu/data/named_datasets.py`.

``__getitem__`` returns ``(CHW uint8, label)`` as `zip_dataset.py` does, so
each plugs into `zip_dataset.DataLoader`; the horizontal flip is xflip
doubling (index >= len(files) is the mirrored copy).  Images decode and
resize through the native library, as PIL decodes and resizes them for the
JAX classes:
  * FFHQ: image-list file; bilinear resize to img_size; flip on by default.
  * CelebA: image-list file; shorter side to 320 (bilinear), centre crop
    256, nearest resize to img_size; flip.
  * Cats: folder or glob of ``*.jpg``; nearest resize; flip.
  * Carla: folder or glob of ``*.png``; nearest resize; no flip.
"""

from __future__ import annotations

import glob as globlib
import os
from typing import List, Tuple

import numpy as np

from cips3d_tpu_torch import native


def read_image_list(path: str) -> List[str]:
    """One image path per line; relative paths resolve against the file's
    directory."""
    base = os.path.dirname(path)
    out = []
    with open(path) as f:
        for line in f:
            p = line.strip().split()[0] if line.strip() else ""
            if p:
                out.append(p if os.path.isabs(p) else os.path.join(base, p))
    return out


def _resize(arr: np.ndarray, size: Tuple[int, int], method: str) -> np.ndarray:
    """``size`` is (height, width)."""
    return native.resize(arr, size[1], size[0], method)


def _resize_shorter(arr: np.ndarray, target: int) -> np.ndarray:
    """torchvision's Resize(int): the shorter side to ``target``, the aspect kept."""
    h, w = arr.shape[:2]
    if h <= w:
        size = (target, max(1, round(w * target / h)))
    else:
        size = (max(1, round(h * target / w)), target)
    return _resize(arr, size, "bilinear")


def _center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    top, left = (h - size) // 2, (w - size) // 2
    return arr[top: top + size, left: left + size]


class _FileListDataset:
    """A file list and a per-image transform; xflip doubling for the flip."""

    def __init__(self, files: List[str], img_size: int, hflip: bool):
        if not files:
            raise FileNotFoundError(
                "Can't find data; make sure you specify the path to your dataset")
        self.files = files
        self.img_size = img_size
        self.hflip = hflip

    def __len__(self) -> int:
        return len(self.files) * (2 if self.hflip else 1)

    def _transform(self, arr: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        base = len(self.files)
        arr = self._transform(native.read_image(self.files[idx % base]))
        if self.hflip and idx >= base:
            arr = arr[:, ::-1]
        return arr.transpose(2, 0, 1), 0

    @property
    def resolution(self) -> int:
        return self.img_size


class FFHQ(_FileListDataset):
    """Image-list file, bilinear resize."""

    def __init__(self, img_size: int, image_list_file: str, horizontal_flip: bool = True):
        super().__init__(read_image_list(image_list_file), img_size, horizontal_flip)

    def _transform(self, arr: np.ndarray) -> np.ndarray:
        if arr.shape[:2] != (self.img_size,) * 2:
            arr = _resize(arr, (self.img_size, self.img_size), "bilinear")
        return arr


class CelebA(_FileListDataset):
    """Shorter side 320, centre crop 256, nearest resize to img_size."""

    def __init__(self, img_size: int, image_list_file: str, horizontal_flip: bool = True):
        super().__init__(read_image_list(image_list_file), img_size, horizontal_flip)

    def _transform(self, arr: np.ndarray) -> np.ndarray:
        arr = _center_crop(_resize_shorter(arr, 320), 256)
        if arr.shape[:2] != (self.img_size,) * 2:
            arr = _resize(arr, (self.img_size, self.img_size), "nearest")
        return arr


class _GlobDataset(_FileListDataset):
    def __init__(self, img_size: int, source: str, pattern: str, hflip: bool):
        if os.path.isdir(source):
            files = sorted(globlib.glob(os.path.join(source, pattern)))
        else:
            files = sorted(globlib.glob(source))
        super().__init__(files, img_size, hflip)

    def _transform(self, arr: np.ndarray) -> np.ndarray:
        if arr.shape[:2] != (self.img_size,) * 2:
            arr = _resize(arr, (self.img_size, self.img_size), "nearest")
        return arr


class Cats(_GlobDataset):
    """A folder of jpgs, nearest resize, flip."""

    def __init__(self, img_size: int, source: str):
        super().__init__(img_size, source, "*.jpg", hflip=True)


class Carla(_GlobDataset):
    """A folder of pngs, nearest resize, no flip."""

    def __init__(self, img_size: int, source: str):
        super().__init__(img_size, source, "*.png", hflip=False)


_DATASETS = {"FFHQ": FFHQ, "CelebA": CelebA, "Cats": Cats, "Carla": Carla}


def get_dataset(name: str, img_size: int, **kwargs):
    """Name-based construction; the result plugs into
    `cips3d_tpu_torch.data.zip_dataset.DataLoader`."""
    try:
        cls = _DATASETS[name]
    except KeyError:
        raise ValueError(f"unknown dataset {name!r}; have {sorted(_DATASETS)}")
    return cls(img_size=img_size, **kwargs)
