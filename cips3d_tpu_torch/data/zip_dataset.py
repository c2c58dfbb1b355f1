"""StyleGAN-zip image dataset and a threaded loader: counterpart of
`cips3d_tpu/data/zip_dataset.py`.

A zip of PNG or JPEG images (plus an optional ``dataset.json`` of
labels); ``xflip`` doubles the dataset with mirrored copies,
``resize_resolution`` resizes with the Lanczos filter as PIL does,
``cache_decoded`` keeps the decoded and resized pixels in a uint8 memmap
beside the zip.  With ``use_native`` (the default) members are read,
decoded and resized by the native library (`cips3d_tpu_torch/native/`),
which releases the GIL, so the loader's threads decode in parallel; a
member it cannot decode raises.  ``use_native=False`` is the plain path:
numpy's PNG decoder and Lanczos (`utils/image_io.py`), PNG members only.
"""

from __future__ import annotations

import json
import os
import queue
import sys
import threading
import zipfile
from typing import Iterator, List, Optional, Tuple

import numpy as np

from cips3d_tpu_torch import native
from cips3d_tpu_torch.utils import image_io, trace

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


class ZipImageDataset:
    """Random-access view over a StyleGAN-format image zip."""

    def __init__(self, path: str, resize_resolution: Optional[int] = None, xflip: bool = False,
                 max_size: Optional[int] = None, use_labels: bool = False,
                 use_native: bool = True, cache_decoded: bool = False):
        self.path = path
        self.resize_resolution = resize_resolution
        self.xflip = xflip
        self.use_labels = use_labels
        self.cache_decoded = cache_decoded
        self._cache: Optional[np.memmap] = None
        self._cache_done: Optional[np.memmap] = None
        self._local = threading.local()
        self._native = native.NativeZipReader(path) if use_native else None
        with zipfile.ZipFile(path) as zf:
            names = sorted(n for n in zf.namelist() if n.lower().endswith(IMAGE_EXTS))
            self._labels = None
            if use_labels and "dataset.json" in zf.namelist():
                label_map = dict(json.loads(zf.read("dataset.json")).get("labels") or [])
                self._labels = [label_map.get(n, 0) for n in names]
        if max_size is not None:
            names = names[:max_size]
            if self._labels:
                self._labels = self._labels[:max_size]
        self._names = names
        self._base_len = len(names)
        if self._base_len == 0:
            raise ValueError(f"no images found in {path}")
        if self._native is not None:
            index = {n: i for i, n in enumerate(self._native.names)}
            self._native_idx = [index[n] for n in names]

    def __len__(self) -> int:
        return self._base_len * (2 if self.xflip else 1)

    @property
    def resolution(self) -> int:
        return self[0][0].shape[-1]

    def _zf(self) -> zipfile.ZipFile:
        if not hasattr(self._local, "zf"):   # one open handle per reader thread
            self._local.zf = zipfile.ZipFile(self.path)
        return self._local.zf

    _cache_lock = threading.Lock()

    def _ensure_cache(self, res: int):
        if self._cache is not None:
            return
        with self._cache_lock:
            if self._cache is not None:
                return
            base = f"{self.path}.decoded_{res}"
            shape = (self._base_len, res, res, 3)
            data_p, done_p = base + ".npy", base + ".done.npy"

            def _open_existing():
                cache = np.lib.format.open_memmap(data_p, mode="r+")
                done = np.lib.format.open_memmap(done_p, mode="r+")
                if cache.shape != shape or done.shape != (self._base_len,):
                    raise ValueError("a stale decode cache")
                return cache, done

            try:
                cache, done = _open_existing()
            except (FileNotFoundError, ValueError):
                # never truncate a path another process may have mapped: build fresh files
                # under temporary names and rename them into place, under an flock
                import fcntl

                with open(base + ".lock", "w") as lk:
                    fcntl.flock(lk, fcntl.LOCK_EX)
                    try:
                        cache, done = _open_existing()
                    except (FileNotFoundError, ValueError):
                        tmp = f"{base}.tmp{os.getpid()}"
                        c = np.lib.format.open_memmap(tmp + ".npy", mode="w+", dtype=np.uint8,
                                                      shape=shape)
                        d = np.lib.format.open_memmap(tmp + ".done.npy", mode="w+",
                                                      dtype=np.uint8, shape=(self._base_len,))
                        c.flush()
                        d.flush()
                        del c, d
                        os.replace(tmp + ".npy", data_p)
                        os.replace(tmp + ".done.npy", done_p)
                        cache, done = _open_existing()
            self._cache_done = done
            self._cache = cache

    def _decode(self, base_idx: int) -> np.ndarray:
        """Decode one image and resize it: HWC uint8 RGB."""
        r = self.resize_resolution
        if self._native is not None:
            arr = self._native.read_image(self._native_idx[base_idx])
            if r and arr.shape[:2] != (r, r):
                arr = native.resize(arr, r, r, "lanczos")
            return arr
        name = self._names[base_idx]
        if not name.lower().endswith(".png"):
            raise ValueError(f"{name}: the plain path (use_native=False) decodes PNG members only")
        arr = image_io.to_rgb(image_io.decode_png(self._zf().read(name)))
        if r and arr.shape[:2] != (r, r):
            arr = image_io.resize_lanczos(arr, r, r)
        return arr

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        """(CHW uint8 image, label)."""
        flip = self.xflip and idx >= self._base_len
        base_idx = idx % self._base_len
        if self.cache_decoded:
            arr0 = self._decode(base_idx) if self._cache is None else None
            if arr0 is not None:
                self._ensure_cache(arr0.shape[0])
                self._cache[base_idx] = arr0
                self._cache_done[base_idx] = 1
                arr = arr0
            elif self._cache_done[base_idx]:
                arr = np.asarray(self._cache[base_idx])
            else:
                arr = self._decode(base_idx)
                self._cache[base_idx] = arr
                self._cache_done[base_idx] = 1
        else:
            arr = self._decode(base_idx)
        if flip:
            arr = arr[:, ::-1]
        label = self._labels[base_idx] if self._labels else 0
        return arr.transpose(2, 0, 1), label


def to_norm_tensor(batch_u8: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> float32 [-1, 1]."""
    return batch_u8.astype(np.float32) / 127.5 - 1.0


class DataLoader:
    """Infinite shuffled batch iterator with a background producer thread
    and a pool of decode threads.  Shard ``shard_index`` of ``num_shards``
    reads indices ``i * num_shards + shard_index`` of each epoch's
    permutation.  With tracing on (`utils/trace.py`), each wait for a batch
    is a span (``data.wait``)."""

    def __init__(self, dataset: ZipImageDataset, batch_size: int, seed: int = 0,
                 shard_index: int = 0, num_shards: int = 1, num_workers: int = 4,
                 prefetch: int = 4, shuffle: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.num_workers = max(1, num_workers)
        self.shuffle = shuffle
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _index_stream(self) -> Iterator[int]:
        rng = np.random.default_rng(self.seed)
        n = len(self.dataset)
        while True:
            order = rng.permutation(n) if self.shuffle else np.arange(n)
            for i in range(self.shard_index, n, self.num_shards):
                yield int(order[i])

    def _producer(self):
        from concurrent.futures import ThreadPoolExecutor

        stream = self._index_stream()
        with ThreadPoolExecutor(self.num_workers) as pool:
            while not self._stop.is_set():
                idxs = [next(stream) for _ in range(self.batch_size)]
                try:
                    items = list(pool.map(self.dataset.__getitem__, idxs))
                except BaseException as e:
                    # a loader shutting down closes the pool: stop quietly; any other
                    # failure is kept for __next__ to raise
                    if self._stop.is_set() or sys.is_finalizing() or "after shutdown" in str(e):
                        return
                    self._error = e
                    return
                batch = (np.stack([it[0] for it in items]),
                         np.array([it[1] for it in items], np.int32))
                while not self._stop.is_set():
                    try:
                        self._queue.put(batch, timeout=1)
                        break
                    except queue.Full:
                        continue

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        with trace.span("data.wait"):
            while True:
                try:
                    return self._queue.get(timeout=1)
                except queue.Empty:
                    if self._error is not None:
                        raise RuntimeError("DataLoader producer thread failed") from self._error
                    if not self._thread.is_alive() and self._queue.empty():
                        raise RuntimeError("DataLoader producer thread exited")

    def close(self):
        self._stop.set()
        try:   # drain, so that a producer blocked in put() sees the stop
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10)


def write_stylegan_zip(out_path: str, images, labels: Optional[List[int]] = None):
    """Write HWC uint8 images as PNGs into a StyleGAN-format zip (+
    dataset.json)."""
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_STORED) as zf:
        names = []
        for i, arr in enumerate(images):
            name = f"img{i:08d}.png"
            zf.writestr(name, image_io.encode_png(np.asarray(arr, np.uint8)))
            names.append(name)
        if labels is not None:
            meta = {"labels": [[n, int(l)] for n, l in zip(names, labels)]}
            zf.writestr("dataset.json", json.dumps(meta))
