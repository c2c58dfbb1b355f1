"""Native image IO of the port's data path: the counterpart of
`cips3d_tpu/native/`, with JPEG decode and PIL's resize added.

`zipreader.cpp` parses zips, inflates members, decodes PNG and baseline
JPEG to RGB8 and resizes uint8 images exactly as PIL does.  `g++` builds it
at first use (`library()`), never at import: the shared library is named by
a hash of the source and the flags and lands in ``native/build/``
(git-ignored); each build writes a temporary file and renames it into
place, so processes that build at once each load a whole library.  A
failed build raises with the compiler's output: nothing here falls back to
another decoder.

The calls release the GIL (ctypes), and a `NativeZipReader` locks its zip
only over the seek and read of a member, so loader threads decode in
parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "zipreader.cpp"
BUILD_DIR = SRC.parent / "build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
LIBS = ["-lz"]
FILTERS = {"nearest": 0, "lanczos": 1, "bilinear": 2}   # PIL's numbering

_lock = threading.Lock()
_lib = None

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_U32P = ctypes.POINTER(ctypes.c_uint32)
_SIGNATURES = {
    "zr_open": ([ctypes.c_char_p], _P),
    "zr_close": ([_P], None),
    "zr_count": ([_P], _I64),
    "zr_name": ([_P, _I64], ctypes.c_char_p),
    "zr_entry_size": ([_P, _I64], _I64),
    "zr_read_raw": ([_P, _I64, _P], _I),
    "zr_read_image": ([_P, _I64, _P, _U32P, _U32P, _I], _I),
    "zr_decode_image": ([ctypes.c_char_p, _I64, _P, _U32P, _U32P, _I], _I),
    "zr_resize": ([_P, _I, _I, _I, _P, _I, _I, _I], _I),
    "zr_last_error": ([], ctypes.c_char_p),
}


def _compiler() -> str:
    for name in ("g++", "c++"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("no C++ compiler (g++ or c++) on PATH: the native image library needs one")


def build() -> Path:
    """Compile `zipreader.cpp` unless this source and these flags have a
    library already; returns its path."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    out = BUILD_DIR / f"libzipreader_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SRC), *LIBS],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SRC.name} failed:\n{(proc.stdout + proc.stderr)[-6000:]}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def _raise(lib, what: str, rc: int):
    raise ValueError(f"{what}: {lib.zr_last_error().decode() or f'error {rc}'}")


def decode_image(data: bytes, name: str = "image") -> np.ndarray:
    """PNG or JPEG bytes -> (H, W, 3) uint8 RGB, as PIL's
    ``Image.open(...).convert("RGB")`` gives them.  Raises naming ``name``
    for anything else, including the JPEG flavours the decoder refuses."""
    lib = library()
    w, h = ctypes.c_uint32(), ctypes.c_uint32()
    rc = lib.zr_decode_image(data, len(data), None, ctypes.byref(w), ctypes.byref(h), 1)
    if rc:
        _raise(lib, name, rc)
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.zr_decode_image(data, len(data), out.ctypes.data, ctypes.byref(w), ctypes.byref(h), 0)
    if rc:
        _raise(lib, name, rc)
    return out


def read_image(path: str) -> np.ndarray:
    """A PNG or JPEG file -> (H, W, 3) uint8 RGB."""
    with open(path, "rb") as f:
        return decode_image(f.read(), path)


def resize(img: np.ndarray, width: int, height: int, method: str = "lanczos") -> np.ndarray:
    """HWC uint8 -> (height, width, C) uint8, as PIL's ``Image.resize`` with
    ``method`` (lanczos, bilinear or nearest); the plain versions are
    `utils/image_io.py`'s ``resize_*``."""
    lib = library()
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    out = np.empty((height, width, c), np.uint8)
    rc = lib.zr_resize(img.ctypes.data, h, w, c, out.ctypes.data, height, width, FILTERS[method])
    if rc:
        _raise(lib, "resize", rc)
    return out


class NativeZipReader:
    """The members of one zip, read and decoded by the native library; safe
    to share between threads."""

    def __init__(self, path: str):
        lib = self._lib = library()
        self._h = lib.zr_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open zip: {path}")
        self.names = [lib.zr_name(self._h, i).decode() for i in range(lib.zr_count(self._h))]

    def read_raw(self, idx: int) -> bytes:
        size = self._lib.zr_entry_size(self._h, idx)
        if size < 0:
            raise IndexError(idx)
        buf = ctypes.create_string_buffer(size)
        rc = self._lib.zr_read_raw(self._h, idx, buf)
        if rc:
            _raise(self._lib, self.names[idx], rc)
        return buf.raw

    def read_image(self, idx: int) -> np.ndarray:
        """Member ``idx`` (PNG or JPEG) -> (H, W, 3) uint8 RGB."""
        w, h = ctypes.c_uint32(), ctypes.c_uint32()
        rc = self._lib.zr_read_image(self._h, idx, None, ctypes.byref(w), ctypes.byref(h), 1)
        if rc == 0:
            out = np.empty((h.value, w.value, 3), np.uint8)
            rc = self._lib.zr_read_image(self._h, idx, out.ctypes.data, ctypes.byref(w),
                                         ctypes.byref(h), 0)
        if rc:
            _raise(self._lib, self.names[idx], rc)
        return out

    def close(self):
        if self._h:
            self._lib.zr_close(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()
