"""Build and load the CUDA kernels of `cips3d_tpu_torch/csrc/`.

The kernels have a plain C interface: `nvcc` compiles every ``csrc/*.cu``
for ``sm_90a`` (one process per source, all started together), links the
objects into one shared library and `ctypes` loads it; no PyTorch header is
compiled.  The library is named by a hash of the sources and lands in
``csrc/build/`` (git-ignored), so an edit rebuilds and an unchanged tree
reuses the last build.  Nothing here runs at import time: the first
`library()` call builds.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib = None
build_seconds = None   # wall time of the build this process ran, if any

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "cips_ray_tile_forward": [_P] * 17 + [_I] * 8 + [_F, _F] + [_I] * 6 + [_P],
    "cips_ray_tile_forward_occupancy": [_I] * 6 + [_P],
    "cips_ray_tile_block_rays": [],
    "cips_ray_tile_backward": [_P] * 23 + [_I] * 12 + [_F, _F] + [_I] * 4 + [_P],
    "cips_ray_tile_backward_cot_width": [_I] * 4,
    "cips_ray_tile_backward_occupancy": [_I] * 7 + [_P],
    "cips_inr_tile_forward": [_P] * 9 + [_I] * 7 + [_P],
    "cips_inr_tile_pixels": [],
    "cips_inr_tile_occupancy": [_I, _I, _P],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build() -> Path:
    """Compile the kernels if this source tree has no library yet; returns
    the library path.  The compiler's resource report (registers, shared
    memory, spills) is written beside it as ``.log``."""
    global build_seconds
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"libcips3d_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True)))
    log, failed = [], False
    for obj, proc in jobs:
        text = proc.communicate()[0]
        log.append(text)
        failed |= proc.returncode != 0
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp), *(str(o) for o, _ in jobs)],
                              capture_output=True, text=True)
        log.append(link.stdout + link.stderr)
        failed = link.returncode != 0
    for obj, _ in jobs:
        obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    out.with_suffix(".log").write_text("".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed:\n{''.join(log)[-6000:]}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.cips_error_string.argtypes = [ctypes.c_int]
            lib.cips_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({lib.cips_error_string(err).decode()})")
