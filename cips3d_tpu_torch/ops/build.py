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

from cips3d_tpu_torch.utils import trace

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
    # the density-noise scale is a pointer (a one-element f32 tensor on the device, null
    # where the noise does not apply)
    "cips_ray_tile_forward": [_P] * 18 + [_I] * 8 + [_F] + [_I] * 6 + [_P],
    "cips_ray_tile_forward_occupancy": [_I] * 6 + [_P],
    "cips_ray_tile_block_rays": [],
    "cips_ray_tile_backward": [_P] * 24 + [_I] * 12 + [_F] + [_I] * 4 + [_P],
    "cips_ray_tile_backward_cot_width": [_I] * 4,
    "cips_ray_tile_backward_occupancy": [_I] * 7 + [_P],
    "cips_inr_tile_forward": [_P] * 9 + [_I] * 7 + [_P],
    "cips_inr_tile_pixels": [],
    "cips_inr_tile_occupancy": [_I, _I, _P],
    # the streamed paths (shapes past the resident kernels' shared memory)
    "cips_ray_tile_forward_streamed": [_P] * 22 + [_I] * 8 + [_F] + [_I] * 4 + [_P],
    "cips_ray_tile_backward_streamed": [_P] * 30 + [_I] * 10 + [_F] + [_I] * 4 + [_P],
    "cips_ray_tile_streamed_ray_rows": [],
    "cips_ray_tile_streamed_smem": [_I],
    "cips_inr_tile_forward_streamed": [_P] * 12 + [_I] * 6 + [_P],
    "cips_inr_tile_streamed_smem": [_I],
    "cips_stream_tile": [_I],
    "cips_smem_optin": [_P],
    "cips_stamp": [_P, _P],
}
# byte counts of the resident layouts (long long)
_SIGNATURES_LL = {
    "cips_ray_tile_forward_smem": [_I] * 6,
    "cips_ray_tile_backward_smem": [_I] * 6,
    "cips_inr_tile_smem": [_I],
    "cips_inr_tile_streamed_wsplit": [_I, _I],
    "cips_ray_tile_streamed_sums": [_I] * 5,
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
    trace.count("build", "ns", int(build_seconds * 1e9))
    # renamed into place as the library is: processes building at once each
    # leave one whole report, never an interleaving of two
    log_tmp = out.with_suffix(f".{os.getpid()}.log.tmp")
    log_tmp.write_text("".join(log))
    os.replace(log_tmp, out.with_suffix(".log"))
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
            for table, restype in ((_SIGNATURES, ctypes.c_int),
                                   (_SIGNATURES_LL, ctypes.c_longlong)):
                for name, argtypes in table.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = restype
            lib.cips_error_string.argtypes = [ctypes.c_int]
            lib.cips_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({lib.cips_error_string(err).decode()})")


# The path a kernel wrapper takes: the resident kernel where the shape fits, the streamed one
# elsewhere ("auto"), or one of them forced
PATHS = ("auto", "resident", "streamed")


def check_path(path: str) -> str:
    if path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}, got {path!r}")
    return path


_OPTIN = {}


def smem_optin(dev) -> int:
    """The device's opt-in shared memory a block (bytes), from the CUDA
    runtime through the kernel library."""
    import torch

    dev = torch.device(dev)
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in _OPTIN:
        lib = library()
        out = ctypes.c_int(0)
        with torch.cuda.device(key):
            check(lib, lib.cips_smem_optin(ctypes.byref(out)), "shared memory query")
        _OPTIN[key] = out.value
    return _OPTIN[key]


# Every kernel launch, counted by the wrapper that launches it: {(kernel, product dtype): n}
# since the last `reset_launches` (the ``launches`` counters of `utils/trace.py`).  The
# kernels: #2, #2r, #3 recompute, #3 residual, #1, each on its resident path, then each on
# its streamed path (`STREAMED`: a wrapper call that runs the streamed sequence of launches
# counts once).
RESIDENT = ("ray_tile", "ray_tile_residuals", "ray_tile_bwd_recompute", "ray_tile_bwd_residual",
            "inr_tile")
STREAMED = tuple(k + "_streamed" for k in RESIDENT)
KERNELS = RESIDENT + STREAMED
LAUNCHES = trace.counter("launches")


def count_launch(kernel: str, mm_dtype) -> None:
    """One launch of ``kernel`` (a name of `KERNELS`) with ``mm_dtype``
    products (``"float32"`` or ``"bfloat16"``: #2, #2r and #3 take it as a
    flag, so their symbol does not tell it)."""
    trace.count("launches", (kernel, str(mm_dtype).replace("torch.", "")))


def launches(kernel: str) -> int:
    """``kernel``'s launches in either product dtype."""
    return sum(n for (k, _), n in LAUNCHES.items() if k == kernel)


def reset_launches() -> None:
    LAUNCHES.clear()
