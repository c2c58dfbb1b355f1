"""What a bench leg launched and where its device time went: the kernels'
launch counts by product dtype (`ops/build.py`'s counters), and one call
under `torch.profiler`.

`cips3d_tpu_torch.bench.train` and `.inference` write these per leg into
the file their ``--report`` option names; `chip_smoke.py` reads them and
profiles its training steps with `profile_call` too.
"""

from __future__ import annotations

import re
import time
from typing import Callable, Dict

# the port's kernels in a profiler trace, demangled or mangled
_OURS = re.compile(r"(ray_tile|inr_tile)")


def launch_counts() -> Dict[str, Dict[str, int]]:
    """{kernel: {product dtype: launches}} since the counters were reset."""
    from cips3d_tpu_torch.ops import build

    out: Dict[str, Dict[str, int]] = {}
    for (kernel, dt), n in sorted(build.LAUNCHES.items()):
        out.setdefault(kernel, {})[dt] = n
    return out


def launches_since(before: Dict[str, Dict[str, int]]) -> Dict[str, Dict[str, int]]:
    """`launch_counts()` now minus ``before``, without the zeros."""
    out = {}
    for kernel, by in launch_counts().items():
        diff = {dt: n - before.get(kernel, {}).get(dt, 0) for dt, n in by.items()}
        diff = {dt: n for dt, n in diff.items() if n}
        if diff:
            out[kernel] = diff
    return out


def is_annotation(e) -> bool:
    """A `record_function` range (a user annotation), not a kernel."""
    return bool(getattr(e, "is_user_annotation", False)) or re.match(
        r"(Optimizer\.\w+#|ProfilerStep#)", e.key) is not None


def profile_call(fn: Callable[[], object]) -> Dict[str, object]:
    """One call of ``fn`` on the card under `torch.profiler`: its host-clock
    ms, the device's busy ms and idle share, the number of device events,
    the names of the port's kernels it ran (``kernels``) and how many times
    each ran (``ours``: {name: device events}), the ten largest device times
    (``top``: [ms, count, name]) and the `record_function` ranges
    (``ranges``: [name, ms, count]).

    Busy time sums the device's own events (kernels, copies, sets): an
    operator's device time is also credited to the host-side event that
    launched it, so those are not summed.  A range (Optimizer.step#Adam.step)
    shows on the device timeline as a user annotation spanning the kernels
    inside it and the gaps between them: it is listed apart and not summed
    either."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    ranges = [e for e in events if is_annotation(e)]
    kernels = [e for e in events if not is_annotation(e)]
    busy = sum(dev_us(e) for e in kernels) / 1e3
    return {"wall_ms": wall, "busy_ms": busy, "idle_pct": 100.0 - 100.0 * busy / wall,
            "device_events": sum(e.count for e in kernels),
            "kernels": sorted({e.key for e in kernels if _OURS.search(e.key)}),
            "ours": {e.key: e.count for e in kernels if _OURS.search(e.key)},
            "top": [[dev_us(e) / 1e3, e.count, e.key]
                    for e in sorted(kernels, key=dev_us, reverse=True)[:10]],
            "ranges": [[e.key, dev_us(e) / 1e3, e.count] for e in ranges]}
