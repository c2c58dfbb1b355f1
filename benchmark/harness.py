"""What every driver shares: the cell's files found by name, the weights
made from the seed, the device record, the profiler slice, the timing of
recorded kernel calls, the check lines and the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``, whose ``driver`` names a module
of ``drivers/``); the limits of its correctness check are
``limits/<cell>.json``; each per-layer metric is ``metrics/<name>.py``.  A driver
returns a `Run`; `finish` turns it into the one JSON line the benchmark
prints last.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "cips3d_tpu")


def load_json(*parts: str) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload with its configuration, traffic and metric lists."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, float]


def cell(name: str, spec: Optional[dict] = None) -> Cell:
    spec = spec or benchmark_spec()
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(work)}")
    w = work[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(os.path.join(ROOT, cfg_entry["file"])) as f:
        config = json.load(f)

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return Cell(name, int(w["chips"]), config, load_json("traffic", w["traffic"] + ".json"),
                [m for m in spec["end_to_end"] if mine(m)],
                [m for m in spec["per_layer"] if mine(m)],
                load_json("limits", name + ".json")["limits"])


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod   # where dataclasses look up the module's names
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The reader of per-layer metric ``name`` (``metrics/<name>.py``)."""
    return load_module(os.path.join(HERE, "metrics", name + ".py"),
                       "bench_metric_" + name.replace(".", "_"))


def driver(name: str):
    return load_module(os.path.join(HERE, "drivers", name + ".py"), "bench_driver_" + name)


# ------------------------------------------------------------------ device


def card_record(torch, count: int) -> dict:
    """The result line's platform, kind and count of cards."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def set_precision(torch, config: dict) -> None:
    """The TF32 flags the configuration states (PyTorch's defaults where it
    states none)."""
    prec = config.get("precision", {})
    torch.backends.cuda.matmul.allow_tf32 = bool(
        prec.get("torch.backends.cuda.matmul.allow_tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(prec.get("torch.backends.cudnn.allow_tf32", True))


def precision_flags(torch) -> dict:
    return {"matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision()}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ------------------------------------------------------------------ weights


def seeded_modules(ctor: Callable, seed: int, device) -> Any:
    """A reference module built on ``device`` from a `torch.Generator` there
    seeded with ``seed``: every draw of its initialisation is made on the
    device."""
    import torch

    g = torch.Generator(device).manual_seed(seed)
    with torch.device(device):
        return ctor(g)


def load_weights(module, state: Dict[str, Any]) -> None:
    """Copy ``state`` (a state dict of the same layout) into ``module``."""
    missing, unexpected = module.load_state_dict(state, strict=False)
    if missing or unexpected:
        raise ValueError(f"weights do not match: missing {missing[:5]}, "
                         f"unexpected {unexpected[:5]}")


# ------------------------------------------------------------------ profiling


def profile_slice(torch, fn: Callable[[], Any]) -> dict:
    """Run ``fn`` under the profiler: the wall seconds, the seconds in which
    some device operation ran (the union of the kernels' and copies'
    intervals), the device operations that took most time and the longest
    gaps between them, each named by the operation that ended it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:   # the device work launched by every thread, not only this one's
        config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        config = None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=config) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, per_op = [], {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA or ev.duration_ns() <= 0:
            continue
        start = ev.start_ns()
        spans.append((start, start + ev.duration_ns(), ev.name()))
        per_op[ev.name()] = per_op.get(ev.name(), 0.0) + ev.duration_ns() / 1e9
    spans.sort()
    log(f"profiled {wall:.3f} s: {len(spans)} device operations")
    busy, gaps, cur = 0.0, [], None
    for s, e, name in spans:
        if cur is None:
            cur = [s, e]
        elif s <= cur[1]:
            cur[1] = max(cur[1], e)
        else:
            busy += cur[1] - cur[0]
            gaps.append(((s - cur[1]) / 1e9, "before " + name))
            cur = [s, e]
    if cur is not None:
        busy += cur[1] - cur[0]
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
    gaps.sort(reverse=True)
    return {"busy_s": busy / 1e9, "window_s": wall,
            "device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[name, g] for g, name in gaps[:10]]}


# ------------------------------------------------------------------ kernel calls


class Recorder:
    """Records the arguments of calls to module attributes (``module:attr``)
    while active, and puts the attributes back after."""

    def __init__(self, entries: List[str]):
        self.entries = sorted(set(entries))
        self.calls: Dict[str, List[Tuple[tuple, dict]]] = {e: [] for e in self.entries}
        self.originals: Dict[str, Callable] = {}

    def __enter__(self):
        for e in self.entries:
            mod_name, attr = e.split(":")
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self.originals[e] = fn

            def wrapper(*args, _fn=fn, _e=e, **kwargs):
                self.calls[_e].append((args, kwargs))
                return _fn(*args, **kwargs)

            setattr(mod, attr, wrapper)
        return self

    def __exit__(self, *exc):
        for e, fn in self.originals.items():
            mod_name, attr = e.split(":")
            setattr(importlib.import_module(mod_name), attr, fn)
        return False


def time_call(torch, fn: Callable, args: tuple, kwargs: dict, min_ms: float = 50.0) -> float:
    """Seconds one call takes on the device: CUDA events around a run of
    launches, after a warm-up, the run long enough to span ``min_ms``."""
    for _ in range(3):
        fn(*args, **kwargs)
    torch.cuda.synchronize()
    n = 1
    while True:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn(*args, **kwargs)
        b.record()
        b.synchronize()
        ms = a.elapsed_time(b)
        if ms >= min_ms or n >= 4096:
            return ms / n / 1e3
        n *= 2 if ms <= 0 else max(2, int(math.ceil(min_ms / ms)))


# ------------------------------------------------------------------ checks and result


@dataclasses.dataclass
class Run:
    """What a driver measured: the window's counts, the end-to-end and the
    per-layer readings, the device record and the checks."""

    attempted: int
    failed: int
    values: Dict[str, float]
    device: dict
    checks: Dict[str, Tuple[float, float]]
    breakdown: Optional[dict] = None
    loaded: List[str] = dataclasses.field(default_factory=list)   # forbidden, in other processes


def passed(checks: Dict[str, Tuple[float, float]]) -> bool:
    return all(math.isfinite(v) and v <= lim for v, lim in checks.values())


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def finish(c: Cell, run: Run, trace: bool) -> int:
    """Print the check lines and the result line; the exit code."""
    bad = forbidden_modules()
    if bad or run.loaded:
        log(f"refused: modules {bad} are loaded in the process that measured, "
            f"{run.loaded} in the processes it started")
        return 3
    metrics = {}
    for m in (c.per_layer if trace else c.end_to_end):
        v = run.values.get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    missing = [m["name"] for m in (c.per_layer if trace else c.end_to_end)
               if m["name"] not in metrics]
    if missing:
        log(f"not read in this run: {missing}")
    out = {"correct": passed(run.checks), "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": run.device}
    if trace and run.breakdown:
        out["breakdown"] = run.breakdown
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    for k, (v, lim) in run.checks.items():
        log(f"check {k} = {v!r} (limit {lim!r}) {'ok' if v <= lim else 'FAILED'}")
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0
