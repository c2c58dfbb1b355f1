"""Spans and counters of the port: where a frame's or a step's time goes.

**Counters** are always on.  A family is a `collections.Counter` of counts
by key (`counter`), bumped by `count`:

  ``launches``     kernel launches by (kernel, product dtype): `ops/build.py`'s
                   ``LAUNCHES``;
  ``collectives``  `parallel/mesh.py`'s ``COLLECTIVES`` by kind;
  ``build``        the nanoseconds of the kernels' build (``ns``,
                   `ops/build.py`);
  ``graph``        CUDA graphs captured (``captures``) and the nanoseconds of
                   their warm-ups, less a build of the kernels inside one, and
                   of their captures (``warm_up_ns``, ``capture_ns``,
                   `utils/graphs.py`);
  ``serve.styles`` the render server's style cache: ``hit``, ``miss``.

A count made by a thread that is capturing a CUDA graph (inside
`recording`) goes to the capture's record instead, and `add` counts that
record once per replay: a replay runs no Python.

**Spans** are off by default.  `span` is then one check of a module flag and
returns a shared null context: nothing is recorded and the profiler sees
nothing.  After `enable`, a span records its name, start and end
(`time.perf_counter_ns`), its thread (the system's id, as the profiler
names threads), its parent (the innermost span open on that thread) and its
request: the id of the root span of its thread's nest.  While a profiler
runs (in any thread) it also enters `torch.profiler.record_function`, so
that the span lies in the trace beside the device's operations, where
`profile_idle` reads it; not otherwise, since that op is most of a span's
cost on the host.  Records go to one buffer of `CAPACITY` records that `drain`
empties; records past it are dropped.

**Phases** mark stretches of a training step's device work (`phase`).  Inside
`stamps` on a CUDA device a phase writes the device's clock
(``%globaltimer``, `csrc/common.cu`) before and after the stretch into a
one-step tensor that the caller copies out with the step's metrics: a CUDA
graph captured so records the stamps in every replay.  `add_phases` turns
read-back stamps into records.  Anywhere else (the CPU, a step outside
`stamps`) a phase is a span timed by the host clock.  With tracing off at a
capture nothing is captured.

The flag, the buffer and the counters are the process's, as the profiler's
state is: `enable`, `disable` and `drain` are the whole control.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

CAPACITY = 1 << 18

COUNTERS: Dict[str, collections.Counter] = collections.defaultdict(collections.Counter)
_on = False
_records: List[dict] = []
_records_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_steps = itertools.count()
_NULL = contextlib.nullcontext()


# ------------------------------------------------------------------ counters


def counter(family: str) -> collections.Counter:
    """The counts of ``family`` by key (the same object for the process's life)."""
    return COUNTERS[family]


def count(family: str, key, n: int = 1) -> None:
    """``n`` more of ``key`` in ``family`` (into the capture's record while
    this thread records one)."""
    record = getattr(_local, "record", None)
    (record if record is not None else COUNTERS)[family][key] += n


@contextlib.contextmanager
def recording():
    """The counts this thread makes in the block, kept out of the counters:
    yields the record ({family: Counter}), for `add`."""
    record = collections.defaultdict(collections.Counter)
    prev = getattr(_local, "record", None)
    _local.record = record
    try:
        yield record
    finally:
        _local.record = prev


def add(record: Dict[str, collections.Counter], k: int = 1) -> None:
    """Count ``k`` more calls that each made the counts of ``record``."""
    for family, counts in record.items():
        for key, n in counts.items():
            COUNTERS[family][key] += n * k


# ------------------------------------------------------------------ spans


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def drain() -> List[dict]:
    """The records since the last drain, in the order they ended."""
    global _records
    with _records_lock:
        out, _records = _records, []
    return out


def _emit(rec: dict) -> None:
    with _records_lock:
        if len(_records) < CAPACITY:
            _records.append(rec)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("rec", "rf")

    def __init__(self, name: str, attrs: dict):
        self.rec = dict(attrs, name=name)

    def __enter__(self) -> dict:
        rec, stack = self.rec, _stack()
        parent = stack[-1] if stack else None
        rec["id"] = next(_ids)
        rec["parent"] = parent["id"] if parent else None
        rec["request"] = parent["request"] if parent else rec["id"]
        rec["thread"] = threading.get_native_id()
        stack.append(rec)
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(rec["name"])
            self.rf.__enter__()
        rec["start"] = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc):
        self.rec["end"] = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _stack().pop()
        _emit(self.rec)
        return False


def span(name: str, **attrs):
    """A context manager recording ``name`` (with ``attrs``) while tracing is
    on; the shared null context while it is off."""
    if not _on:
        return _NULL
    return _Span(name, attrs)


# ------------------------------------------------------------------ phases


class Stamps:
    """The phases of one step run inside `stamps` on ``device``: their names,
    and on CUDA one 0-d int64 tensor a stamp, which the stamp kernel fills
    with the device's clock when the stream reaches it."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.step = next(_steps)
        self.names: List[str] = []
        self.slots: List[torch.Tensor] = []

    def stamp(self) -> None:
        from cips3d_tpu_torch.ops import build

        out = torch.empty((), dtype=torch.int64, device=self.device)
        lib = build.library()
        build.check(lib, lib.cips_stamp(out.data_ptr(),
                                        torch.cuda.current_stream(self.device).cuda_stream),
                    "stamp")
        self.slots.append(out)

    def tensor(self) -> Optional[torch.Tensor]:
        """The step's stamps (2 a phase, in order) as one tensor; None when
        no phase stamped."""
        return torch.stack(self.slots) if self.slots else None


@contextlib.contextmanager
def stamps(device):
    """Collect the phases of the one step that runs in the block on this
    thread: yields its `Stamps`."""
    st = Stamps(device)
    prev = getattr(_local, "stamps", None)
    _local.stamps = st
    try:
        yield st
    finally:
        _local.stamps = prev


class _DevicePhase:
    __slots__ = ("st",)

    def __init__(self, st: Stamps, name: str):
        self.st = st
        st.names.append(name)

    def __enter__(self):
        self.st.stamp()

    def __exit__(self, *exc):
        self.st.stamp()
        return False


def phase(name: str):
    """A context manager marking a stretch of a step's device work while
    tracing is on (the module docstring); the shared null context while it
    is off."""
    if not _on:
        return _NULL
    st = getattr(_local, "stamps", None)
    if st is not None and st.device.type == "cuda":
        return _DevicePhase(st, name)
    return _Span(name, {"step": st.step if st is not None else None})


def add_phases(names: Sequence[str], rows: Iterable[Sequence[int]]) -> None:
    """Records of read-back device stamps: one row a step, two stamps a
    phase of ``names``, each record timed on the device's clock."""
    if not _on:
        return
    for row in rows:
        step = next(_steps)
        for i, name in enumerate(names):
            _emit({"name": name, "start": int(row[2 * i]), "end": int(row[2 * i + 1]),
                   "clock": "device", "step": step})


# ------------------------------------------------------------------ idle attribution


def idle_by_span(device_ops: Iterable[Tuple[int, int, int]], launch_threads: Dict[int, int],
                 spans: Iterable[Tuple[str, int, int, int]]) -> List[list]:
    """Each idle gap of the device put down to a span: the innermost span
    open, at the gap's midpoint, on the thread that launched the device
    operation ending the gap; ``"untraced"`` where there is none.
    ``device_ops`` are (start ns, end ns, correlation id), ``launch_threads``
    maps a correlation id to the thread of the runtime call that launched
    it, ``spans`` are (name, start ns, end ns, thread) on the same clock.
    Returns [name, idle seconds] of every name charged, largest first."""
    by_thread: Dict[int, list] = collections.defaultdict(list)
    for name, s, e, thread in spans:
        by_thread[thread].append((s, e, name))
    starts = {}
    for thread, lst in by_thread.items():
        lst.sort()
        starts[thread] = [s for s, _, _ in lst]
    out: collections.Counter = collections.Counter()
    end = None
    for s, e, corr in sorted(device_ops):
        if end is not None and s > end:
            mid = (end + s) / 2
            thread = launch_threads.get(corr)
            name = "untraced"
            lst = by_thread.get(thread)
            if lst:
                # spans of one thread nest: the open span that started last is the innermost
                for i in range(bisect.bisect_right(starts[thread], mid) - 1, -1, -1):
                    if lst[i][1] >= mid:
                        name = lst[i][2]
                        break
            out[name] += (s - end) / 1e9
        end = e if end is None else max(end, e)
    return [[name, sec] for name, sec in out.most_common()]


def profile_idle(events, names) -> List[list]:
    """`idle_by_span` of a profiler session's kineto events
    (``prof.profiler.kineto_results.events()``), the spans being the host
    events named in ``names`` (the names of the drained records): the
    device's operations but the spans' device-side copies, the runtime calls
    (``cuda*``, ``cu*``) that launched them, each thread by its system id."""
    ops, launches, spans = [], {}, []
    for ev in events:
        name = ev.name()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if name not in names and ev.duration_ns() > 0:
                ops.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.correlation_id()))
        elif name in names:
            spans.append((name, ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                          ev.device_resource_id()))
        elif name.startswith("cu"):
            launches[ev.correlation_id()] = ev.device_resource_id()
    return idle_by_span(ops, launches, spans)
