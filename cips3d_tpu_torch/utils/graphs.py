"""One program a call on the card: the CUDA-graph core of the port's
dispatch, shared by the training chunks (`train/chunk.py`) and the render
side (`apps/render.py`, `apps/serve.py`, `apps/inversion.py`,
`apps/shapes.py`, `eval/images.py`, `bench/inference.py`).

The JAX package compiles each call it repeats into one program (a jitted
function, a ``lax.scan``).  On the card the counterpart is a CUDA graph of
the call.  `Graph` runs the call once on a side stream (the warm-up:
kernels built, cuBLAS and cuDNN plans made, lazy device tensors allocated),
puts back the tensors it changed and the generators it drew from, records
one call into a `torch.cuda.CUDAGraph` and then replays it.  The call reads
its inputs from buffers that its caller fills before each replay by device
copies (`fill`: a host array goes through pinned memory first, so no copy
from pageable memory is queued), and its outputs are buffers too, which the
caller copies out before the next replay.

Random draws: every `torch.Generator` the call draws from is registered
with the graph, so that a replay draws from the generator's current state
and advances it as an eager call would.  `driven_by` lets a caller's own
generator drive a graph's: its state goes in before the replay and comes
back out after, so the caller's generator ends where an eager call leaves
it.

Counts: `ops/build.py` counts a kernel where its wrapper launches it, in
Python, which a replay does not run.  The capture records every count of
`utils/trace.py` that one call makes (kernel launches,
`parallel.mesh.COLLECTIVES`), does not count itself, and each replay adds
that record.  The warm-ups and captures are counted (``graph`` counters)
and, with tracing on, the warm-up, the capture, each replay, a program's
fill and its output copies are spans.

A warm-up, capture or replay that fails raises, naming the call: there is
no eager fallback on CUDA.  On the CPU nothing is captured; the callers run
the call itself.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import threading
import time
import weakref
from typing import Any, Callable, Dict, Hashable, Iterable, Optional, Sequence

import numpy as np
import torch

from cips3d_tpu_torch.utils import trace


@contextlib.contextmanager
def put_back(tensors: Sequence[torch.Tensor] = (),
             generators: Iterable[Optional[torch.Generator]] = ()):
    """Run the block, then give ``tensors`` their values and ``generators``
    their states from before it."""
    gens = [g for g in generators if g is not None]
    saved = [t.detach().clone() for t in tensors]
    states = [g.get_state() for g in gens]
    try:
        yield
    finally:
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)
        for g, s in zip(gens, states):
            g.set_state(s)


@contextlib.contextmanager
def driven_by(generator: Optional[torch.Generator], own: Optional[torch.Generator]):
    """Let ``generator`` drive ``own`` (a graph's registered generator) for
    the block: ``own`` takes its state, and ``generator`` takes ``own``'s
    state after the block, where an eager call drawing from ``generator``
    would have left it.  Nothing happens for a None generator."""
    if generator is None or own is None:
        yield
        return
    own.set_state(generator.get_state())
    yield
    generator.set_state(own.get_state())


_CAPTURE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def capture_stream(device) -> "torch.cuda.Stream":
    """The one side stream of ``device`` on which every `Graph` warms up and
    is captured.  The caching allocator hands a freed block only to
    allocations on the stream it was made on, so graphs that share a memory
    pool reuse each other's freed blocks only when they are captured on one
    stream; a stream a graph would make each graph's pool its own."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
    return _CAPTURE_STREAMS[index]


def fill(buf: torch.Tensor, value) -> None:
    """Copy ``value`` into the input buffer ``buf``: a tensor on ``buf``'s
    device by a device copy, anything else (a numpy array, a CPU tensor, a
    list) from host memory, staged in pinned memory first when ``buf`` lies
    on the card, so that the copy is queued asynchronously."""
    if torch.is_tensor(value) and value.device == buf.device:
        buf.copy_(value)
        return
    host = value.detach().cpu() if torch.is_tensor(value) else torch.from_numpy(
        np.ascontiguousarray(np.asarray(value, dtype=np.float32)))
    if buf.device.type == "cuda":
        buf.copy_(host.pin_memory(), non_blocking=True)
    else:
        buf.copy_(host)


class Graph:
    """``fn()`` captured into a CUDA graph on ``device``, after a warm-up on
    a side stream (``warm_up()``, by default ``fn()`` itself) with
    ``state`` (tensors the call changes in place) and ``generators`` put
    back after it.  ``outputs`` is what ``fn`` returned at the capture:
    buffers that every `replay` writes again.  ``pool`` is a
    `torch.cuda.graph_pool_handle()` shared with other graphs that never
    replay at the same time: each may then take the blocks the others freed
    (all are captured on `capture_stream`), so a caller copies a graph's
    outputs out before another graph of the pool replays.  ``label`` names
    the call in errors."""

    def __init__(self, fn: Callable[[], Any], device, label: str, *,
                 generators: Sequence[torch.Generator] = (),
                 state: Sequence[torch.Tensor] = (), pool=None,
                 warm_up: Optional[Callable[[], Any]] = None):
        dev = torch.device(device)
        self.label, self.device, self.graph, self.outputs = label, dev, None, None
        gens = [g for g in generators if g is not None]
        default = torch.cuda.default_generators[dev.index if dev.index is not None
                                                else torch.cuda.current_device()]
        side = capture_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        built = trace.counter("build")["ns"]
        t0 = time.perf_counter_ns()
        try:
            # the default generator too: a call without its own draws from it
            with trace.span("graph.warm_up"), torch.cuda.stream(side), \
                    put_back(state, gens + [default]):
                (warm_up or fn)()
        except Exception as e:
            raise RuntimeError(f"warm-up of {label} before its capture failed: {e}") from e
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        gc.collect()
        torch.cuda.empty_cache()   # the warm-up's blocks, for the graph's pool to take
        t1 = time.perf_counter_ns()

        graph = torch.cuda.CUDAGraph()
        try:
            with trace.span("graph.capture"), trace.recording() as per_replay:
                for g in gens:
                    graph.register_generator_state(g)
                with torch.cuda.graph(graph, pool=pool, stream=side):
                    outputs = fn()
        except Exception as e:
            raise RuntimeError(f"CUDA-graph capture of {label} failed: {e}") from e
        trace.count("graph", "captures")
        # a build of the kernels that ran inside the warm-up is left out
        built = trace.counter("build")["ns"] - built
        trace.count("graph", "warm_up_ns", t1 - t0 - built)
        trace.count("graph", "capture_ns", time.perf_counter_ns() - t1)
        self.per_replay = per_replay
        self.graph, self.outputs = graph, outputs

    def replay(self, k: int = 1):
        """``k`` replays; returns ``outputs``."""
        if self.graph is None:
            raise RuntimeError(f"{self.label}: the graph was released")
        try:
            with trace.span("program.replay"):
                for _ in range(k):
                    self.graph.replay()
        except Exception as e:
            raise RuntimeError(f"replay of {self.label} failed: {e}") from e
        trace.add(self.per_replay, k)
        return self.outputs

    def close(self) -> None:
        """Release the graph and its memory pool's blocks."""
        if self.graph is not None:
            self.graph.reset()
            self.graph, self.outputs = None, None
            gc.collect()
            torch.cuda.empty_cache()


def _map(fn, tree):
    """``fn`` on every tensor or array leaf of nested dicts, lists and tuples
    (named tuples keep their type); None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    out = []
    _map(out.append, tree)
    return out


def _leaf_signature(x):
    if torch.is_tensor(x):
        return tuple(x.shape), x.dtype
    return tuple(np.shape(x)), "host"


def signature(tree) -> Hashable:
    """The structure, shapes and dtypes of a tree of inputs: what a captured
    program is keyed by beside its static arguments."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return tuple((k, signature(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return tuple(signature(v) for v in tree)
    return _leaf_signature(tree)


def _buffer(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return torch.empty(tuple(x.shape), dtype=x.dtype, device=device)
    return torch.empty(np.shape(x), dtype=torch.float32, device=device)


class Program:
    """``fn(inputs, rng)`` as one program a call, on ``device``.

    ``inputs`` (nested dicts, lists and tuples of tensors, host arrays or
    None) lives in buffers shaped like the ``example``; `fill` copies a
    call's inputs into them.  ``rng`` is the program's own generator when
    ``uses_generator``, driven by the caller's (`driven_by`), else None.
    ``state`` lists the tensors ``fn`` changes in place (put back after the
    warm-up).  On CUDA the first `run` captures a `Graph` (in ``pool``) and
    every run replays it; outputs are then the graph's buffers, returned as
    copies when ``copy_out``.  On the CPU `run` calls ``fn`` itself.
    ``lock`` serialises the calls of programs that share a pool."""

    def __init__(self, fn: Callable, example, device, label: str, *,
                 uses_generator: bool = False, state: Sequence[torch.Tensor] = (),
                 pool=None, lock=None, copy_out: bool = True):
        self.fn, self.device, self.label = fn, torch.device(device), label
        self.inputs = _map(lambda x: _buffer(x, self.device), example)
        self.rng = torch.Generator(self.device) if uses_generator else None
        self.state, self.pool, self.copy_out = list(state), pool, copy_out
        self.lock = lock or threading.RLock()
        self.graph: Optional[Graph] = None

    @property
    def captured(self) -> bool:
        return self.device.type == "cuda"

    def fill(self, inputs) -> None:
        """Copy a call's ``inputs`` (the example's structure) into the
        buffers."""
        bufs, values = _leaves(self.inputs), _leaves(inputs)
        if len(bufs) != len(values):
            raise ValueError(f"{self.label}: {len(values)} inputs, the program takes "
                             f"{len(bufs)}")
        with trace.span("program.fill"):
            for b, v in zip(bufs, values):
                fill(b, v)

    def run(self, k: int = 1, generator: Optional[torch.Generator] = None):
        """``k`` calls on the buffers' inputs, drawing from ``generator``
        (through the program's own); returns the last call's outputs."""
        with self.lock, driven_by(generator, self.rng):
            if not self.captured:
                out = None
                for _ in range(k):
                    out = self.fn(self.inputs, self.rng)
                return out
            if self.graph is None:
                self.graph = Graph(lambda: self.fn(self.inputs, self.rng), self.device,
                                   self.label, generators=[self.rng], state=self.state,
                                   pool=self.pool)
            out = self.graph.replay(k)
            if not self.copy_out:
                return out
            with trace.span("program.outputs"):
                return _map(torch.clone, out)

    def __call__(self, inputs, generator: Optional[torch.Generator] = None):
        """One call: `fill` then `run`."""
        with self.lock:
            self.fill(inputs)
            return self.run(1, generator)

    def close(self) -> None:
        if self.graph is not None:
            self.graph.close()
            self.graph = None


def _bindings(model) -> list:
    return [t.data_ptr() for t in list(model.parameters()) + list(model.buffers())]


def eager(dispatch: str) -> bool:
    """Whether a caller's ``dispatch`` asks for the op-by-op call
    (``"eager"``) rather than its program (``"program"``)."""
    if dispatch not in ("program", "eager"):
        raise ValueError(f"dispatch must be 'program' or 'eager', got {dispatch!r}")
    return dispatch == "eager"


class ProgramCache:
    """The programs of one set of callers, by model and key, sharing one
    memory pool (their calls are serialised by ``lock``).  A model's
    programs go with the model (the programs hold it weakly) and are made
    again when its parameters were moved; past ``limit`` programs the
    least recently used one is released."""

    def __init__(self, limit: int = 32):
        self.limit = limit
        self.lock = threading.RLock()
        self._by_model: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self._order: "collections.OrderedDict" = collections.OrderedDict()
        self._pool = None

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def get(self, model, key: Hashable, make: Callable[[Any, Any], Program]) -> Program:
        """The program of ``model`` under ``key``, made by ``make(pool,
        lock)`` when there is none yet (``pool`` is None off CUDA)."""
        with self.lock:
            progs: Dict = self._by_model.setdefault(model, {})
            bind = _bindings(model)
            entry = progs.get(key)
            if entry is not None and entry[1] != bind:
                entry[0].close()
                entry = None
            if entry is None:
                cuda = _device_of(model).type == "cuda"
                entry = progs[key] = (make(self.pool() if cuda else None, self.lock), bind)
            tag = (id(model), key)
            self._order[tag] = weakref.ref(progs[key][0])
            self._order.move_to_end(tag)
            while len(self._order) > self.limit:
                _, ref = self._order.popitem(last=False)
                old = ref()
                if old is not None:
                    old.close()
                    for p in self._by_model.values():
                        for k in [k for k, e in p.items() if e[0] is old]:
                            del p[k]
            return entry[0]

    def close(self) -> None:
        """Release every program's graph (their pool's blocks go back to the
        allocator)."""
        with self.lock:
            for progs in list(self._by_model.values()):
                for prog, _ in progs.values():
                    prog.close()
            self._by_model = weakref.WeakKeyDictionary()
            self._order.clear()
            self._pool = None
            if torch.cuda.is_available():
                gc.collect()
                torch.cuda.empty_cache()


def program_for(model, key: Hashable, inputs, body: Callable, label: str, *,
                uses_generator: bool = False,
                programs: Optional[ProgramCache] = None) -> Program:
    """The `Program` of ``model`` (an `nn.Module`) under ``key`` for these
    ``inputs``' shapes, in ``programs`` (by default the shared `PROGRAMS`),
    made at its first call: ``body(model, inputs, rng)``, holding ``model``
    weakly so that its programs go with it."""
    ref = weakref.ref(model)

    def make(pool, lock):
        return Program(lambda x, rng: body(ref(), x, rng), inputs, _device_of(model), label,
                       uses_generator=uses_generator, pool=pool, lock=lock)

    cache = programs if programs is not None else PROGRAMS
    return cache.get(model, (key, signature(inputs), uses_generator), make)


def _device_of(model) -> torch.device:
    return next(iter(model.parameters())).device


#: The programs of callers that keep none of their own (`apps/render.py`,
#: `apps/shapes.py`), as a jitted function's executables live in JAX's
#: process-wide cache; `release` frees them.
PROGRAMS = ProgramCache()


def release() -> None:
    """Release the shared cache's programs."""
    PROGRAMS.close()
