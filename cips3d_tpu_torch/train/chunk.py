"""Several training steps a dispatch: counterpart of the JAX loop's
`get_chunk_fn` (`cips3d_tpu/train/loop.py:384-401`) and of `bench.py`'s
K-step scan.

JAX runs a chunk of K steps as one ``lax.scan`` in one executable and reads
its metrics once.  On the card a chunk is K replays of one captured step:
`make_chunk_fn` records one call of the step into a `torch.cuda.CUDAGraph`
and replays it for each of the chunk's batches, so the host launches one
graph a step instead of the step's thousands of operations.  This works
because the step keeps everything it changes in place and on the device
(`train/state.py`: the counter, Adam's step count; the schedules, the EMA
gate and the density noise are computed from the counter there) and draws
from a `torch.Generator` registered with the graph, whose offset each replay
advances as an eager step would.

Before the capture the step runs once eagerly on a side stream (the warm-up:
kernels built, cuDNN's plans made, the optimizers' and the helpers' device
tensors allocated), and the state and the generator are then put back as
they were, so that K replays give the K eager steps from the same state and
draws.  Each step of a chunk copies its uint8 batch from pinned host memory
into the graph's input buffer, replays, and copies the step's metrics into
row j of a [K, n] buffer; `Metrics` brings the rows to the host behind an
event, so the loop reads chunk N's while chunk N + 1 runs, as the JAX loop
reads its metrics one dispatch late.

On the CPU, and in a gloo process group (its collectives go through host
memory and cannot be captured), a chunk is the K eager steps with no host
read between them.  On CUDA without a group, or with NCCL (whose
all-reduces are captured with the step), a capture or replay that fails
raises, naming the step variant: there is no eager fallback.

Launch counts are counted through the replays: the capture records what one
step launches (kernels and `parallel.mesh.COLLECTIVES`) and each replay adds
that record.  The warm-up, the capture and the counts are the shared core of
`utils/graphs.py`, which the render side uses too.

With tracing on (`utils/trace.py`) a chunk's dispatch is a span
(``chunk.dispatch``, holding the batches' staging ``chunk.stage`` and the
replays), and each step runs inside `trace.stamps`: on the card the step's
phases (`train/step.py`) stamp the device's clock, a step captured so
stamps in every replay, and the stamps come to the host with the metrics
(`Metrics.read` records them).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from cips3d_tpu_torch.train.state import init_opt_state
from cips3d_tpu_torch.utils import trace
from cips3d_tpu_torch.utils.graphs import Graph, put_back


class Metrics:
    """The metric rows ([k, n] float32, one row a step) of k steps, on their
    way to the host: on CUDA a copy into pinned memory behind an event, so
    that `read` waits for these steps and nothing queued after them.
    ``ready_at`` (`time.time()`) is when they were known done: made on the
    CPU, or the event's wait in `read` on CUDA.  ``stamps`` ([k, 2m] int64,
    the device clock's stamps of the m ``phases`` of each step) come along
    and are recorded by `read` (`trace.add_phases`)."""

    def __init__(self, names: Sequence[str], rows: torch.Tensor,
                 phases: Sequence[str] = (), stamps: Optional[torch.Tensor] = None):
        self.names, self.phases = list(names), list(phases)
        self._host, self._stamps, self._event = rows, stamps, None
        self.ready_at = time.time()
        if rows.is_cuda:
            self._host = _to_host(rows)
            self._stamps = None if stamps is None else _to_host(stamps)
            self._event = torch.cuda.Event()
            self._event.record()

    @classmethod
    def of_step(cls, metrics: Dict[str, torch.Tensor]) -> "Metrics":
        """The one row of a step's metrics (0-d tensors)."""
        return cls(list(metrics), _row(metrics)[None])

    def read(self) -> List[Dict[str, float]]:
        """One {name: float} a step."""
        if self._event is not None:
            self._event.synchronize()
            self.ready_at, self._event = time.time(), None
        if self._stamps is not None:
            trace.add_phases(self.phases, self._stamps.tolist())
            self._stamps = None
        return [dict(zip(self.names, row)) for row in self._host.tolist()]


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _row(metrics: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.stack([torch.as_tensor(v).float().reshape(()) for v in metrics.values()])


def state_tensors(state) -> List[torch.Tensor]:
    """Every tensor a step reads or writes in place: the parameters and
    buffers of the state's modules, its optimizers' state, its device
    counter (a deterministic order)."""
    out, seen = [], set()

    def add(t):
        if torch.is_tensor(t) and id(t) not in seen:
            seen.add(id(t))
            out.append(t)

    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, nn.Module):
            for t in list(v.parameters()) + list(v.buffers()):
                add(t)
        elif isinstance(v, torch.optim.Optimizer):
            for st in v.state.values():
                for t in st.values():
                    add(t)
        else:
            add(v)
    return out


def _optimizers(state) -> List[torch.optim.Optimizer]:
    return [getattr(state, f.name) for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), torch.optim.Optimizer)]


def _host_step(state, n: int) -> None:
    """The host mirror of the counter only (replays advanced the device's)."""
    object.__setattr__(state, "step", n)


def _stage(reals) -> torch.Tensor:
    """The chunk's batches (uint8 arrays or CPU tensors) in one stack."""
    return torch.from_numpy(np.stack([np.asarray(r) for r in reals]))


def warm_up(step_fn: Callable, state, real: torch.Tensor,
            rng: Optional[torch.Generator]) -> None:
    """Run one step of ``step_fn`` on ``real``, then put the state and
    ``rng`` back as they were: whatever a step makes at its first call
    (kernels, plans, the optimizers' state, cached device tensors) exists
    afterwards, and nothing has trained."""
    for opt in _optimizers(state):
        init_opt_state(opt)
    host_step = state.step
    with put_back(state_tensors(state), [rng]):
        step_fn(state, real, rng=rng)
    _host_step(state, host_step)


class EagerChunk:
    """K eager steps, their metrics stacked on the device and read once."""

    captured = False

    def __init__(self, step_fn: Callable, state, rng: Optional[torch.Generator]):
        self.step_fn, self.state, self.rng = step_fn, state, rng
        self.device = state.step_t.device

    def __call__(self, reals, draws: Optional[Sequence] = None) -> Metrics:
        rows, names, stamps = [], None, []
        with trace.span("chunk.dispatch"):
            for j, real in enumerate(reals):
                real = real if torch.is_tensor(real) else torch.from_numpy(np.asarray(real))
                with trace.stamps(self.device) as st:
                    _, m = self.step_fn(self.state, real.to(self.device),
                                        draws=draws[j] if draws is not None else None,
                                        rng=self.rng)
                names = names or list(m)
                rows.append(_row(m))
                stamps.append(st.tensor())
            stamps = torch.stack(stamps) if stamps[0] is not None else None
            return Metrics(names, torch.stack(rows), st.names, stamps)

    def close(self) -> None:
        pass


class GraphChunk:
    """One step captured into a CUDA graph, replayed once a batch."""

    captured = True

    def __init__(self, step_fn: Callable, state, real_shape, rng: torch.Generator,
                 label: str = ""):
        if rng is None:
            raise ValueError("a captured step draws from a torch.Generator: pass rng")
        self.step_fn, self.state, self.rng = step_fn, state, rng
        self.label = label or "training step"
        self.device = state.step_t.device
        self.static_real = torch.zeros(tuple(real_shape), dtype=torch.uint8, device=self.device)
        self.graph = None
        self.capture()

    def capture(self) -> None:
        """Warm up on a side stream, put the state back, capture one step."""
        self.close()
        state = self.state
        host_step = state.step

        def step():
            with trace.stamps(self.device) as st:
                _, m = self.step_fn(state, self.static_real, rng=self.rng)
            names[:] = list(m)
            phases[:] = st.names
            return _row(m), st.tensor()

        def warm():
            with trace.stamps(self.device):   # the warm-up's stamps are dropped
                warm_up(self.step_fn, state, self.static_real, self.rng)

        names, phases = [], []
        try:
            self.graph = Graph(step, self.device, self.label, generators=[self.rng],
                               warm_up=warm)
        finally:
            _host_step(state, host_step)
        self.names, self.phases = names, phases
        self.static_out = self.graph.outputs
        self.bindings = [t.data_ptr() for t in state_tensors(state)]

    def __call__(self, reals, draws: Optional[Sequence] = None) -> Metrics:
        if draws is not None:
            raise ValueError("a captured chunk draws from its generator; draws cannot be given")
        if self.graph is None or self.bindings != [t.data_ptr()
                                                   for t in state_tensors(self.state)]:
            self.capture()   # a parameter or an optimizer tensor was rebound since
        with trace.span("chunk.dispatch"):
            with trace.span("chunk.stage"):
                staged = _stage(reals).pin_memory()
            if tuple(staged.shape[1:]) != tuple(self.static_real.shape):
                raise ValueError(f"batches of {tuple(staged.shape[1:])}, the graph takes "
                                 f"{tuple(self.static_real.shape)}")
            k = staged.shape[0]
            row, stamp = self.static_out
            rows = torch.empty((k, row.numel()), dtype=torch.float32, device=self.device)
            stamps = None if stamp is None else torch.empty((k, stamp.numel()),
                                                            dtype=stamp.dtype,
                                                            device=self.device)
            for j in range(k):
                self.static_real.copy_(staged[j], non_blocking=True)
                self.graph.replay()
                rows[j].copy_(row)
                if stamps is not None:
                    stamps[j].copy_(stamp)
            _host_step(self.state, self.state.step + k)
            return Metrics(self.names, rows, self.phases, stamps)

    def close(self) -> None:
        """Release the graph and its memory pool."""
        if self.graph is not None:
            self.graph.close()
            self.graph, self.static_out = None, None


def make_chunk_fn(step_fn: Callable, state, real_shape, rng: Optional[torch.Generator],
                  mesh=None, label: str = ""):
    """``run(reals) -> Metrics``: one step of ``step_fn`` per uint8 batch of
    ``real_shape`` (the rank's rows under ``mesh``), the metrics read once.
    Captured on CUDA (alone or in an NCCL group), eager on the CPU and in a
    gloo group (the module docstring).  ``run`` also takes ``draws``, one
    per batch, on the eager path.  ``label`` names the step variant in
    errors."""
    if state.step_t.device.type == "cuda":
        import torch.distributed as dist

        if mesh is None or dist.get_backend(mesh.data_group) == "nccl":
            return GraphChunk(step_fn, state, real_shape, rng, label)
    return EagerChunk(step_fn, state, rng)
