"""The port's spans and counters (`cips3d_tpu_torch/utils/trace.py`) on the
CPU: off is a no-op; spans nest per thread under one request; a count made
while a capture records is added once per replay; the render server's,
the chunk's and the loader's records; the idle gaps put down to spans; and
the readers of the per-layer metrics that read the program's counters
(`benchmark/metrics/`)."""

import collections
import importlib.util
import os
import sys
import threading

import numpy as np
import pytest
import torch

from cips3d_tpu_torch.models.discriminator import DiscriminatorMultiScaleAux
from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR, RenderOptions
from cips3d_tpu_torch.ops import build
from cips3d_tpu_torch.parallel import mesh
from cips3d_tpu_torch.train.chunk import Metrics, make_chunk_fn
from cips3d_tpu_torch.train.state import TrainConfig
from cips3d_tpu_torch.train.step import init_train_state, make_train_step
from cips3d_tpu_torch.utils import trace

GCFG = dict(z_dim_nerf=16, z_dim_inr=32, nerf_hidden_dim=16, nerf_style_dim=16,
            nerf_mapping_layers=2, inr_hidden_dim=32, inr_style_dim=32, inr_mapping_layers=2)
BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")


@pytest.fixture
def traced():
    """Tracing on for the test, its records drained after."""
    trace.drain()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.drain()


def test_off_is_a_no_op():
    trace.disable()
    trace.drain()
    assert trace.span("a") is trace.span("b", x=1) is trace.phase("step.d")
    with trace.span("a"), trace.phase("step.d"), trace.stamps("cpu") as st:
        pass
    trace.add_phases(["step.d"], [[1, 2]])
    assert trace.drain() == [] and st.tensor() is None


def test_spans_nest_per_thread_under_one_request(traced):
    def work(tag):
        with trace.span("root", tag=tag):
            with trace.span("child"):
                with trace.span("leaf"):
                    pass
            with trace.span("child"):
                pass

    threads = [threading.Thread(target=work, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    recs = trace.drain()
    roots = [r for r in recs if r["name"] == "root"]
    assert len(recs) == 12 and sorted(r["tag"] for r in roots) == [0, 1, 2]
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        if r["name"] == "root":
            assert r["parent"] is None and r["request"] == r["id"]
            continue
        parent = by_id[r["parent"]]
        assert parent["name"] == {"child": "root", "leaf": "child"}[r["name"]]
        assert r["request"] == parent["request"] and r["thread"] == parent["thread"]
        assert parent["start"] <= r["start"] <= r["end"] <= parent["end"]
    assert len({r["request"] for r in roots}) == 3


def test_a_count_made_while_recording_is_added_once_per_replay():
    """`utils/graphs.py::Graph` records the counts of its capture and adds
    them on each replay: the capturing thread's counts go to the record,
    another thread's to the counters."""
    before = dict(build.LAUNCHES), collections.Counter(mesh.COLLECTIVES)
    with trace.recording() as per_replay:
        build.count_launch("inr_tile", torch.float32)
        trace.count("collectives", "all_reduce", 2)
        other = threading.Thread(target=build.count_launch, args=("ray_tile", "float32"))
        other.start()
        other.join(timeout=30)
    key = ("ray_tile", "float32")
    assert build.LAUNCHES.get(key, 0) == before[0].get(key, 0) + 1
    assert mesh.COLLECTIVES == before[1]
    trace.add(per_replay, 3)
    assert build.launches("inr_tile") == sum(
        n for (k, _), n in before[0].items() if k == "inr_tile") + 3
    assert mesh.COLLECTIVES["all_reduce"] == before[1]["all_reduce"] + 6


def test_render_service_records_each_request(traced):
    from cips3d_tpu_torch.apps.serve import RenderService

    gen = GeneratorNerfINR(GeneratorConfig(**GCFG, fused_ray=True, fused_inr=True,
                                           fast_sin=True),
                           generator=torch.Generator().manual_seed(0)).eval()
    service = RenderService(gen, img_size=8, num_steps=3, forward_points=32)
    styles = trace.counter("serve.styles")
    hit, miss = styles["hit"], styles["miss"]
    seeds = [1, 2, 1, 3, 2]
    for i, s in enumerate(seeds):
        service.frame(seed=s, depth=i == 1)
    assert styles["miss"] - miss == len(set(seeds))
    assert styles["hit"] - hit == len(seeds) - len(set(seeds))
    recs = trace.drain()
    roots = [r for r in recs if r["name"] == "serve.request"]
    assert [r["depth"] for r in roots] == [i == 1 for i in range(len(seeds))]
    for root in roots:
        mine = {r["name"]: r for r in recs if r["request"] == root["id"]}
        assert set(mine) == {"serve.request", "serve.lock_wait", "serve.locked", "serve.styles",
                             "program.fill", "serve.readback", "serve.uint8"}
        assert mine["serve.styles"]["parent"] == mine["serve.locked"]["id"]
        assert mine["program.fill"]["parent"] == mine["serve.locked"]["id"]
        assert (mine["serve.lock_wait"]["end"] <= mine["serve.locked"]["start"]
                < mine["serve.locked"]["end"] <= mine["serve.readback"]["start"])


def test_eager_chunk_step_gives_its_phases_in_order(traced):
    gen = GeneratorNerfINR(GeneratorConfig(**GCFG, fast_sin=True),
                           generator=torch.Generator().manual_seed(0))
    disc = DiscriminatorMultiScaleAux(max_size=16,
                                      channels_override={r: 16 for r in (4, 8, 16)},
                                      generator=torch.Generator().manual_seed(1))
    cfg = TrainConfig(img_size=8, batch_size=2, grad_points=2)
    state = init_train_state(gen, disc, cfg)
    step_fn = make_train_step(gen, disc, cfg, RenderOptions(num_steps=4), aux_reg=True)
    reals = [np.full((2, 3, 8, 8), 128, np.uint8)] * 2
    chunk = make_chunk_fn(step_fn, state, reals[0].shape, torch.Generator().manual_seed(2))
    rows = chunk(reals).read()
    assert len(rows) == 2
    recs = trace.drain()
    dispatch = [r for r in recs if r["name"] == "chunk.dispatch"]
    phases = sorted((r for r in recs if r.get("step") is not None), key=lambda r: r["start"])
    assert len(dispatch) == 1 and len(phases) == 10
    for j in range(2):
        mine = phases[5 * j:5 * j + 5]
        assert [r["name"] for r in mine] == ["step.d_gen", "step.d", "step.update", "step.g",
                                             "step.update"]
        assert len({r["step"] for r in mine}) == 1
        assert all(r["parent"] == dispatch[0]["id"] for r in mine)
    assert phases[0]["step"] != phases[5]["step"]


def test_metrics_record_the_device_stamps_of_each_step(traced):
    rows = torch.tensor([[1.0], [2.0]])
    stamps = torch.tensor([[10, 15, 15, 40], [100, 103, 103, 110]])
    got = Metrics(["d_loss"], rows, ["step.d_gen", "step.d"], stamps).read()
    assert [m["d_loss"] for m in got] == [1.0, 2.0]
    recs = trace.drain()
    assert [(r["name"], r["end"] - r["start"]) for r in recs] == [
        ("step.d_gen", 5), ("step.d", 25), ("step.d_gen", 3), ("step.d", 7)]
    assert recs[0]["step"] == recs[1]["step"] != recs[2]["step"]
    assert all(r["clock"] == "device" for r in recs)


def test_loader_records_its_waits(traced, tmp_path):
    from cips3d_tpu_torch.data.synthetic import make_blob_dataset
    from cips3d_tpu_torch.data.zip_dataset import DataLoader, ZipImageDataset

    path = make_blob_dataset(str(tmp_path / "d.zip"), 4, img_size=8, seed=1)
    loader = DataLoader(ZipImageDataset(path), batch_size=2, num_workers=1)
    try:
        for _ in range(3):
            assert next(loader)[0].shape == (2, 3, 8, 8)
    finally:
        loader.close()
    waits = [r for r in trace.drain() if r["name"] == "data.wait"]
    assert len(waits) == 3 and all(r["end"] >= r["start"] for r in waits)


@pytest.mark.parametrize("ops,launches,want", [
    # a gap ends at an op launched by thread 1: the innermost span open at its midpoint
    ([(0, 10, 1), (20, 30, 2), (30, 40, 3), (50, 60, 4)], {2: 1, 4: 1},
     [["inner", 10e-9], ["outer", 10e-9]]),
    # the op's launch is not in the trace, or its thread had no span open
    ([(0, 10, 1), (20, 30, 2), (40, 50, 3)], {3: 2},
     [["untraced", 20e-9]]),
], ids=["innermost", "untraced"])
def test_idle_gaps_go_to_the_launching_threads_innermost_span(ops, launches, want):
    spans = [("outer", 0, 100, 1), ("inner", 12, 18, 1), ("other", 0, 100, 3),
             ("later", 60, 70, 2)]
    got = trace.idle_by_span(ops, launches, spans)
    assert [n for n, _ in got] == [n for n, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want])


class _Event:
    """A kineto event as `trace.profile_idle` reads it."""

    def __init__(self, name, cuda, start, dur, corr=0, thread=0):
        self._v = (name, cuda, start, dur, corr, thread)

    def name(self):
        return self._v[0]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[1] else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def device_resource_id(self):
        return self._v[5]


def test_profile_idle_reads_a_profilers_events():
    """Spans are the host events of the records' names (their device-side
    copies are no device operation); launches are the runtime's calls."""
    events = [_Event("serve.locked", False, 0, 100, thread=7),
              _Event("serve.locked", True, 0, 100),   # the span's device-side copy
              _Event("cudaGraphLaunch", False, 1, 2, corr=5, thread=7),
              _Event("aten::mm", False, 1, 2, corr=6, thread=9),
              _Event("gemv", True, 0, 10, corr=4), _Event("gemv", True, 30, 10, corr=5),
              _Event("gemv", True, 50, 10, corr=6)]
    got = trace.profile_idle(events, {"serve.locked"})
    assert [n for n, _ in got] == ["serve.locked", "untraced"]
    np.testing.assert_allclose([s for _, s in got], [20e-9, 10e-9])


# ---------------------------------------------------------------- the metrics' readers

COUNTS = {"graph": collections.Counter(captures=1, warm_up_ns=3 * 10 ** 9,
                                       capture_ns=5 * 10 ** 8)}
READERS = {"capture_s.serve": 3.5, "capture_s.train": 3.5}


@pytest.fixture
def reader(monkeypatch):
    """A metric's reader loaded from ``benchmark/metrics/``, as the
    harness loads it."""
    monkeypatch.syspath_prepend(BENCH)
    loaded = []

    def load(name):
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + name.replace(".", "_"), os.path.join(BENCH, "metrics",
                                                                   name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        loaded.append(mod)
        return mod

    yield load
    for name in [m for m in sys.modules if m == "work" or m.startswith("work.")]:
        monkeypatch.delitem(sys.modules, name)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_on_a_made_up_ctx(name, reader, monkeypatch):
    read = reader(name).read
    monkeypatch.setattr(trace, "COUNTERS", collections.defaultdict(collections.Counter, COUNTS))
    assert read({}) == pytest.approx(READERS[name])
    monkeypatch.setattr(trace, "COUNTERS", collections.defaultdict(collections.Counter))
    assert read({}) is None
