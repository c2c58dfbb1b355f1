"""The data-parallel training cells: one process a card in one process
group (NCCL on the cards, gloo on the CPU), each rank the program's step
with a `parallel/mesh.py` mesh, captured into its chunk with the step's
gradient all-reduces, fed by its own shard of the loader, as the training
CLI's ranks run a stage (`train/loop.py`, `bench/multi_card.py`'s start).

The process that runs the benchmark starts the ranks, waits for them, and
then, with every card free again, runs the reference on the first card:
the global batch's first steps (every rank's first batches, in rank order),
drawing each phase's draws up front as the ranks do.  The numbers compared
are those of `drivers/train.py`, from rank 0's state: the ranks' all-reduced
gradients are the reference's global ones only if the exchange between the
cards took place.

Each rank also reports the modules of jax, jaxlib, flax or the JAX package
that its process holds once the window has closed; the run prints no
result if any rank names one.

The ranks agree on the end of the window: before each chunk they take the
minimum of their "deadline not reached" flags in one small all-reduce, so
that every rank runs the same steps.  The rate counts every rank's images.

    python benchmark/drivers/train_ranks.py JOB RANK     # one rank (started by `run`)
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Callable, Optional

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import harness  # noqa: E402


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _import(spec: Optional[str]) -> Optional[Callable]:
    """``module:function`` -> the function (a fault the tests plant)."""
    if not spec:
        return None
    import importlib

    mod, fn = spec.split(":")
    return getattr(importlib.import_module(mod), fn)


def rank_main(job_path: str, rank: int) -> int:
    """One rank: set-up, first steps, the window; its readings to the job's
    directory as ``rank<r>.json`` (and its first batches and the generator
    state as ``.npy``)."""
    t_start = time.perf_counter()
    import torch
    import torch.distributed as dist

    from cips3d_tpu_torch.parallel.mesh import initialize_multihost, make_mesh
    from drivers.train import Program

    with open(job_path) as f:
        job = json.load(f)
    out = os.path.dirname(job_path)
    c = harness.Cell(**job["cell"])
    cuda = job["device"] == "cuda"
    for p in job.get("sys_path", []):
        if p not in sys.path:
            sys.path.insert(0, p)
    harness.set_precision(torch, c.config)
    initialize_multihost(f"127.0.0.1:{job['port']}", job["world"], rank,
                         device="cuda" if cuda else "cpu")
    dev = torch.device(f"cuda:{rank % torch.cuda.device_count()}" if cuda else "cpu")
    mesh = make_mesh(1)
    fault = _import(job.get("fault"))
    if fault is not None and getattr(fault, "patches_module", False):
        fault()
        fault = None
    p = Program(c, job["seed"], dev, job.get("sizes"), job.get("control"), fault, mesh)
    try:
        prog = p.first_steps()
        if cuda:
            torch.cuda.synchronize(dev)
        flag = torch.zeros((), dtype=torch.int32, device=dev)

        def agree(go: bool) -> bool:
            flag.fill_(int(go))
            dist.all_reduce(flag, op=dist.ReduceOp.MIN)
            return bool(flag.item())

        dist.barrier()
        setup_done = time.time()
        w = p.window(job["seconds"], int(c.traffic["profile_chunks"])
                     if job["trace"] and cuda else 0, agree)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        dist.barrier()
    finally:
        p.close()
    np.save(os.path.join(out, f"first{rank}.npy"), np.stack(p.first))
    if rank == 0:
        np.save(os.path.join(out, "rng_start.npy"), prog["rng_start"].numpy())
    res = {"rows": prog["rows"], "grad1": prog["grad1"].tolist(),
           "delta": prog["delta"].tolist(), "setup_done": setup_done,
           "setup_s": time.perf_counter() - t_start, "peak": peak,
           "names": prog["names"], "loaded": harness.forbidden_modules(),
           "window": {k: w[k] for k in ("attempted", "done", "failed", "wait", "window_s")},
           "profile": w["profile"]}
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    return 0


def run(c: harness.Cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, control: Optional[str] = None, sizes: Optional[dict] = None,
        fault: Optional[str] = None) -> harness.Run:
    import dataclasses

    import torch

    from drivers.train import reference_check, settings

    cuda = device == "cuda"
    world = int((sizes or {}).get("ranks", c.chips))
    harness.set_precision(torch, c.config)
    if cuda:
        harness.log(f"cards: {harness.power_limit()}; precision flags: "
                    f"{harness.precision_flags(torch)}; control {control}")
    job_dir = tempfile.mkdtemp(prefix="bench_ranks_")
    wall_start = time.time() - (time.perf_counter() - t_start)
    job = {"cell": dataclasses.asdict(c), "seed": seed, "seconds": seconds, "trace": trace,
           "device": device, "control": control, "sizes": sizes, "fault": fault,
           "port": _free_port(), "world": world,
           "sys_path": [q for q in sys.path if q.startswith(ROOT)]}
    job_path = os.path.join(job_dir, "job.json")
    with open(job_path, "w") as f:
        json.dump(job, f)
    env = dict(os.environ, USE_FLAX="0")
    if not cuda:   # an even share of the CPU a rank
        env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 2) // (2 * world)))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), job_path, str(r)],
                              env=env, cwd=ROOT, stdout=sys.stderr.fileno())
             for r in range(world)]
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs):
        raise RuntimeError(f"ranks exited with {rcs}")
    ranks = []
    for r in range(world):
        with open(os.path.join(job_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    firsts = [np.load(os.path.join(job_dir, f"first{r}.npy")) for r in range(world)]
    rng_start = torch.from_numpy(np.load(os.path.join(job_dir, "rng_start.npy")))
    shutil.rmtree(job_dir, ignore_errors=True)

    w = [r["window"] for r in ranks]
    done, window_s = w[0]["done"], max(x["window_s"] for x in w)
    batch = int(c.traffic["batch_size"])
    setup_s = max(r["setup_done"] for r in ranks) - wall_start
    values = {"train_imgs_per_s": done * batch * world / window_s, "setup_s": setup_s}
    peak = max(r["peak"] for r in ranks)
    device_rec = {"platform": "cpu", "kind": "cpu", "count": world, "memory_peak_bytes": 0}
    if cuda:
        values["peak_mem_gib"] = peak / 2 ** 30
        device_rec = dict(harness.card_record(torch, world), memory_peak_bytes=peak)
    harness.log(f"window {window_s:.3f} s: {done} steps a rank on {world} ranks, "
                f"{values['train_imgs_per_s']:.3f} images/s")

    # the reference on the first card, every rank's process gone
    dev = torch.device("cuda:0" if cuda else "cpu")

    s = settings(c, seed, sizes, world)
    reals = [np.concatenate([f[i] for f in firsts]) for i in range(firsts[0].shape[0])]
    prog = {"rows": ranks[0]["rows"], "rng_start": rng_start, "names": ranks[0]["names"],
            "grad1": np.array(ranks[0]["grad1"]), "delta": np.array(ranks[0]["delta"])}
    checks, flops = reference_check(s, dev, reals, prog, trace and cuda, draws_up_front=True)
    other = max(float(np.max(np.abs(np.array(r["delta"]) - prog["delta"])
                         / np.maximum(prog["delta"], 1e-30))) for r in ranks)
    harness.log(f"ranks' parameter changes against rank 0's: widest relative gap {other:.3g}")

    breakdown = None
    if trace and cuda:
        readers = {m["name"]: harness.metric_reader(m["name"]) for m in c.per_layer}
        profs = [r["profile"] for r in ranks if r["profile"]]
        prof = None
        if profs:
            prof = {k: float(np.mean([q[k] for q in profs]))
                    for k in ("busy_s", "window_s", "held_s")}
            device_rec.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
            breakdown = {k: profs[0][k] for k in ("device_ops", "idle_gaps")}
        # each card's share of the global step's products, over one card's peak, of the
        # steps outside the profiler's hold, under which they run slower
        slice_steps = int(c.traffic["profile_chunks"]) * int(c.traffic["dispatch_chunk"])
        slice_s = prof["held_s"] if prof else 0.0
        ctx = {"window_s": window_s - slice_s, "units": done - (slice_steps if prof else 0),
               "data_wait_s": w[0]["wait"], "data_window_s": w[0]["window_s"],
               "profile": prof, "calls": {}, "config": {"generator": s.gen},
               "flops_per_unit": flops / world if flops else None}
        per_layer = {n: r.read(ctx) for n, r in readers.items()
                     if not getattr(r, "ENTRIES", None)}
        values.update({k: v for k, v in per_layer.items() if v is not None})
        harness.log(f"per-layer ({harness.power_limit()}; products at 495 TFLOP/s, bytes at "
                    f"3.35 TB/s): {per_layer}; global step products {flops} FLOP")
    attempted = sum(x["attempted"] for x in w)
    failed = sum(x["failed"] for x in w)
    loaded = sorted({m for r in ranks for m in r["loaded"]})
    return harness.Run(attempted, failed, values, device_rec, checks, breakdown, loaded)



if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1], int(sys.argv[2])))
