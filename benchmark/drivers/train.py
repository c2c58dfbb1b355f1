"""The training cells: the program's captured chunk of training steps
(`train/chunk.py::make_chunk_fn` over `train/step.py::make_train_step`),
fed by its zip dataset and loader, as `train/loop.py` runs a stage.

Set-up writes the seeded image zip into ``TMPDIR``, makes the weights on
the device from the seed (`reference/` initialisation, loaded into the
program's modules), builds the step and its chunk (the program's warm-up
step and capture), then runs the first ``check_steps`` steps through the
same chunk: one step alone, then the rest as one chunk.  The counter starts
at the step before ``ema_start_itr``, where the stage spends most of its
steps, so that the later checked steps (and the window) run G's EMA.
The window then dispatches chunks of ``dispatch_chunk`` steps and reads
each chunk's metrics one dispatch late, until ``--seconds`` have passed.

Correctness: once the window has closed and the program's state is freed,
`reference/step.py` runs the same first steps from the same weights,
batches and generator state, with TF32 off.  The numbers, each compared
with its limit where ``limits/<cell>.json`` names one:
  first_d_loss_gap  the relative gap of step 1's D loss, which no update
                    has touched yet (G's forward through the kernels, D
                    with R1 and DiffAug);
  d_grad_gap        the widest gap of a D leaf's first gradient norm (Adam's
                    first moment after step 1, beta1 = 0), over the larger
                    of that leaf's reference norm and the median D leaf's;
  d_grad_median_gap the median of those gaps over the D leaves the step
                    reaches;
  loss_gap          the widest relative gap of the D and G losses over the
                    steps;
  grad_gap          the same as d_grad_gap over every leaf of G and D (G's
                    gradient comes after D's first update);
  change_gap        the same of each leaf's change over the first steps (G,
                    D and G's EMA, each over its own leaves' scale), leaving
                    out leaves whose reference gradient is under a
                    thousandth of the median leaf's;
  change_median_gap the median of those gaps over the G and D leaves kept;
  ema_change_median_gap  the median of those gaps over the EMA's leaves (an
                    EMA left unchanged reads 1).
The median is over the leaves the reference step reaches (a non-zero
gradient): the aux discriminator, and the heads of other resolutions, get
none.  Every number is printed.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

import data
import harness



def _norms(tensors) -> np.ndarray:
    return np.array([t.detach().double().norm().item() for t in tensors])


def _median(norms: np.ndarray) -> float:
    """The median of the norms of the leaves the step reaches (non-zero)."""
    reached = norms[norms > 0]
    return float(np.median(reached)) if reached.size else 0.0


def _gaps(prog: np.ndarray, ref: np.ndarray, keep: np.ndarray, scale_of: np.ndarray):
    """Each kept leaf's |prog - ref| over max(ref of that leaf, the median of
    ``scale_of``); left-out leaves read 0."""
    scale = np.maximum(ref, max(_median(scale_of), 1e-30))
    return np.where(keep, np.abs(prog - ref) / scale, 0.0)


@dataclasses.dataclass
class Settings:
    """What both sides of a training cell are built from, and all that the
    reference's check reads of the program's side."""

    c: harness.Cell
    seed: int
    gen: dict
    disc: dict
    render: dict
    img: int
    tcfg: Any            # the program's TrainConfig at the global batch
    aux_reg: bool
    start_step: int      # the counter at the first checked step


def settings(c: harness.Cell, seed: int, sizes: Optional[dict] = None,
             world: int = 1) -> Settings:
    """The cell's generator, discriminator and render settings, image size
    and training settings at the global batch of ``world`` ranks; ``sizes``
    overrides keys of each (the CPU tests' tiny widths)."""
    from cips3d_tpu_torch.train.state import TrainConfig

    cfg, tr, sizes = c.config, c.traffic, sizes or {}
    gen = {**cfg["generator"], **tr.get("generator", {}), **sizes.get("generator", {})}
    disc = {**cfg["discriminator"], **tr.get("discriminator", {}),
            **sizes.get("discriminator", {})}
    render = {**cfg["render"], **sizes.get("render", {})}
    img = int(sizes.get("img_size", tr["img_size"]))
    tcfg = TrainConfig(img_size=img, batch_size=int(tr["batch_size"]) * world, **tr["train"])
    return Settings(c, seed, gen, disc, render, img, tcfg,
                    aux_reg=bool(tcfg.train_aux_img and tcfg.update_aux_every == 1),
                    start_step=max(0, tcfg.ema_start_itr - 1))


class Program:
    """The program's side of one process: its modules with the seeded
    weights, its step and chunk (``mesh`` for one rank of several), its
    loader over the seeded zip (the rank's shard)."""

    def __init__(self, c: harness.Cell, seed: int, device, sizes: Optional[dict] = None,
                 control: Optional[str] = None, fault: Optional[Callable] = None, mesh=None):
        import torch

        from cips3d_tpu_torch.data.zip_dataset import DataLoader, ZipImageDataset
        from cips3d_tpu_torch.models.discriminator import DiscriminatorMultiScaleAux
        from cips3d_tpu_torch.models.generator import (GeneratorConfig, GeneratorNerfINR,
                                                       RenderOptions)
        from cips3d_tpu_torch.train.chunk import make_chunk_fn
        from cips3d_tpu_torch.train.step import init_train_state, make_train_step

        self.dev = torch.device(device)
        tr = c.traffic
        self.s = s = settings(c, seed, sizes)
        self.batch, self.k_chunk = int(tr["batch_size"]), int(tr["dispatch_chunk"])
        self.world, self.rank = (mesh.world, mesh.rank) if mesh is not None else (1, 0)
        dtype = torch.bfloat16 if control == "bf16" else torch.float32
        self.tmp = tempfile.mkdtemp(prefix="bench_train_")
        self.loader = None
        zip_path = data.write_zip(os.path.join(self.tmp, "images.zip"), seed + 3,
                                  int(tr["num_images"]), s.img)
        with torch.no_grad():
            ref_G, ref_D = reference_modules(s, self.dev)
            with torch.device(self.dev):
                G = GeneratorNerfINR(GeneratorConfig(**s.gen), dtype=dtype)
                D = DiscriminatorMultiScaleAux(**s.disc, dtype=dtype)
            harness.load_weights(G, ref_G.state_dict())
            harness.load_weights(D, ref_D.state_dict())
            del ref_G, ref_D
        self.G, self.D = G, D
        self.state = init_train_state(G, D, s.tcfg)
        self.state.step = s.start_step
        opts = RenderOptions(img_size=s.img, **s.render)
        step_fn = make_train_step(G, D, s.tcfg, opts, aux_reg=s.aux_reg,
                                  d_regularize=True, mesh=mesh)
        self.step_fn = fault(step_fn) if fault is not None else step_fn
        dataset = ZipImageDataset(zip_path, resize_resolution=s.img, xflip=bool(tr["xflip"]))
        self.loader = DataLoader(dataset, batch_size=self.batch, seed=seed + 2,
                                 shard_index=self.rank, num_shards=self.world,
                                 num_workers=int(tr["num_workers"]))
        self.rng = torch.Generator(self.dev).manual_seed(seed + 4)
        self.first = [next(self.loader)[0] for _ in range(int(tr["check_steps"]))]
        self.chunk = make_chunk_fn(self.step_fn, self.state, self.first[0].shape, self.rng, mesh,
                                   label=f"the step (aux_reg={s.aux_reg}, d_regularize=True)")
        self.names = (["G." + n for n, _ in G.named_parameters()],
                      ["D." + n for n, _ in D.named_parameters()])

    def first_steps(self) -> dict:
        """The first steps through the chunk: one alone, then the rest as one
        chunk.  Returns their metric rows, the generator state they started
        from, each leaf's first gradient norm, each leaf's change and the
        leaves' names."""
        state = self.state
        g_params, d_params = list(self.G.parameters()), list(self.D.parameters())
        leaves = g_params + d_params + list(state.ema.parameters())
        rng_start = self.rng.get_state().clone()
        p0 = [p.detach().to("cpu", copy=True) for p in leaves]
        rows = self.chunk(self.first[:1]).read()
        grad1 = _norms([state.g_opt.state[p]["exp_avg"] for p in g_params]
                       + [state.d_opt.state[p]["exp_avg"] for p in d_params])
        rows += self.chunk(self.first[1:]).read()
        delta = np.array([(p.detach().cpu() - q).double().norm().item()
                          for p, q in zip(leaves, p0)])
        return {"rows": rows, "rng_start": rng_start, "grad1": grad1, "delta": delta,
                "names": self.names}

    def window(self, seconds: float, profile_chunks: int = 0,
               agree: Optional[Callable[[bool], bool]] = None) -> dict:
        """Chunks of ``k_chunk`` steps, each chunk's metrics read one dispatch
        late, until ``seconds`` have passed (``agree`` makes every rank take
        the same decision); ``profile_chunks`` chunks profiled after the
        second.  Counts, times and the profile."""
        import torch

        counts = {"attempted": 0, "done": 0, "failed": 0, "wait": 0.0}
        pending: List = []
        dispatched_at: List[float] = []
        read_at: List[float] = []

        def drain():
            rows = pending.pop().read()
            read_at.append(time.perf_counter())
            for r in rows:
                counts["done"] += 1
                counts["failed"] += int(not (r["d_finite"] > 0 and r["g_finite"] > 0))

        def one():
            tw = time.perf_counter()
            batches = [next(self.loader)[0] for _ in range(self.k_chunk)]
            counts["wait"] += time.perf_counter() - tw
            m = self.chunk(batches)
            dispatched_at.append(time.perf_counter())
            counts["attempted"] += self.k_chunk
            if pending:
                drain()
            pending.append(m)

        prof, n_chunks = None, 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            go = time.perf_counter() < deadline
            if not (agree(go) if agree is not None else go):
                break
            if profile_chunks and n_chunks == 2 and prof is None:
                tp = time.perf_counter()
                prof = harness.profile_slice(torch, lambda: [one() for _ in range(profile_chunks)])
                prof["held_s"] = time.perf_counter() - tp   # with the profiler's start and stop
                n_chunks += profile_chunks
                continue
            one()
            n_chunks += 1
        if pending:
            drain()
        window_s = time.perf_counter() - t0
        harness.log(f"window {window_s:.3f} s: {counts['done']} steps; waited "
                    f"{counts['wait']:.3f} s for batches; chunks dispatched at "
                    f"{[round(t - t0, 3) for t in dispatched_at]} s, read at "
                    f"{[round(t - t0, 3) for t in read_at]} s")
        return dict(counts, window_s=window_s, profile=prof)

    def record_step(self, entries: List[str]) -> harness.Recorder:
        """One eager step of the cell's own path with the calls to
        ``entries`` recorded (after the window; the chunk's graph is freed)."""
        import torch

        rec = harness.Recorder(entries)
        if entries:
            self.chunk.close()
            with rec:
                self.step_fn(self.state, torch.from_numpy(self.first[0]).to(self.dev),
                             rng=self.rng)
            torch.cuda.synchronize()
        return rec

    def close(self) -> None:
        if self.loader is not None:
            self.loader.close()
        shutil.rmtree(self.tmp, ignore_errors=True)
        self.chunk.close()
        for name in ("chunk", "state", "step_fn", "G", "D"):
            setattr(self, name, None)
        gc.collect()


def reference_modules(s: Settings, dev):
    """The reference G and D with the seeded weights both sides start from."""
    from reference.discriminator import DiscriminatorMultiScaleAux as RefD
    from reference.generator import Generator as RefG
    from reference.generator import GeneratorConfig as RefGCfg

    cfg = RefGCfg(**{k: v for k, v in s.gen.items() if k in RefGCfg.__dataclass_fields__})
    G = harness.seeded_modules(lambda g: RefG(cfg, generator=g), s.seed, dev)
    D = harness.seeded_modules(lambda g: RefD(**s.disc, generator=g), s.seed + 1, dev)
    return G, D


def reference_check(p: Settings, dev, reals: List, prog: dict, trace: bool,
                    draws_up_front=False):
    """Run the reference's first steps on ``reals`` (uint8 batches of the
    whole batch) from the program's starting generator state and step, with
    TF32 off, and compare them with the program's ``prog`` readings.  Returns
    the checks and the products a step (traced runs)."""
    import torch

    from reference.generator import RenderOptions as RefOpts
    from reference.step import StepSettings, Trainer
    from work.step import step_flops

    t = p.tcfg
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        rG, rD = reference_modules(p, dev)
        s = StepSettings(img_size=p.img, batch_size=t.batch_size, gen_lr=t.gen_lr,
                         disc_lr=t.disc_lr, beta1=t.beta1, beta2=t.beta2, r1_lambda=t.r1_lambda,
                         d_reg_every=t.d_reg_every, grad_clip=t.grad_clip, aux_reg=p.aux_reg,
                         warmup_d=t.warmup_d, fade_steps=t.fade_steps,
                         nerf_noise_disable=t.nerf_noise_disable, ema_decay=t.ema_decay,
                         ema_start_itr=t.ema_start_itr, grad_points=t.grad_points or 0)
        trainer = Trainer(rG, rD, s, RefOpts(**p.render))
        trainer.t = p.start_step
        params = list(rG.parameters()) + list(rD.parameters())
        p0 = [q.detach().clone() for q in params]
        rng = torch.Generator(dev)
        rng.set_state(prog["rng_start"])
        reals = [torch.from_numpy(np.ascontiguousarray(b)).to(dev) for b in reals]
        rows = []

        def step(real):
            rows.append(trainer.step(real, rng, draws_up_front=draws_up_front))

        flops = step_flops(lambda: step(reals[0])) if trace else step(reals[0])
        ref_grad1 = _norms(trainer.g_opt.m + trainer.d_opt.m)
        for real in reals[1:]:
            step(real)
        ref_delta = np.array([(q.detach() - q0).double().norm().item()
                              for q, q0 in zip(params, p0)]
                             + [(e - q0).double().norm().item()
                                for e, q0 in zip(trainer.ema, p0[:len(trainer.ema)])])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    loss_gap = max(abs(a[k] - r[k]) / max(abs(r[k]), 1e-2)
                   for a, r in zip(prog["rows"], rows) for k in ("d_loss", "g_loss"))
    grad1, delta = prog["grad1"], prog["delta"]
    g_names, d_names = prog["names"]
    n_g, n_d = len(g_names), len(d_names)
    rg1, rd1 = ref_grad1[:n_g], ref_grad1[n_g:]
    grad = np.concatenate([_gaps(grad1[:n_g], rg1, np.ones(n_g, bool), rg1),
                           _gaps(grad1[n_g:], rd1, np.ones(n_d, bool), rd1)])
    # leaves whose reference gradient is under a thousandth of the median leaf's move by
    # round-off alone under Adam: they are left out of the change
    moved_g, moved_d = rg1 > 1e-3 * _median(rg1), rd1 > 1e-3 * _median(rd1)
    dg, dd, de = delta[:n_g], delta[n_g:n_g + n_d], delta[n_g + n_d:]
    rg, rd, re = ref_delta[:n_g], ref_delta[n_g:n_g + n_d], ref_delta[n_g + n_d:]
    change = np.concatenate([_gaps(dg, rg, moved_g, rg[moved_g]),
                             _gaps(dd, rd, moved_d, rd[moved_d]),
                             _gaps(de, re, moved_g, re[moved_g])])
    names = g_names + d_names
    change_names = names + ["ema." + n for n in g_names]
    harness.log("program first steps: " + "; ".join(
        f"d_loss {r['d_loss']:.6f} g_loss {r['g_loss']:.6f}" for r in prog["rows"]))
    harness.log("reference first steps: " + "; ".join(
        f"d_loss {r['d_loss']:.6f} g_loss {r['g_loss']:.6f}" for r in rows))
    harness.log(f"leaves: G {n_g} ({int(moved_g.sum())} moved), D {n_d} "
                f"({int(moved_d.sum())} moved); median first-gradient norm G {_median(rg1):.6g}, "
                f"D {_median(rd1):.6g}; widest grad gaps "
                f"{[(names[i], round(float(grad[i]), 6)) for i in np.argsort(-grad)[:3]]}; "
                f"widest change gaps "
                f"{[(change_names[i], round(float(change[i]), 6)) for i in np.argsort(-change)[:3]]}")
    first = prog["rows"][0]["d_loss"], rows[0]["d_loss"]
    values = {"first_d_loss_gap": abs(first[0] - first[1]) / max(abs(first[1]), 1e-2),
              "d_grad_gap": float(grad[n_g:].max()),
              "d_grad_median_gap": float(np.median(grad[n_g:][rd1 > 0])),
              "loss_gap": loss_gap, "grad_gap": float(grad.max()),
              "change_gap": float(change.max()),
              "change_median_gap": float(np.median(change[:n_g + n_d][
                  np.concatenate([moved_g, moved_d])])),
              "ema_change_median_gap": float(np.median(change[n_g + n_d:][moved_g]))}
    harness.log(f"numbers: {values}")
    return {k: (values[k], float(lim)) for k, lim in p.c.limits.items()}, flops


def run(c: harness.Cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, control: Optional[str] = None, sizes: Optional[dict] = None,
        fault: Optional[Callable] = None) -> harness.Run:
    import torch

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    harness.set_precision(torch, c.config)
    if cuda:
        harness.log(f"card: {harness.power_limit()}; precision flags: "
                    f"{harness.precision_flags(torch)}; control {control}")
    p = Program(c, seed, dev, sizes, control, fault)
    try:
        prog = p.first_steps()
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        harness.log(f"set-up {setup_s:.3f} s")
        w = p.window(seconds, int(c.traffic["profile_chunks"]) if trace and cuda else 0)
        values: Dict[str, float] = {"train_imgs_per_s": w["done"] * p.batch / w["window_s"],
                                    "setup_s": setup_s}
        device_rec = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
        if cuda:
            peak = torch.cuda.max_memory_allocated()
            values["peak_mem_gib"] = peak / 2 ** 30
            device_rec = dict(harness.card_record(torch, 1), memory_peak_bytes=peak)
        readers = ({m["name"]: harness.metric_reader(m["name"]) for m in c.per_layer}
                   if trace and cuda else {})
        rec = p.record_step([e for r in readers.values() for e in getattr(r, "ENTRIES", [])])
        # the rate of the work outside the profiler's hold, under which it runs slower
        slice_steps = int(c.traffic["profile_chunks"]) * p.k_chunk if w["profile"] else 0
        slice_s = w["profile"]["held_s"] if w["profile"] else 0.0
        ctx = {"window_s": w["window_s"] - slice_s, "units": w["done"] - slice_steps,
               "data_wait_s": w["wait"], "data_window_s": w["window_s"],
               "profile": w["profile"], "calls": rec.calls, "config": {"generator": p.s.gen},
               "time_call": lambda e, a, k: harness.time_call(torch, rec.originals[e], a, k)}
        per_layer = {n: r.read(ctx) for n, r in readers.items() if getattr(r, "ENTRIES", None)}
        rec.calls.clear()
    finally:
        p.close()
    if cuda:
        torch.cuda.empty_cache()
    checks, flops = reference_check(p.s, dev, p.first, prog, trace and cuda)
    breakdown = None
    if readers:
        ctx["flops_per_unit"] = flops
        per_layer.update({n: r.read(ctx) for n, r in readers.items()
                          if not getattr(r, "ENTRIES", None)})
        values.update({k: v for k, v in per_layer.items() if v is not None})
        if w["profile"] is not None:
            device_rec.update(busy_s=w["profile"]["busy_s"], window_s=w["profile"]["window_s"])
            breakdown = {k: w["profile"][k] for k in ("device_ops", "idle_gaps")}
        from cips3d_tpu_torch.ops import build

        harness.log(f"kernel launches (name, product dtype): {dict(build.LAUNCHES)}")
        harness.log(f"per-layer ({harness.power_limit()}; products at 495 TFLOP/s, bytes at "
                    f"3.35 TB/s): {per_layer}; step products {flops} FLOP")
    return harness.Run(w["attempted"], w["failed"], values, device_rec, checks, breakdown)
