"""Training bench: the flagship r64 adversarial step in images/s on one
card, counterpart of the repo's `bench.py`.

    python -m cips3d_tpu_torch.bench.train                  # on the card
    python -m cips3d_tpu_torch.bench.train --device cpu --tiny --k 1 --calls 1 \\
        --exact-calls 1 --loader-steps 1                    # a quick rehearsal

Prints ONE JSON line with `bench.py`'s keys: ``metric``
(``train_imgs_per_sec_per_chip_r64``), ``value``, ``unit``,
``vs_baseline``, and in the default mode ``exact_sin_imgs_per_sec`` and
``loader_imgs_per_sec``.  Every leg builds `GeneratorNerfINR` and
`DiscriminatorMultiScaleAux(max_size=1024)` with bf16 compute and f32
parameters, as `bench.py` builds them, from a seeded init, and trains at
r64, b = 4 (``BENCH_BATCH``), 12 steps a ray, aux on:
  1. the shipped config: fast_sin, the unfused G phase, the D phase on the
     ray tile and the INR tile (`TrainConfig`'s auto-pick);
  2. the exact-sine alternate: ``fused_ray`` with the residual backward
     (the ray tile with residuals and the backward kernel in the G phase);
  3. the loader: leg 1's state fed from a zip (``CIPS3D_BENCH_DATA``,
     default ``datasets/blobs_64.zip``, written by `data/synthetic.py` when
     missing) through `ZipImageDataset` and `DataLoader`, uint8 batches
     into the chunk's input buffer step by step, normalised on the device.
``BENCH_FAST_SIN`` set runs that one configuration only; ``BENCH_FUSED``,
``BENCH_VJP``, ``BENCH_DPHASE_INR`` and ``BENCH_DPHASE`` route the kernels
as in `bench.py`.

A call is one chunk of K steps (`train/chunk.py`), as `bench.py`'s call is
one ``lax.scan`` of K steps: on the card K replays of a CUDA graph of the
step, each fed the same uint8 batch through the graph's input buffer,
ending in the host read of the last ``d_loss``; on the CPU K eager steps.
The first call builds the chunk (a warm-up step, then the capture) and
runs it, then each of the timed calls is timed on its own.  ``value`` is all timed images over all timed seconds, so a
stall counts for as long as it lasts; each call's rate and their median go
to stderr and to ``--report``, for the spread.  A leg that fails raises:
the process exits non-zero and prints no JSON line.

Baseline: the reference trains FFHQ r64 for 200k iterations at batch 4 a
GPU on 8 GPUs in about 2 days: 200000 * 32 / 172800 s / 8 = 4.63 images/s
a GPU; ``vs_baseline`` is the card's rate over that.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

BASELINE_IMGS_PER_SEC_PER_CHIP = 200000 * 32 / (2 * 86400) / 8   # 4.63
IMG_SIZE = 64
TINY_G = dict(z_dim_nerf=16, z_dim_inr=32, nerf_hidden_dim=16, nerf_style_dim=16,
              nerf_mapping_layers=2, inr_hidden_dim=32, inr_style_dim=32, inr_mapping_layers=2)
TINY_D = {r: 16 for r in (4, 8, 16, 32, 64, 128, 256, 512, 1024)}


def batch_size() -> int:
    return int(os.environ.get("BENCH_BATCH", "4"))


def build(fast_sin: bool, fused_ray: Optional[bool] = None, fused_ray_vjp: Optional[str] = None,
          *, gen_widths: Optional[Dict[str, int]] = None,
          disc_channels: Optional[Dict[int, int]] = None, device="cuda", seed: int = 0):
    """(generator, discriminator, TrainConfig, RenderOptions) of one bench
    configuration: bf16 compute with f32 parameters, the flagship's widths
    unless ``gen_widths`` / ``disc_channels`` narrow them.  ``fused_ray``
    and ``fused_ray_vjp`` override ``BENCH_FUSED`` / ``BENCH_VJP``."""
    from cips3d_tpu_torch.models.discriminator import DiscriminatorMultiScaleAux
    from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR, RenderOptions
    from cips3d_tpu_torch.train.state import TrainConfig

    gcfg = GeneratorConfig(
        **(gen_widths or {}), fast_sin=fast_sin,
        fused_ray=(os.environ.get("BENCH_FUSED", "0") == "1" if fused_ray is None
                   else fused_ray),
        fused_ray_vjp=(os.environ.get("BENCH_VJP", "pallas") if fused_ray_vjp is None
                       else fused_ray_vjp))
    opts = RenderOptions(img_size=IMG_SIZE, num_steps=12)
    tcfg = TrainConfig(
        img_size=IMG_SIZE, batch_size=batch_size(),
        fused_dphase_inr=os.environ.get("BENCH_DPHASE_INR", "1") == "1",
        fused_dphase=(None if "BENCH_DPHASE" not in os.environ
                      else os.environ["BENCH_DPHASE"] == "1"))
    gen = GeneratorNerfINR(gcfg, dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(seed))
    disc = DiscriminatorMultiScaleAux(max_size=1024, channels_override=disc_channels,
                                      dtype=torch.bfloat16,
                                      generator=torch.Generator().manual_seed(seed + 1))
    return gen.to(device), disc.to(device), tcfg, opts


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


PROFILED_STEPS = 5   # the chunk profiled for the report


def measure(fast_sin: bool, n_calls: int = 4, K: int = 50, *, device="cuda",
            report: Optional[dict] = None, tag: Optional[str] = None, chunked: bool = True,
            **build_kw):
    """Build the chunk, then time ``n_calls`` calls of K steps each; returns
    (images/s over all timed calls, the chunk or None).  ``chunked`` False times K
    eager steps a call instead, each reading its ``d_loss`` back (the loop
    before chunks; a comparison, not the bench's value).  With ``report`` (a
    dict) the leg's per-call rates, launches by product dtype and, on the
    card, one profiled chunk of PROFILED_STEPS steps land in
    ``report[tag]``."""
    from cips3d_tpu_torch.bench import report as rep
    from cips3d_tpu_torch.train.chunk import make_chunk_fn
    from cips3d_tpu_torch.train.step import init_train_state, make_train_step

    tag = tag or f"fast_sin={int(fast_sin)}"
    gen, disc, tcfg, opts = build(fast_sin, device=device, **build_kw)
    b = tcfg.batch_size
    print(f"[{tag}] initializing...", file=sys.stderr)
    state = init_train_state(gen, disc, tcfg)
    step_fn = make_train_step(gen, disc, tcfg, opts, aux_reg=True)
    rng = torch.Generator(device).manual_seed(0)
    real = np.random.default_rng(0).integers(0, 256, (b, 3, IMG_SIZE, IMG_SIZE), np.uint8)
    before = rep.launch_counts()
    t0 = time.perf_counter()
    chunk = None
    if chunked:
        chunk = make_chunk_fn(step_fn, state, real.shape, rng, label=f"the bench step ({tag})")

        def run_k(k=K):
            return chunk([real] * k).read()[-1]["d_loss"]
    else:
        real_dev = torch.from_numpy(real).to(device)

        def run_k(k=K):
            for _ in range(k):
                _, metrics = step_fn(state, real_dev, rng=rng)
                loss = float(metrics["d_loss"])
            return loss

    loss = run_k()
    print(f"[{tag}] {'chunk built and ' if chunked else ''}first call, {K} steps: "
          f"{time.perf_counter() - t0:.1f} s  d_loss={loss:.4f}", file=sys.stderr)
    rates: List[float] = []
    total = 0.0
    for i in range(n_calls):
        _sync(device)
        t0 = time.perf_counter()
        loss = run_k()
        dt = time.perf_counter() - t0
        total += dt
        rates.append(K * b / dt)
        print(f"[{tag}] call {i}: {K} steps in {dt:.2f} s = {rates[-1]:.2f} images/s  "
              f"d_loss={loss:.4f}", file=sys.stderr)
    value = n_calls * K * b / total
    median = statistics.median(rates)
    print(f"[{tag}] {n_calls} calls: {value:.2f} images/s over all of them, median of the "
          f"calls {median:.2f}", file=sys.stderr)
    if report is not None:   # the launches of every step here, the profiled ones' too
        leg = {"rates": rates, "value": value, "median": median, "steps": (n_calls + 1) * K,
               "chunked": chunked}
        if torch.device(device).type == "cuda":
            leg["profile"] = rep.profile_call(lambda: run_k(PROFILED_STEPS))
            leg["profile"]["steps"] = PROFILED_STEPS
            leg["steps"] += PROFILED_STEPS
        leg["launches"] = rep.launches_since(before)
        report[tag] = leg
    return value, chunk


def bench_with_input_pipeline(chunk, n_steps: int = 100, K: int = 50, *, device="cuda",
                              report: Optional[dict] = None) -> float:
    """The loader leg on the shipped leg's chunk: one warm-up step, then
    ``n_steps`` steps fed from the zip in chunks of at most K, each step's
    batch copied into the chunk's input buffer; images/s over them (loader,
    the host-to-card copies and the steps), ending in the host read of the
    last ``d_loss``."""
    from cips3d_tpu_torch.bench import report as rep
    from cips3d_tpu_torch.data.zip_dataset import DataLoader, ZipImageDataset

    data = os.environ.get("CIPS3D_BENCH_DATA", "datasets/blobs_64.zip")
    if not os.path.exists(data):
        print(f"input-pipeline phase: regenerating {data}...", file=sys.stderr)
        from cips3d_tpu_torch.data.synthetic import make_blob_dataset

        os.makedirs(os.path.dirname(data) or ".", exist_ok=True)
        tmp = data + ".tmp"
        make_blob_dataset(tmp, num_images=2000, img_size=IMG_SIZE, seed=1)
        os.replace(tmp, data)
    b = batch_size()
    ds = ZipImageDataset(data, resize_resolution=IMG_SIZE, xflip=True)
    loader = DataLoader(ds, batch_size=b, num_workers=2)
    before = rep.launch_counts()
    try:
        chunk([next(loader)[0]]).read()   # warm-up
        _sync(device)
        t0 = time.perf_counter()
        done = 0
        while done < n_steps:
            k = min(K, n_steps - done)
            loss = chunk([next(loader)[0] for _ in range(k)]).read()[-1]["d_loss"]
            done += k
        dt = time.perf_counter() - t0
    finally:
        loader.close()
    ips = n_steps * b / dt
    print(f"real-data pipeline: {n_steps} steps in {dt:.2f} s = {ips:.1f} images/s "
          f"(loader, copy to the device and the steps, chunks of {K})  d_loss={loss:.4f}",
          file=sys.stderr)
    if report is not None:
        report["loader"] = {"images_per_sec": ips, "steps": n_steps + 1,
                            "launches": rep.launches_since(before)}
    return ips


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--k", type=int, default=50, help="steps a timed call")
    p.add_argument("--calls", type=int, default=4, help="timed calls of the shipped leg")
    p.add_argument("--exact-calls", type=int, default=2, help="timed calls of the exact-sine leg")
    p.add_argument("--loader-steps", type=int, default=100)
    p.add_argument("--tiny", action="store_true", help="narrow widths (a rehearsal, not a rate)")
    p.add_argument("--report", default=None,
                   help="write each leg's rates, launches and profile here (JSON)")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench.train: no CUDA device (use --device cpu for a rehearsal)")
    widths = dict(gen_widths=TINY_G, disc_channels=TINY_D) if args.tiny else {}
    # bf16 products accumulate in f32 on the card too, as flax's bf16 compute does
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    report = {} if args.report else None
    kw = dict(device=args.device, report=report, K=args.k, **widths)

    forced = os.environ.get("BENCH_FAST_SIN")
    extra = {}
    if forced is not None:   # one requested configuration, nothing else
        ips, _ = measure(forced == "1", args.calls, **kw)
    else:
        # the shipped config, then the exact-sine alternate with its fused residual
        # backward in the same process, then the loader
        ips, chunk = measure(True, args.calls, tag="shipped", **kw)
        chunk.close()   # the exact-sine leg's graph next; the loader leg captures again
        exact, exact_chunk = measure(False, args.exact_calls, fused_ray=True,
                                     fused_ray_vjp="pallas_residual", tag="exact_sin", **kw)
        exact_chunk.close()
        extra["exact_sin_imgs_per_sec"] = round(exact, 2)
        extra["loader_imgs_per_sec"] = round(bench_with_input_pipeline(
            chunk, args.loader_steps, args.k, device=args.device, report=report), 1)
    if report is not None:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"metric": f"train_imgs_per_sec_per_chip_r{IMG_SIZE}",
                      "value": round(ips, 2), "unit": "imgs/s",
                      "vs_baseline": round(ips / BASELINE_IMGS_PER_SEC_PER_CHIP, 2), **extra}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
