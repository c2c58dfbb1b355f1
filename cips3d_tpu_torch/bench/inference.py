"""Serving bench: novel-view frames/s at r256 on one card, counterpart of the
repo's `bench_inference.py`.

    python -m cips3d_tpu_torch.bench.inference [img_size [num_steps [frames]]]   # 256 12 16
    python -m cips3d_tpu_torch.bench.inference 32 4 2 --device cpu --tiny --calls 1

BASELINE.json's north star: at least 30 frames/s a card at r256 (12 steps a
ray, hierarchical sampling, the full INR decode).  The generator is
`GeneratorNerfINR` with bf16 compute and f32 parameters from a seeded init,
rendering one camera a frame (``h_stddev = v_stddev = 0``, fresh depth
jitter each frame) through `forward_with_rays` from one latent's styles.
By default both serving kernels and the polynomial sine run
(``BENCH_FUSED``, ``BENCH_FUSED_INR``, ``BENCH_FAST_SIN``, each "1" unless
set to "0").  A call renders ``frames`` frames and sums their absolute
values on the device, read back once; the first call warms up, then each
of the timed calls is timed on its own.  ``value`` is all timed frames over
all timed seconds; each call's rate and their median go to stderr and to
``--report``.

A call is one program, as `bench_inference.py`'s call is one ``lax.scan``:
one captured frame replayed ``frames`` times (`build_renderer`); its
launches are counted through the replays.

``BENCH_AB=1`` also times the plain leg (both kernels off, the same sine
and weights, captured the same way) in the same process: ``xla_fps`` (the
name of `bench_inference.py`'s key for its XLA leg) and ``same_session``.  Prints one JSON line: ``metric``
(``novel_view_fps_per_chip_r{img_size}``), ``value``, ``unit``,
``vs_baseline`` (over 30 frames/s).  A failing leg raises: exit non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from typing import Optional

import torch

from cips3d_tpu_torch.bench.train import TINY_G

BASELINE_FPS = 30.0


def build_renderer(img_size: int, num_steps: int, frames: int, fast_sin: bool, fused_ray: bool,
                   fused_inr: bool, *, gen_widths=None, device="cuda", seed: int = 0,
                   weights: Optional[dict] = None, dispatch: str = "program"):
    """(generator, options, run_frames): ``run_frames(styles, rng)`` renders
    ``frames`` frames and returns the sum of their absolute values (a
    float, read back once).  ``weights`` (a state dict) replaces the seeded
    init, so that two legs share their parameters.

    A call is one program, as `bench_inference.py`'s is one ``lax.scan``:
    one frame (`sample_world`, `forward_with_rays`, its absolute sum added
    to a device scalar) captured as a CUDA graph at the first call and
    replayed ``frames`` times a call, drawing from ``rng`` as the eager
    frames would; on the CPU the same frame runs op by op.
    ``dispatch="eager"`` runs the frames op by op on the card too."""
    from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR, RenderOptions
    from cips3d_tpu_torch.utils import graphs

    cfg = GeneratorConfig(**(gen_widths or {}), fast_sin=fast_sin, fused_ray=fused_ray,
                          fused_inr=fused_inr)
    gen = GeneratorNerfINR(cfg, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(seed))
    if weights is not None:
        gen.load_state_dict(weights)
    gen = gen.to(device).eval()
    opts = RenderOptions(img_size=img_size, num_steps=num_steps, h_stddev=0.0, v_stddev=0.0)
    total = torch.zeros((), device=device)
    program = []

    def frame(styles, rng):
        world = gen.sample_world(1, opts, rng)
        img, _ = gen.forward_with_rays(styles, world, opts, rng)
        total.add_(img.float().abs().sum())
        return total

    @torch.no_grad()
    def run_frames(styles, rng):
        total.zero_()
        if dispatch == "eager":
            for _ in range(frames):
                frame(styles, rng)
            return float(total)
        if not program:
            program.append(graphs.Program(lambda x, g: frame(x, g), styles, device,
                                          f"bench.inference frame r{img_size} x{num_steps}",
                                          uses_generator=True, state=[total], copy_out=False))
        program[0].fill(styles)
        return float(program[0].run(frames, rng))

    run_frames.program = program
    return gen, opts, run_frames


def measure(run_frames, styles, frames: int, tag: str, n_calls: int = 3, *, device="cuda",
            report: Optional[dict] = None) -> float:
    """Warm up, then ``n_calls`` timed calls; frames/s over all of them.  With
    ``report`` the leg's rates, launches by product dtype and, on the card,
    one profiled call land in ``report[tag]``."""
    from cips3d_tpu_torch.bench import report as rep

    before = rep.launch_counts()
    rng = torch.Generator(device).manual_seed(0)
    t0 = time.perf_counter()
    run_frames(styles, rng)
    print(f"[{tag}] warm-up call: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    rates, acc, total = [], 0.0, 0.0
    for i in range(n_calls):
        rng = torch.Generator(device).manual_seed(1 + i)
        t0 = time.perf_counter()
        acc += run_frames(styles, rng)
        dt = time.perf_counter() - t0
        total += dt
        rates.append(frames / dt)
        print(f"[{tag}] call {i}: {rates[-1]:.2f} frames/s", file=sys.stderr)
    fps = n_calls * frames / total
    median = statistics.median(rates)
    print(f"[{tag}] checksum {acc:.3f}, {fps:.2f} frames/s over all calls, median of the "
          f"calls {median:.2f}", file=sys.stderr)
    if report is not None:   # the launches of every frame here, the profiled call's too
        leg = {"rates": rates, "value": fps, "median": median, "frames": (n_calls + 1) * frames}
        if torch.device(device).type == "cuda":
            leg["profile"] = rep.profile_call(
                lambda: run_frames(styles, torch.Generator(device).manual_seed(0)))
            leg["frames"] += frames
        leg["launches"] = rep.launches_since(before)
        report[tag] = leg
    return fps


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("sizes", nargs="*", type=int, help="img_size [num_steps [frames]]")
    p.add_argument("--device", default="cuda")
    p.add_argument("--calls", type=int, default=3)
    p.add_argument("--tiny", action="store_true", help="narrow widths (a rehearsal, not a rate)")
    p.add_argument("--report", default=None,
                   help="write each leg's rates, launches and profile here (JSON)")
    args = p.parse_args(argv)
    img_size, num_steps, frames = (list(args.sizes) + [256, 12, 16][len(args.sizes):])[:3]
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench.inference: no CUDA device (use --device cpu for a rehearsal)")
    from cips3d_tpu_torch.models.generator import sample_zs
    # bf16 products accumulate in f32 on the card too, as flax's bf16 compute does
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    ab = os.environ.get("BENCH_AB", "0") == "1"
    fast_sin = os.environ.get("BENCH_FAST_SIN", "1") == "1"
    fused_ray = os.environ.get("BENCH_FUSED", "1") == "1"
    fused_inr = os.environ.get("BENCH_FUSED_INR", "1") == "1"
    widths = TINY_G if args.tiny else None
    report = {} if args.report else None
    kw = dict(device=args.device, report=report)

    gen, _, run = build_renderer(img_size, num_steps, frames, fast_sin, fused_ray, fused_inr,
                                 gen_widths=widths, device=args.device)
    zs = sample_zs(1, gen.cfg, torch.Generator(args.device).manual_seed(0), device=args.device)
    with torch.no_grad():
        styles = gen.mapping(zs["z_nerf"], zs["z_inr"])
    fps = measure(run, styles, frames, "fused" if fused_ray or fused_inr else "plain",
                  args.calls, **kw)
    extra = {}
    if ab:
        # the plain leg keeps the sine, so the A/B isolates the kernels
        _, _, run_plain = build_renderer(img_size, num_steps, frames, fast_sin, False, False,
                                         gen_widths=widths, device=args.device,
                                         weights=gen.state_dict())
        extra["xla_fps"] = round(measure(run_plain, styles, frames, "plain", args.calls, **kw), 2)
        extra["same_session"] = True
    if report is not None:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"metric": f"novel_view_fps_per_chip_r{img_size}", "value": round(fps, 2),
                      "unit": "fps", "vs_baseline": round(fps / BASELINE_FPS, 2), **extra}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
