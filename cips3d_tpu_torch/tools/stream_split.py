"""Where the streamed kernels' time goes: one call's device time, launch by launch.

    python -m cips3d_tpu_torch.tools.stream_split [--variants] [--time]

Profiles one call each (after a warm-up; the median of three profiled
calls, launch by launch) of the streamed #2 (`csrc/ray_tile_streamed.cu`:
NeRF depth 3, r128 x 24, fast_sin, f32 products) and the streamed #1
(`csrc/inr_tile_streamed.cu`: D = 1024, r64, f32 products) under
`torch.profiler`, and prints each kernel launch of the call in order:
its stage (product layer, head, sigma_rows, rays_resample, rays_composite,
coarse_points, rgb_out, ...), device time, and for a product its FLOP
count, the bytes it must move (each operand read once, each output written
once), the achieved FLOP/s and bytes/s, and the grid, block, registers,
shared memory and estimated resident warps per SM as the profiler's trace
reports them.  The stages are named from the kernels' names and the order
the library launches them in; a launch of another kind goes by its
kernel's name.  `chip_smoke.py` phase 20 prints the same split.
``--variants`` adds the split of #2r and of #3 (residual mode) at the
training shape (depth 3, r64, b = 4, S = 12, density noise 0.5).  With
``--time`` it also prints each call's median CUDA-event ms in turns with its
plain version (plain, kernel, kernel, plain), and the streamed against the
resident path at the flagship (#2 at depth 2, #1 at D = 512, r128).  Needs a
CUDA device.
"""

import argparse
import json
import os
import re
import statistics
import sys
import tempfile

import torch

SERVE_STEPS = 24


def _trace_kernels(fn, calls=3, tries=8):
    """[[{name, us, grid, block, regs, smem, warps}, ...] per call] of the
    device kernels ``fn`` launches, in launch order, from a profiler trace:
    ``calls`` profiled calls that saw the most launches (a profiled call
    now and then comes back with few or no device events: it is dropped)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        ks = sorted((e for e in trace.get("traceEvents", [])
                     if e.get("cat") == "kernel" and e.get("ph") == "X"), key=lambda e: e["ts"])
        per_call.append([dict(name=e["name"], us=float(e["dur"]),
                              grid=e.get("args", {}).get("grid"),
                              block=e.get("args", {}).get("block"),
                              regs=e.get("args", {}).get("registers per thread"),
                              smem=e.get("args", {}).get("shared memory"),
                              occupancy_pct=e.get("args", {}).get("est. achieved occupancy %"))
                         for e in ks])
        most = max(len(c) for c in per_call)
        whole = [c for c in per_call if len(c) == most]
        if most and len(whole) >= calls:
            return whole[:calls]
    raise RuntimeError(f"stream_split: {tries} profiled calls saw "
                       f"{[len(c) for c in per_call]} launches")


def _short(name):
    """The kernel's function name without its namespace and template arguments."""
    base = re.sub(r"<.*$", "", name.replace("(anonymous namespace)::", ""))
    base = re.sub(r"\(.*$", "", base)
    return base.split("::")[-1].split(" ")[-1]


def _ray_stages(names, b, n, S, L, H, C, R, esz=4):
    """(stage, flops, bytes) of each launch of the streamed forward, from the
    kernels' names in launch order: per pass a product a layer, sigma_rows
    and the head (colour FiLM and rgb head in one launch); any other launch
    by its kernel's name."""
    rows = b * n * S
    out, pass_, layer = [], 0, 0
    for nm in names:
        k = _short(nm)
        if k == "gemm_kernel" and layer < L:
            K, N = (16, H) if layer == 0 else (H, H)
            kin = 3 if layer == 0 else H
            stage = f"pass {pass_} layer {layer} product (K={K}, N={N})"
            flops = 2 * rows * kin * N
            nbytes = esz * (rows * kin + kin * N + rows * N)
            layer += 1
        elif k == "head_kernel":
            stage = f"pass {pass_} colour FiLM + rgb head (K={H}, N={C}; K={C}, N={R})"
            flops = 2 * rows * (H * C + C * R)
            nbytes = esz * (rows * H + H * C + C * R) + 4 * rows * R
        elif k == "sigma_rows":
            stage, flops, nbytes = f"pass {pass_} sigma_rows", 2 * rows * H, esz * rows * H + 4 * rows
        elif k == "rays_resample":
            stage, flops, nbytes = "rays_resample", None, None
            pass_, layer = pass_ + 1, 0
        else:
            stage, flops, nbytes = k, None, None
        out.append((stage, flops, nbytes))
    return out


def _inr_stages(names, b, n, in0, D, n_blocks=9):
    """(stage, flops, bytes) of each launch of the streamed decode: the 18
    products, the ToRGB of blocks 3-8 in the second product's epilogue, one
    `rgb_out` at the end; any other launch by its kernel's name."""
    px = b * n
    out, layer = [], 0
    for nm in names:
        k = _short(nm)
        if k == "gemm_kernel":
            K = in0 if layer == 0 else D
            blk, stage_ = divmod(layer, 2)
            rgb = stage_ == 1 and blk >= 3
            flops = 2 * px * K * D + (2 * px * D * 3 if rgb else 0)
            nbytes = 4 * (px * K + K * D + (px * D if layer < 2 * n_blocks - 1 else 0)
                          + (px * D if stage_ == 1 and blk >= 4 else 0))
            out.append((f"layer {layer} product (K={K}, N={D})"
                        + (", ToRGB in the epilogue" if rgb else ""), flops, nbytes))
            layer += 1
        else:
            out.append((k, None, None))
    return out


def split(fn, stages_of, calls=3):
    """The launch-by-launch split of one call of ``fn``: a list of dicts
    (stage, kernel, us median over ``calls`` profiled calls, flops, bytes,
    TFLOP/s, GB/s, grid, block, regs, smem, est. warps per SM)."""
    per_call = _trace_kernels(fn, calls)
    first = per_call[0]
    stages = stages_of([k["name"] for k in first])
    rows = []
    for i, (k, (stage, flops, nbytes)) in enumerate(zip(first, stages)):
        us = statistics.median(c[i]["us"] for c in per_call)
        occ = k["occupancy_pct"]
        rows.append(dict(stage=stage, kernel=_short(k["name"]), us=us, flops=flops, bytes=nbytes,
                         tflops=flops / us / 1e6 if flops else None,
                         gbs=nbytes / us / 1e3 if nbytes else None, grid=k["grid"],
                         block=k["block"], regs=k["regs"], smem=k["smem"],
                         warps_per_sm=None if occ is None else occ / 100 * 64))
    return rows


def lines(title, rows):
    """Printable lines of a split: a header with the total, one line a launch."""
    total = sum(r["us"] for r in rows)
    out = [f"{title}: {len(rows)} launches, {total / 1e3:.3f} ms of device time"]
    by = {}
    for r in rows:
        by[r["kernel"]] = by.get(r["kernel"], 0.0) + r["us"]
    out.append("  by kernel: " + ", ".join(f"{k} {v / 1e3:.3f} ms ({100 * v / total:.1f} %)"
                                           for k, v in sorted(by.items(), key=lambda x: -x[1])))
    for r in rows:
        rate = ""
        if r["flops"]:
            rate = (f"; {r['flops'] / 1e9:.2f} GFLOP, {r['bytes'] / 1e6:.1f} MB: "
                    f"{r['tflops']:.1f} TFLOP/s, {r['gbs']:.0f} GB/s")
        warps = "?" if r["warps_per_sm"] is None else f"{r['warps_per_sm']:.0f}"
        out.append(f"    {r['us']:9.1f} us  {r['stage']} [{r['kernel']}; grid {r['grid']}, block "
                   f"{r['block']}, {r['regs']} regs, {r['smem']} B shared, ~{warps} warps/SM]"
                   + rate)
    return out


def turns_ms(fns, reps=10, warmup=2):
    """Median ms per call of each function, CUDA events, in turns (a, b, b, a)."""
    for fn in fns:
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    order = list(range(len(fns))) + list(reversed(range(len(fns))))
    for _ in range(reps):
        for i in order:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fns[i]()
            end.record()
            end.synchronize()
            times[i].append(start.elapsed_time(end))
    return [statistics.median(t) for t in times]


def ray_case(dev, L=3, size=128, S=SERVE_STEPS, path="streamed", plain=False,
             mm_dtype=torch.float32, with_residuals=False):
    """The streamed #2's call: the flagship at NeRF depth ``L``, r``size`` x ``S``,
    fast_sin, f32 products, on ``path`` (or the plain version); returns
    (fn, stages_of)."""
    from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR
    from cips3d_tpu_torch.ops import ray_tile
    from cips3d_tpu_torch.tools.ray_tile_ab import _inputs

    gen = GeneratorNerfINR(GeneratorConfig(fused_ray=True, fused_inr=True, nerf_hidden_layers=L),
                           generator=torch.Generator().manual_seed(0)).eval()
    wt, args, _ = _inputs(gen, 1, size, S, 0.0, 500)
    wt, args = [w.to(dev) for w in wt], [a.to(dev) for a in args]

    def fn():
        with torch.no_grad():
            if plain:
                return ray_tile.ray_tile_plain(wt, *args, 0.0, fast_sin=True)
            return ray_tile.ray_tile_cuda(wt, *args, 0.0, fast_sin=True, path=path,
                                          mm_dtype=mm_dtype, with_residuals=with_residuals)

    esz = torch.finfo(mm_dtype).bits // 8
    return fn, lambda names: _ray_stages(names, 1, size * size, S, L, 128, 64, 32, esz)


def train_case(dev, kind="2r", L=3, plain=False):
    """#2r or #3 (``kind`` "residual" or "recompute") on the streamed path at
    the training shape (NeRF depth ``L``, r64, b = 4, S = 12, density noise
    0.5 as a device tensor), f32, or their plain versions; returns (fn,
    stages_of)."""
    from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR
    from cips3d_tpu_torch.ops import ray_tile
    from cips3d_tpu_torch.tools.ray_tile_ab import _inputs

    gen = GeneratorNerfINR(GeneratorConfig(fused_ray=True, fused_inr=True, nerf_hidden_layers=L),
                           generator=torch.Generator().manual_seed(0)).eval()
    wt, args, (d_fea, d_dep) = _inputs(gen, 4, 64, 12, 0.5, 501)
    noise = torch.full((), 0.5, device=dev)
    run = ray_tile.ray_tile_plain if plain else ray_tile.ray_tile_cuda
    res = None
    if kind == "residual":
        res = ray_tile.ray_tile_cuda(wt, *args, noise, with_residuals=True, path="streamed")[2]

    def fn():
        if kind == "2r":
            return run(wt, *args, noise, with_residuals=True,
                       **({} if plain else dict(path="streamed")))
        bwd = ray_tile.ray_tile_bwd_plain if plain else ray_tile.ray_tile_bwd_cuda
        return bwd(wt, *args, noise, d_fea, d_dep, residuals=res,
                   **({} if plain else dict(path="streamed")))

    if kind == "2r":
        return fn, lambda names: _ray_stages(names, 4, 64 * 64, 12, L, 128, 64, 32)
    return fn, lambda names: [(_short(nm), None, None) for nm in names]


def inr_case(dev, D=1024, n=64 * 64, in0=32, seed=0, path="streamed", plain=False):
    """The streamed #1's call at width ``D`` over ``n`` pixels (9 blocks),
    f32 products, on `tools/ray_tile_ab.py`'s seeded decode inputs; returns
    (fn, stages_of)."""
    from cips3d_tpu_torch.ops import inr_tile
    from cips3d_tpu_torch.tools.ray_tile_ab import _inr_inputs

    x, s, d, weights = _inr_inputs(D, n, 9, seed, in0)

    def fn():
        if plain:
            return inr_tile.inr_tile_plain(x, s, d, weights)
        return inr_tile.inr_tile_cuda(x, s, d, weights, path=path)

    return fn, lambda names: _inr_stages(names, 1, n, in0, D)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--variants", action="store_true", help="also split #2r and #3 (residual "
                   "mode) at the training shape")
    p.add_argument("--time", action="store_true", help="also time each call against its plain "
                   "version and the resident path")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stream_split: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cases = [("#2 streamed, depth 3, r128 x 24, f32", ray_case, {}),
             ("#1 streamed, D = 1024, r64, f32", inr_case, {})]
    if args.variants:
        cases += [("#2r streamed, depth 3, r64, b = 4 x 12, f32", train_case, dict(kind="2r")),
                  ("#3 residual streamed, depth 3, r64, b = 4 x 12, f32", train_case,
                   dict(kind="residual"))]
    for title, case, kw in cases:
        fn, stages_of = case(dev, **kw)
        print("\n".join(lines(title, split(fn, stages_of))), flush=True)
    if args.time:
        smi = torch.cuda.get_device_name(0)
        for title, case, kw, kw2 in (
                ("#2 depth 3 r128 x 24", ray_case, {}, {}),
                ("#2r depth 3 r64 b=4 x 12", train_case, dict(kind="2r"), {}),
                ("#3 residual depth 3 r64 b=4 x 12", train_case, dict(kind="residual"), {}),
                ("#3 recompute depth 3 r64 b=4 x 12", train_case, dict(kind="recompute"), {}),
                ("#2 flagship depth 2 r128 x 24", ray_case, dict(L=2), dict(L=2, path="resident")),
                ("#1 D = 1024 r64", inr_case, {}, {}),
                ("#1 D = 512 r128", inr_case, dict(D=512, n=128 * 128),
                 dict(D=512, n=128 * 128, path="resident"))):
            ref = case(dev, plain=True, **kw)[0] if not kw2 else case(dev, **kw2)[0]
            t = turns_ms([ref, case(dev, **kw)[0]])
            print(f"time {title}: streamed {t[1]:.3f} ms, "
                  f"{'plain' if not kw2 else 'resident'} {t[0]:.3f} ms [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
