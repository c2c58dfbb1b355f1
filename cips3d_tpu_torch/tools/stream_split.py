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
``--variants`` adds the split of #2r and of #3 in both modes at the
training shape (depth 3, r64, b = 4, S = 12, density noise 0.5, exact
sine; #2r and #3 residual also with the polynomial sine), and of the
resident #3 at the flagship's depth 2:
the backward's launches named by stage (the rgb product, the per-ray
kernels, each pass's d-input products, the weight grads, the final sums).
Beside each product stage it prints the time of one `torch.mm` over the
same shapes (f32, TF32 off: a yardstick only, which the port never calls;
for a weight-grad stage one X^T dQ product a matrix, summed).  With
``--time`` it also prints each call's median CUDA-event ms in turns with its
plain version (plain, kernel, kernel, plain), and the streamed against the
resident path at the flagship (#2 at depth 2, r128 x 24; #2r and #3 at depth
2, r64, b = 4 x 12; #1 at D = 512, r128).  Needs a CUDA device.
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
    """(stage, flops, bytes[, mm]) of each launch of the streamed forward,
    from the kernels' names in launch order: per pass a product a layer,
    sigma_rows and the head (colour FiLM and rgb head in one launch; with
    the exact sine and residuals each FiLM product followed by its sine
    launch, and the head as the colour product, its sine and the rgb
    product); any other launch by its kernel's name.  ``mm``: the (M, K,
    N, A transposed) shapes of the `torch.mm` yardstick of a product stage."""
    rows = b * n * S
    out, pass_, layer = [], 0, 0
    for nm in names:
        k, mode = _short(nm), _gemm_mode(nm)
        if k == "gemm_kernel" and layer == L and mode == 6:
            out.append((f"pass {pass_} colour FiLM product (K={H}, N={C})", 2 * rows * H * C,
                        esz * (rows * H + H * C) + 4 * rows * C, [(rows, H, C, False)]))
            layer += 1
            continue
        if k == "gemm_kernel" and layer > L and mode == 1:
            out.append((f"pass {pass_} rgb product (K={C}, N={R})", 2 * rows * C * R,
                        esz * (rows * C + C * R) + 4 * rows * R, [(rows, C, R, False)]))
            continue
        if k == "gemm_kernel" and layer < L:
            K, N = (16, H) if layer == 0 else (H, H)
            kin = 3 if layer == 0 else H
            stage = f"pass {pass_} layer {layer} product (K={K}, N={N})"
            flops = 2 * rows * kin * N
            nbytes = esz * (rows * kin + kin * N + rows * N)
            out.append((stage, flops, nbytes, [(rows, kin, N, False)]))
            layer += 1
            continue
        if k == "film_sine":
            w = H if layer <= L else C
            stage = f"pass {pass_} {'colour' if layer > L else f'layer {layer - 1}'} sine"
            flops, nbytes = None, (4 + esz) * rows * w
        elif k == "head_kernel":
            stage = f"pass {pass_} colour FiLM + rgb head (K={H}, N={C}; K={C}, N={R})"
            flops = 2 * rows * (H * C + C * R)
            nbytes = esz * (rows * H + H * C + C * R) + 4 * rows * R
            out.append((stage, flops, nbytes, [(rows, H, C, False), (rows, C, R, False)]))
            continue
        elif k == "sigma_rows":
            stage, flops, nbytes = f"pass {pass_} sigma_rows", 2 * rows * H, esz * rows * H + 4 * rows
        elif k == "rays_resample":
            stage, flops, nbytes = "rays_resample", None, None
            pass_, layer = pass_ + 1, 0
        else:
            stage, flops, nbytes = k, None, None
        out.append((stage, flops, nbytes))
    return out


def _gemm_mode(name):
    """The epilogue mode (stream_gemm.cuh's Mode) of a gemm_kernel launch's name."""
    m = re.search(r"gemm_kernel<(.*)>", name)
    return int(m.group(1).split(",")[-1]) if m else None


def _bwd_stages(names, b, n, S, L, H, C, R, esz=4):
    """(stage, flops, bytes[, mm]) of each launch of the streamed backward
    (recompute mode: the forward's launches first, through `_ray_stages`),
    from the kernels' names in launch order: the rgb product of both
    passes, the per-ray kernels, per pass (fine, then coarse) the d-input
    products (colour FiLM, layer L - 1 with d sigma, layers L - 2 .. 0) and
    the coarse pass's d pts product, the weight grads (one launch of every
    matrix, or one launch a matrix: w_0, w_1 .., wc with ws, wr) and the
    final sums; any other launch by its kernel's name."""
    if any(_short(nm) == "rays_composite" for nm in names):
        cut = [_short(nm) for nm in names].index("rays_composite") + 1
        return (_ray_stages(names[:cut], b, n, S, L, H, C, R, esz)
                + _bwd_stages(names[cut:], b, n, S, L, H, C, R, esz))
    rows, allr = b * n * S, 2 * b * n * S
    nchunk = -(-(n * S) // 128)
    dims = [(R, C, "colour")] + [(C, H, f"layer {L - 1}")] + [
        (H, H, f"layer {l}") for l in range(L - 2, -1, -1)]
    # (matrix, kin, nout, X and dQ columns read a point, on 64-column tiles)
    jobs = [("w_0", 3, H, 8, H, False)] + [(f"w_{l}", H, H, H, H, True) for l in range(1, L)] + [
        ("wc", H, C, H, C, C > 32), ("ws", H, 1, H, 8, False), ("wr", C, R, C, R, R > 32)]
    nw = sum(j[1] * j[2] for j in jobs)
    out, films = [], 0
    for nm in names:
        k, mode = _short(nm), _gemm_mode(nm)
        if k == "film_backward":   # the FiLM backward after its d-input product
            K, N, what = dims[(films - 1) % (L + 1)]
            out.append((f"pass {1 - (films - 1) // (L + 1)} d-input {what}, FiLM backward", None,
                        4 * rows * N * 2 + esz * rows * N + 4 * b * nchunk * 3 * N))
        elif k == "gemm_kernel" and mode == 1:
            out.append((f"rgb product, both passes (K={C}, N={R})", 2 * allr * C * R,
                        esz * (allr * C + C * R) + 4 * allr * R, [(allr, C, R, False)]))
        elif k == "gemm_kernel" and mode == 2:
            pass_ = 1 - films // (L + 1)
            K, N, what = dims[films % (L + 1)]
            films += 1
            nbytes = (esz * (rows * K + K * N + rows * N) + 4 * rows * N
                      + 4 * b * nchunk * 3 * N)   # the whole FiLM layer's backward
            out.append((f"pass {pass_} d-input {what} (K={K}, N={N})", 2 * rows * K * N, nbytes,
                        [(rows, K, N, False)]))
        elif k == "gemm_kernel" and mode == 3:
            out.append((f"pass 0 d pts (K={H}, N=3)", 2 * rows * H * 3,
                        esz * (rows * H + 3 * H) + 4 * rows * 3, [(rows, H, 3, False)]))
        elif k in ("wgrad_tiles", "wgrad_kernel"):
            # the parent's one launch of every matrix, or one launch a tile width (64, then 32)
            wide = re.search(r"wgrad_kernel<[^,]*, (\d+)>", nm)
            todo = [j for j in jobs if wide is None or j[5] == (wide.group(1) == "64")]
            label = ("weight grads, " + ("every matrix" if wide is None else
                     f"{wide.group(1)}-column tiles") + " (" + ", ".join(j[0] for j in todo) + ")")
            flops = sum(2 * allr * j[1] * j[2] for j in todo)
            nbytes = sum(esz * allr * (j[3] + j[4]) + 4 * j[1] * j[2] for j in todo)
            out.append((label, flops, nbytes, [(j[1], allr, j[2], True) for j in todo]))
        elif k in ("bwd_reduce", "col_sums", "bwd_gather"):
            nbytes = 4 * (-(-allr // 2048) * nw + 2 * b * nchunk * (3 * (L * H + C) + R + 1))
            out.append((f"final sums ({k})", None, nbytes if k == "bwd_reduce" else None))
        elif k == "sigma_rows":
            out.append(("sigma_rows, both passes", 2 * allr * H, esz * allr * H + 4 * allr))
        else:
            out.append((k, None, None))
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


def mm_ms(M, K, N, trans_a=False, reps=5, cache={}):
    """Median ms of one f32 `torch.mm` of an (M, K) by a (K, N) matrix
    (``trans_a``: A given as the transpose of a (K, M) matrix, as X^T dQ
    reads X), CUDA events, TF32 as the caller set it: the yardstick of a
    product stage, not a kernel of the port."""
    key = (M, K, N, trans_a)
    if key not in cache:
        a = torch.randn((K, M) if trans_a else (M, K), device="cuda")
        b = torch.randn((K, N), device="cuda")
        a = a.t() if trans_a else a
        cache[key] = turns_ms([lambda: torch.mm(a, b)], reps=reps)[0]
        del a, b
    return cache[key]


def split(fn, stages_of, calls=3, yardstick=False):
    """The launch-by-launch split of one call of ``fn``: a list of dicts
    (stage, kernel, us median over ``calls`` profiled calls, flops, bytes,
    TFLOP/s, GB/s, grid, block, regs, smem, est. warps per SM and, with
    ``yardstick``, the ms of `torch.mm` over a product stage's shapes)."""
    per_call = _trace_kernels(fn, calls)
    first = per_call[0]
    stages = stages_of([k["name"] for k in first])
    rows = []
    for i, (k, entry) in enumerate(zip(first, stages)):
        stage, flops, nbytes, *mm = entry
        us = statistics.median(c[i]["us"] for c in per_call)
        occ = k["occupancy_pct"]
        rows.append(dict(stage=stage, kernel=_short(k["name"]), us=us, flops=flops, bytes=nbytes,
                         tflops=flops / us / 1e6 if flops else None,
                         gbs=nbytes / us / 1e3 if nbytes else None, grid=k["grid"],
                         block=k["block"], regs=k["regs"], smem=k["smem"],
                         warps_per_sm=None if occ is None else occ / 100 * 64,
                         mm_ms=sum(mm_ms(*x) for x in mm[0]) if yardstick and mm else None))
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
        mm = "" if r.get("mm_ms") is None else f"; torch.mm {1e3 * r['mm_ms']:.1f} us"
        out.append(f"    {r['us']:9.1f} us  {r['stage']} [{r['kernel']}; grid {r['grid']}, block "
                   f"{r['block']}, {r['regs']} regs, {r['smem']} B shared, ~{warps} warps/SM]"
                   + rate + mm)
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


def train_case(dev, kind="2r", L=3, plain=False, fast_sin=False, path="streamed"):
    """#2r or #3 (``kind`` "residual" or "recompute") on ``path`` at the
    training shape (NeRF depth ``L``, r64, b = 4, S = 12, density noise 0.5
    as a device tensor), the exact or the polynomial sine, or their plain
    versions; returns (fn, stages_of)."""
    from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR
    from cips3d_tpu_torch.ops import ray_tile
    from cips3d_tpu_torch.tools.ray_tile_ab import _inputs

    gen = GeneratorNerfINR(GeneratorConfig(fused_ray=True, fused_inr=True, nerf_hidden_layers=L),
                           generator=torch.Generator().manual_seed(0)).eval()
    wt, args, (d_fea, d_dep) = _inputs(gen, 4, 64, 12, 0.5, 501)
    noise = torch.full((), 0.5, device=dev)
    run = ray_tile.ray_tile_plain if plain else ray_tile.ray_tile_cuda
    kw = dict(fast_sin=fast_sin, **({} if plain else dict(path=path)))
    res = None
    if kind == "residual":
        res = ray_tile.ray_tile_cuda(wt, *args, noise, with_residuals=True, path=path,
                                     fast_sin=fast_sin)[2]

    def fn():
        if kind == "2r":
            return run(wt, *args, noise, with_residuals=True, **kw)
        bwd = ray_tile.ray_tile_bwd_plain if plain else ray_tile.ray_tile_bwd_cuda
        return bwd(wt, *args, noise, d_fea, d_dep, residuals=res, **kw)

    stages = _ray_stages if kind == "2r" else _bwd_stages
    return fn, lambda names: stages(names, 4, 64 * 64, 12, L, 128, 64, 32)


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
    p.add_argument("--variants", action="store_true", help="also split #2r and #3 (both "
                   "modes; the exact and the polynomial sine) at the training shape and the "
                   "resident #3 at the flagship")
    p.add_argument("--time", action="store_true", help="also time each call against its plain "
                   "version and the resident path")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stream_split: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cases = [("#2 streamed, depth 3, r128 x 24, f32", ray_case, {}),
             ("#1 streamed, D = 1024, r64, f32", inr_case, {})]
    shape = "depth 3, r64, b = 4 x 12, f32"
    if args.variants:
        cases += [(f"#2r streamed, {shape}", train_case, dict(kind="2r")),
                  (f"#3 residual streamed, {shape}", train_case, dict(kind="residual")),
                  (f"#3 recompute streamed, {shape}", train_case, dict(kind="recompute"))]
        cases += [(f"#2r streamed, {shape}, fast_sin", train_case, dict(kind="2r", fast_sin=True)),
                  (f"#3 residual streamed, {shape}, fast_sin", train_case,
                   dict(kind="residual", fast_sin=True)),
                  ("#3 residual resident, depth 2 (the flagship), r64, b = 4 x 12, f32",
                   train_case, dict(kind="residual", L=2, path="resident"))]
    for title, case, kw in cases:
        fn, stages_of = case(dev, **kw)
        print("\n".join(lines(title, split(fn, stages_of, yardstick=args.time))), flush=True)
    if args.time:
        smi = torch.cuda.get_device_name(0)
        for title, case, kw, kw2 in (
                ("#2 depth 3 r128 x 24", ray_case, {}, {}),
                ("#2r depth 3 r64 b=4 x 12", train_case, dict(kind="2r"), {}),
                ("#3 residual depth 3 r64 b=4 x 12", train_case, dict(kind="residual"), {}),
                ("#3 recompute depth 3 r64 b=4 x 12", train_case, dict(kind="recompute"), {}),
                ("#2 flagship depth 2 r128 x 24", ray_case, dict(L=2), dict(L=2, path="resident")),
                ("#2r flagship depth 2 r64 b=4 x 12", train_case, dict(kind="2r", L=2),
                 dict(kind="2r", L=2, path="resident")),
                ("#3 residual flagship depth 2 r64 b=4 x 12", train_case,
                 dict(kind="residual", L=2), dict(kind="residual", L=2, path="resident")),
                ("#3 recompute flagship depth 2 r64 b=4 x 12", train_case,
                 dict(kind="recompute", L=2), dict(kind="recompute", L=2, path="resident")),
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
