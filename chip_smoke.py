#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`cips3d_tpu_torch`) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing one line (plus detail lines):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from `cips3d_tpu_torch/csrc/` (nvcc, sm_90a);
  3. hold each kernel against its plain PyTorch version on the same inputs
     at the serving shapes, in f32 and bf16, and bound the share of rays or
     pixels outside the stated tolerance; check that the bf16 kernels round
     where the plain versions do, against a control that does not; beside
     each density-noise case, print how far a float64 resample moves the
     plain version (the noisy f32 resample is ill-conditioned);
  4. build the flagship generator at the full width of `GeneratorConfig()`
     from the port's seeded init, answer requests through
     `RenderService.frame` and the HTTP server, check the outputs, check
     that both kernels were launched by that run, and hold a small frame
     against the plain path on the CPU;
  5. median times (CUDA events) of each kernel and its plain version, and
     frame latencies.
The second-to-last line is a JSON summary of the kernels, the last line
the device summary.  Any failed check raises, so the exit code is not 0.
Without CUDA (or without the package beside it) the script exits with an
error before printing any result.
"""

import copy
import json
import math
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

SERVING_STEPS = 24        # RenderService default: r128, 24 steps
# per element: |kernel - plain| <= atol + rtol * |plain|
TOL = {
    ("ray_tile", "float32"): dict(rtol=2e-4, atol=2e-5),    # the Pallas tests' kernel tolerance
    ("ray_tile", "bfloat16"): dict(rtol=1e-2, atol=5e-3),   # bf16-rounded matmul inputs, reordered sums
    # at init the ToRGB heads are tiny and the outputs |x| < 0.05: tighter atol
    ("inr_tile x1", "float32"): dict(rtol=2e-4, atol=2e-6),
    ("inr_tile x1", "bfloat16"): dict(rtol=1e-2, atol=1e-4),
    ("inr_tile x100", "float32"): dict(rtol=2e-4, atol=2e-5),
    ("inr_tile x100", "bfloat16"): dict(rtol=1e-2, atol=1e-2),
}
MAX_OUTSIDE = 1e-3        # share of rays/pixels allowed outside the tolerance
# A bf16 kernel rounds where the plain version rounds: its mean error against
# the bf16 plain version must be at most half its mean error against the f32
# plain version.  A kernel that skipped the rounding would be closer to f32.
BF16_CLOSER = 2.0
FRAME_ATOL = 1e-3         # end-to-end frame vs plain CPU path: 1/8 of an 8-bit level


def log(msg):
    print(msg, flush=True)


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def outside(got, ref, tol):
    """Rows (rays, pixels: the last axis is a row) with any element outside
    the tolerance."""
    err = (got.float() - ref.float()).abs()
    return (err > tol["atol"] + tol["rtol"] * ref.float().abs()).reshape(-1, got.shape[-1]).any(-1)


def compare(name, got, ref, tol, check=True):
    """Logs max/mean abs error and the share of rows outside the tolerance;
    with ``check``, raises if the output is not finite or that share is too
    large.  Returns (max abs error, mean abs error, share outside)."""
    import torch

    got, ref = got.float(), ref.float()
    if check and not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got - ref).abs()
    share = outside(got, ref, tol).float().mean().item()
    log(f"  {name}: max_abs_err {err.max().item():.3e} mean_abs_err {err.mean().item():.3e} "
        f"outside_tol {share:.2e} (rtol {tol['rtol']}, atol {tol['atol']}, bound {MAX_OUTSIDE})")
    if check and share > MAX_OUTSIDE:
        raise AssertionError(f"{name}: {share:.2e} of rows outside tolerance")
    return err.max().item(), err.mean().item(), share


def check_bf16(name, kernel_bf16, plain_bf16, plain_f32, kernel_f32, tol):
    """The bf16 kernel against the bf16 plain version (tolerance, rounding
    check), and the control: the f32 kernel, which skips the bf16 rounding,
    must fail the same checks."""
    _, mean_b, _ = compare(name, kernel_bf16, plain_bf16, tol)
    mean_f = (kernel_bf16.float() - plain_f32.float()).abs().mean().item()
    log(f"  {name}: mean_abs_err vs the f32 plain version {mean_f:.3e}, "
        f"{mean_f / max(mean_b, 1e-30):.1f}x the bf16 one (need >= {BF16_CLOSER})")
    if mean_b * BF16_CLOSER > mean_f:
        raise AssertionError(f"{name}: the kernel is not closer to the bf16 plain version")
    _, ctrl_b, ctrl_share = compare(name + " CONTROL (f32 kernel)", kernel_f32, plain_bf16, tol,
                                    check=False)
    ctrl_f = (kernel_f32.float() - plain_f32.float()).abs().mean().item()
    log(f"  {name} CONTROL: {ctrl_f / max(ctrl_b, 1e-30):.2g}x; fails the tolerance: "
        f"{ctrl_share > MAX_OUTSIDE}, fails the rounding check: {ctrl_b * BF16_CLOSER > ctrl_f}")
    if ctrl_share <= MAX_OUTSIDE and ctrl_b * BF16_CLOSER <= ctrl_f:
        raise AssertionError(f"{name}: the checks do not tell a kernel without bf16 rounding apart")


def cuda_ms(fns, reps=15, warmup=2):
    """Median ms per call of each function, timed with CUDA events in turns
    (a, b, b, a) so clocks and neighbours weigh on both alike."""
    import torch

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


def main():
    import torch

    # ---- phase 1: device ------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA GPU")
    from cips3d_tpu_torch.apps.render import render_chunked
    from cips3d_tpu_torch.apps.serve import RenderService, serve
    from cips3d_tpu_torch.models.generator import (GeneratorConfig, GeneratorNerfINR,
                                                   RenderOptions, sample_zs)
    from cips3d_tpu_torch.ops import build, inr_tile, ray_tile

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    log(f"phase 1 device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {torch.cuda.device_count()} device(s)")

    # ---- phase 2: build -------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    secs = build.build_seconds
    log(f"phase 2 build: {lib_path.name} in "
        f"{'%.1f s (nvcc)' % secs if secs is not None else 'cached'}; "
        f"load total {time.perf_counter() - t0:.1f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- the flagship generator at full width ----------------------------
    cfg = GeneratorConfig(fast_sin=True)
    gen = GeneratorNerfINR(cfg, generator=torch.Generator().manual_seed(0)).to(dev).eval()
    g = torch.Generator(dev).manual_seed(1)

    def world_and_styles(b, size, steps):
        zs = sample_zs(b, cfg, g, device=dev)
        with torch.no_grad():
            st = gen.mapping(zs["z_nerf"], zs["z_inr"])
        opts = RenderOptions(img_size=size, num_steps=steps, h_stddev=0.0, v_stddev=0.0)
        pos = torch.tensor([[0.3, 0.1, 0.95]], device=dev).repeat(b, 1)
        pos = pos / pos.norm(dim=-1, keepdim=True)
        return gen.sample_world(b, opts, g, pos, -pos), st

    # ---- phase 3: kernels vs plain versions ------------------------------
    log("phase 3 compare: kernel vs plain PyTorch version on the same inputs")
    err_at_main = {}
    f32, bf16 = torch.float32, torch.bfloat16
    with torch.no_grad():
        for S in (12, SERVING_STEPS):
            world, st = world_and_styles(1, 128, S)
            wt = ray_tile.flat_weights(gen.siren, st)
            for noise in (0.0, 0.5):
                draws = ray_tile.draw_ray_randoms(1, 128 * 128, S, noise != 0, g, dev)
                args = (wt, world.points, world.origins, world.dirs, world.z_vals[..., 0],
                        *draws, noise)
                for fs in ((True, False) if noise == 0 else (True,)):
                    tag = f"ray_tile S={S} noise={noise} fast_sin={fs}"
                    fa, da = ray_tile.ray_tile_cuda(*args, fast_sin=fs)
                    fb, db = ray_tile.ray_tile_plain(*args, fast_sin=fs)
                    e, _, _ = compare(tag + " float32 feature", fa, fb, TOL["ray_tile", "float32"])
                    compare(tag + " float32 depth", da, db, TOL["ray_tile", "float32"])
                    if S == SERVING_STEPS and noise == 0 and fs:
                        err_at_main["ray_tile"] = e
                    if noise:
                        # witness: the plain version with its fine depths from a float64
                        # run; the f32 resample under noise is ill-conditioned
                        d64 = [t.double() for t in (world.points, world.z_vals[..., 0],
                                                    draws.u, draws.nc)]
                        fz = ray_tile.plain_fine_depths([w.double() for w in wt], *d64, noise,
                                                        fast_sin=fs, mm_dtype=torch.float64)
                        fw, dw = ray_tile.ray_tile_plain(*args, fast_sin=fs, fine_z=fz.float())
                        tol = TOL["ray_tile", "float32"]
                        kern = (outside(fa, fb, tol) | outside(da, db, tol)).float().mean().item()
                        wit = (outside(fw, fb, tol) | outside(dw, db, tol)).float().mean().item()
                        log(f"  {tag}: rays outside the f32 tolerance: kernel {kern:.2e}; "
                            f"plain with float64 fine depths {wit:.2e}")
                    if not fs:
                        continue
                    outs = {mm: ray_tile.ray_tile_cuda(*args, fast_sin=fs, mm_dtype=mm, out_dtype=bf16)
                            for mm in (f32, bf16)}
                    plain = {mm: ray_tile.ray_tile_plain(*args, fast_sin=fs, mm_dtype=mm, out_dtype=bf16)
                             for mm in (f32, bf16)}
                    for i, part in ((0, "feature"), (1, "depth")):
                        check_bf16(f"{tag} bfloat16 {part}", outs[bf16][i], plain[bf16][i],
                                   plain[f32][i], outs[f32][i], TOL["ray_tile", "bfloat16"])
        world, st = world_and_styles(2, 64, 12)      # two samples: b = 2, 4096 pixels
        fea, _ = ray_tile.ray_tile_cuda(ray_tile.flat_weights(gen.siren, st), world.points,
                                        world.origins, world.dirs, world.z_vals[..., 0],
                                        *ray_tile.draw_ray_randoms(2, 4096, 12, False, g, dev),
                                        fast_sin=True)
        for b in (1, 2):
            weights, mods = inr_tile.extract_inr_weights(gen.inr_net, 9)
            s, d = inr_tile.compute_inr_mods(mods, {k: v[:b] for k, v in st.items()}, 512)
            x = fea[:b].contiguous()
            # at init the ToRGB heads are tiny (frequency_init(100)) and the output
            # sits near tanh(bias); x100 heads make the whole chain show in it
            for rgb_scale in (1, 100):
                w_s = weights._replace(wr=weights.wr * rgb_scale)
                outs = {mm: inr_tile.inr_tile_cuda(x, s, d, w_s, mm_dtype=mm) for mm in (f32, bf16)}
                plain = {mm: inr_tile.inr_tile_plain(x, s, d, w_s, mm_dtype=mm) for mm in (f32, bf16)}
                case = f"inr_tile x{rgb_scale}"
                tag = (f"inr_tile b={b} n=4096 D=512 blocks=9 ToRGB x{rgb_scale} "
                       f"(out {plain[f32].min().item():.3f}..{plain[f32].max().item():.3f})")
                e, _, _ = compare(tag + " float32", outs[f32], plain[f32], TOL[case, "float32"])
                if b == 1 and rgb_scale == 1:
                    err_at_main["inr_tile"] = e
                check_bf16(tag + " bfloat16", outs[bf16], plain[bf16], plain[f32], outs[f32],
                           TOL[case, "bfloat16"])

    # ---- phase 4: the serving path ----------------------------------------
    service = RenderService(gen, img_size=128, num_steps=SERVING_STEPS)
    service_r256 = RenderService(gen, img_size=256, num_steps=12)
    ray_tile.ray_tile_cuda.launches = 0
    inr_tile.inr_tile_cuda.launches = 0
    frames = [service.frame(seed=0), service.frame(seed=1),
              service.frame(seed=0, yaw=math.pi / 2 - 0.3),
              service.frame(seed=0, yaw=math.pi / 2 + 0.3),
              service.frame(seed=1, depth=True), service.frame(seed=2, psi=0.7),
              service_r256.frame(seed=0, psi=0.7)]
    img, dmap = service.render(seed=3, psi=1.0)
    moved = [service.render(seed=sd, yaw=yaw)[0] for sd, yaw in
             ((0, math.pi / 2), (1, math.pi / 2), (0, math.pi / 2 - 0.3))]
    httpd = serve(service, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        health = json.loads(urllib.request.urlopen(base + "/healthz", timeout=60).read())
        models = json.loads(urllib.request.urlopen(base + "/models", timeout=60).read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    torch.cuda.synchronize()
    launches = {"ray_tile": ray_tile.ray_tile_cuda.launches,
                "inr_tile": inr_tile.inr_tile_cuda.launches}
    import numpy as np

    for i, f in enumerate(frames):
        want = (256, 256, 3) if i == len(frames) - 1 else (128, 128, 3)
        if f.shape != want or f.dtype != np.uint8:
            raise AssertionError(f"frame {i}: {f.shape} {f.dtype}, want {want} uint8")
    if (frames[4][..., 0] != frames[4][..., 1]).any():
        raise AssertionError("depth frame is not grayscale")
    if torch.equal(moved[0], moved[1]) or torch.equal(moved[0], moved[2]):
        raise AssertionError("renders do not change with seed / yaw")
    if img.shape != (1, 3, 128, 128) or dmap.shape != (1, 1, 128, 128):
        raise AssertionError(f"render shapes {tuple(img.shape)} {tuple(dmap.shape)}")
    if not (torch.isfinite(img).all() and torch.isfinite(dmap).all()):
        raise AssertionError("render output is not finite")
    # expected depth sum(w * z) with sum(w) <= 1: between 0 and the far end of the rays
    if not (0.0 <= dmap.min().item() and dmap.max().item() <= 1.13):
        raise AssertionError(f"depth out of range: {dmap.min().item()}..{dmap.max().item()}")
    if health.get("device") != torch.cuda.get_device_name() or models["default"] != "default":
        raise AssertionError(f"/healthz or /models wrong: {health} {models}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path was not launched: {launches}")
    log(f"phase 4 serve: {len(frames)} frames (r128 x{SERVING_STEPS} steps, r256 x12, seeds 0-2, "
        f"yaws, depth, psi 0.7), /healthz {health['device']!r}, /models {models['models']}; "
        f"launches {launches}")

    # small frame against the plain path on the CPU (same weights, same draws)
    cpu_gen = copy.deepcopy(gen).cpu()
    gc = torch.Generator().manual_seed(5)
    zs = sample_zs(1, cfg, gc)
    opts = RenderOptions(img_size=32, num_steps=12, h_stddev=0.0, v_stddev=0.0)
    pos = torch.tensor([[0.2, 0.15, 0.968]])
    pos = pos / pos.norm()
    uniform = torch.rand((1, 32 * 32, 12, 1), generator=gc)
    draws = [ray_tile.draw_ray_randoms(1, 1024, 12, False, gc, "cpu")]
    with torch.no_grad():
        st_c = cpu_gen.mapping(zs["z_nerf"], zs["z_inr"])
        st_g = {k: v.to(dev) for k, v in st_c.items()}
        ref_img, ref_dep = render_chunked(cpu_gen, st_c, opts, None, 1024, pos, -pos,
                                          return_depth=True, perturb_uniform=uniform,
                                          chunk_draws=draws)
        got_img, got_dep = render_chunked(
            gen, st_g, opts, None, 1024, pos.to(dev), -pos.to(dev), return_depth=True,
            perturb_uniform=uniform.to(dev),
            chunk_draws=[ray_tile.RayDraws(*(t.to(dev) for t in draws[0]))])
    e_img = (got_img.cpu() - ref_img).abs()
    e_dep = (got_dep.cpu() - ref_dep).abs()
    share = (e_img > FRAME_ATOL).any(1).float().mean().item()
    log(f"  frame r32 x12 vs plain CPU path: max_abs_err {e_img.max().item():.3e} "
        f"depth {e_dep.max().item():.3e}; pixels outside atol {FRAME_ATOL}: {share:.2e}")
    if share > MAX_OUTSIDE or e_dep.max().item() > FRAME_ATOL:
        raise AssertionError("the kernel path disagrees with the plain path")

    # ---- phase 5: timings -------------------------------------------------
    timings = {}
    with torch.no_grad():
        world, st = world_and_styles(1, 128, SERVING_STEPS)
        wt = ray_tile.flat_weights(gen.siren, st)
        draws = ray_tile.draw_ray_randoms(1, 128 * 128, SERVING_STEPS, False, g, dev)
        args = (wt, world.points, world.origins, world.dirs, world.z_vals[..., 0], *draws)
        fea, _ = ray_tile.ray_tile_cuda(*args, fast_sin=True)
        weights, mods = inr_tile.extract_inr_weights(gen.inr_net, 9)
        s, d = inr_tile.compute_inr_mods(mods, st, 512)
        for mm in (torch.float32, torch.bfloat16):
            dn = str(mm).split(".")[1]
            kw = dict(mm_dtype=mm, fast_sin=True)
            timings[f"ray_tile {dn}"] = cuda_ms([lambda: ray_tile.ray_tile_plain(*args, **kw),
                                                 lambda: ray_tile.ray_tile_cuda(*args, **kw)])
            timings[f"inr_tile {dn}"] = cuda_ms(
                [lambda: inr_tile.inr_tile_plain(fea, s, d, weights, mm_dtype=mm),
                 lambda: inr_tile.inr_tile_cuda(fea, s, d, weights, mm_dtype=mm)])
    for k, (plain, kern) in timings.items():
        log(f"phase 5 time: {k} r128 x{SERVING_STEPS} (n=16384): kernel {kern:.3f} ms, "
            f"plain {plain:.3f} ms [{smi}]")
    lat = {}
    for name, svc, reps in (("r128 x24", service, 41), ("r256 x12", service_r256, 21)):
        svc.frame(seed=9)
        ts = []
        for i in range(reps):
            t0 = time.perf_counter()
            svc.frame(seed=9, yaw=math.pi / 2 + 0.01 * i)
            ts.append((time.perf_counter() - t0) * 1e3)
        lat[name] = statistics.median(ts)
        q = statistics.quantiles(ts, n=4)
        log(f"phase 5 time: frame latency {name} (host clock, to uint8 on host): "
            f"median {lat[name]:.2f} ms over {reps} (quartiles {q[0]:.2f}..{q[2]:.2f}, "
            f"min {min(ts):.2f}, max {max(ts):.2f}) [{smi}]")

    kernels = [
        {"name": "ray_tile", "route": "cuda", "source": "cips3d_tpu_torch/csrc/ray_tile.cu",
         "replaces": "cips3d_tpu/ops/pallas/ray_tile.py:137", "launches": launches["ray_tile"],
         "max_abs_err": err_at_main["ray_tile"], "ms": timings["ray_tile float32"][1],
         "plain_ms": timings["ray_tile float32"][0]},
        {"name": "inr_tile", "route": "cuda", "source": "cips3d_tpu_torch/csrc/inr_tile.cu",
         "replaces": "cips3d_tpu/ops/pallas/inr_tile.py:48", "launches": launches["inr_tile"],
         "max_abs_err": err_at_main["inr_tile"], "ms": timings["inr_tile float32"][1],
         "plain_ms": timings["inr_tile float32"][0]},
    ]
    log(nvidia_smi())   # the card's name and power limit, as nvidia-smi prints them
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
