#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`cips3d_tpu_torch`) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing one line (plus detail lines):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from `cips3d_tpu_torch/csrc/` (nvcc, sm_90a);
  3. hold each kernel against its plain PyTorch version on the same inputs
     at the serving shapes (the INR tile also at b = 2 with n ragged against
     its 64-pixel tile), in f32 and bf16, and bound the share of rays or
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
     frame latencies; beside the ray tile's and the INR tile's times their
     resident warps per SM (CUDA occupancy API), shared memory and the
     ptxas registers and spills;
  6. the training kernels at r64, b = 4, S = 12 (16384 rays): the INR tile
     on the D phase's features (density noise 1.0) against its plain
     version, and both against a float64 decode; at density noise 0 and
     0.5, f32 and bf16, the ray tile with residuals against its plain
     version (outputs and residuals), and the backward kernel in both modes
     (residual, exact sine; recompute, polynomial sine) against the plain
     backward and against autograd of the plain forward: weight and FiLM
     grads by the normalised error max|a-b| / (max|b| + 1), d pts per ray,
     two runs bit for bit, bf16 against an f32-kernel control; without noise
     the f32 kernel at most F64_RATIO times as far from a float64 run of the
     plain backward as the f32 plain backward; beside each noise case a
     float64-resample witness;
  7. training at the flagship's full width, r64, b = 4, aux on: 10 steps of
     the exact-sine config (ray tile with residuals + residual backward in
     the G phase), of the polynomial-sine config (recompute backward) and
     of the shipped config (configs/ffhq.yaml: fast_sin, the G phase
     through the unfused NeRF stage, the D phase on the ray tile and the
     INR tile); losses finite, G, D and EMA move, every kernel of each path
     launched; then one r32, b = 2 step on the card against the same step
     on the CPU (same weights, same draws), exact sine and shipped, without
     density noise and with 1.0, shipped without hierarchical sampling, and
     with train_r256's settings (freeze_nerf, DiffAug with the same draws,
     warmup_d, aux off, no noise): the D
     phase's fakes, losses, clipped grads, parameters after Adam; with noise
     the INR tile on that step's D-phase features, and a witness (the CPU
     step with its D-phase fakes moved by rounding-sized noise); then
     train_r256's settings at r256, b = 4: one warm-up and three timed
     steps with the peak device memory;
  8. median step time and images/s of the r64 configs, each with a profiled
     step (device busy time summed over kernels, copies and sets; the
     record_function ranges listed apart), and the median CUDA event times
     of the training kernels beside their plain versions, each with the
     warps per SM, shared memory, registers and spills of the kernels it
     launches;
  9. the training CLI in subprocesses at full width on a synthetic blob zip:
     `train_r32 --debug`, then `train_r64 --debug` finetuning from it (step
     and FID lines, text logs, JAX-layout snapshots), and r64's G_ema
     served through `RenderService` on the card;
 10. the variant pipelines at full width (configs/diffcam.yaml: G, D with
     max_size 1024 and the learnable camera, r64, b = 4, aux on;
     configs/pigan.yaml: the 256-wide FiLM-SIREN and the encoder D, r64,
     b = 7): 10 steps each (losses finite, G, D, EMA and the camera move,
     no port kernel launched; median step time, images/s, peak memory)
     and a profiled step each (as phase 8's);
     one r32, b = 2 step of each on the card against the CPU, without
     density noise and with 1.0 (phase 7's tolerances and witness rule);
     their CLI in subprocesses on phase 9's zip (diffcam `train_r32
     --debug`, then `train_r64 --debug` finetuning from it, `cam_param` and
     `cam_opt` in the trees; pi-GAN `train_r32 --debug`); and the first two
     `FFHQ_STAGES` through `run_progressive` under debug (stage 2 loads stage
     1's best_fid).
Phase 4 also fetches /render and /render?depth=1 and checks the JPEGs.
The second-to-last line is a JSON summary of the kernels (with each one's
bound on the card: the larger of its multiply-adds over the 67 TFLOP/s f32
FMA peak and its bytes over 3.35 TB/s), the last line the device summary.
Any failed check raises, so the exit code is not 0.
Without CUDA (or without the package beside it) the script exits with an
error before printing any result.
"""

import copy
import json
import math
import re
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
# backward: weight and FiLM grads by max|a-b| / (max|b| + 1) (tests/test_pallas_ray.py);
# d pts per ray, any element beyond D_PTS_TOL * (max|b| + 1) puts the ray outside
BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
D_PTS_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
STEP_TOL = dict(loss_rtol=1e-4, grad=3e-4, param=2e-2)   # card step vs CPU step, as the CPU tests
# The INR-tile kernel on the D phase's features (max abs error) and the ray-tile backward at
# density noise 0 (normalised grad error): at most this multiple of the f32 plain version's
# distance from a float64 run of the plain version
F64_RATIO = 2.0
SHIPPED = "shipped: fast_sin, unfused G phase"            # configs/ffhq.yaml's generator
R256 = "train_r256: freeze_nerf, DiffAug, warmup_d, aux off"   # the r256 stage's settings
F32_PEAK = 67e12          # FLOP/s, f32 FMA outside the tensor cores (H100 SXM data sheet)
HBM_RATE = 3.35e12        # B/s


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


def grad_err(a, b):
    """max|a - b| / (max|b| + 1) of one gradient leaf."""
    a, b = a.detach().double(), b.detach().double()
    return ((a - b).abs().max() / (b.abs().max() + 1)).item()


def max_grad_err(ga, gb):
    return max(grad_err(a, b) for a, b in zip(ga, gb))


def rays_outside(a, b, tol):
    """Share of rays (the first two axes) with any element beyond
    tol * (max|b| + 1)."""
    err = (a.detach().double() - b.detach().double()).abs()
    bound = tol * (b.detach().double().abs().max() + 1)
    return (err > bound).reshape(a.shape[0] * a.shape[1], -1).any(-1).double().mean().item()


def bound_ms(flops, nbytes):
    """The least time on the card: (ms, what bounds it)."""
    t_ops, t_bytes = flops / F32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def siren_macs(H, L, C, R):
    """Multiply-adds of the FiLM-SIREN per point."""
    return 3 * H + (L - 1) * H * H + H * C + C * R + H


def ptxas_resources(text):
    """{entry function: (registers, spill store bytes, spill load bytes)}
    from the build log of `nvcc -Xptxas -v`."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            out[cur] = (None, int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur in out:
            out[cur] = (int(m.group(1)),) + out[cur][1:]
    return out


# the kernels of each timed entry: (occupancy key, mangled-name pattern of its build)
KERNEL_PARTS = {
    "inr_tile float32": [("inr_tile float32", r"inr_tile_kernelIfE")],
    "inr_tile bfloat16": [("inr_tile bfloat16", r"inr_tile_kernelI13__nv_bfloat16E")],
    "ray_tile": [("ray_tile", r"ray_tile_kernelIfLb0E")],
    "ray_tile_residuals": [("ray_tile_residuals", r"ray_tile_kernelIfLb1E")],
    "ray_tile_bwd_residual": [("ray_tile_bwd_cot", r"ray_tile_bwd_cotIfE"),
                              ("ray_tile_bwd_wgrad", r"ray_tile_bwd_wgradIfE")],
    "ray_tile_bwd_recompute": [("ray_tile_residuals", r"ray_tile_kernelIfLb1E"),
                               ("ray_tile_bwd_cot", r"ray_tile_bwd_cotIfE"),
                               ("ray_tile_bwd_wgrad", r"ray_tile_bwd_wgradIfE")],
}


def resources_line(entry, occ, ptxas):
    """Resident warps per SM (CUDA occupancy API), shared memory and the
    ptxas registers and spills of each kernel an entry launches (the ray
    tile's in f32)."""
    parts = []
    for key, pat in KERNEL_PARTS[entry]:
        warps, smem, threads = occ[key]
        regs = [v for k, v in ptxas.items() if re.search(pat, k)]
        r = (f"{regs[0][0]} registers, spills {regs[0][1]}/{regs[0][2]} B" if regs
             else "ptxas report not found")
        parts.append(f"{key}: {warps} warps/SM ({threads} threads, {smem / 1024:.1f} KB shared), {r}")
    return "; ".join(parts)


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


def kernel_phase(dev, log):
    """Phase 6: the training kernels against their plain versions at r64,
    b = 4, S = 12.  Returns the f32 max abs errors of the main-path cases."""
    import torch

    from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR, RenderOptions
    from cips3d_tpu_torch.models.generator import sample_zs
    from cips3d_tpu_torch.ops import ray_tile as rt

    f32, bf16 = torch.float32, torch.bfloat16
    b, S, n = 4, 12, 64 * 64
    gen = GeneratorNerfINR(GeneratorConfig(fused_ray=True),
                           generator=torch.Generator().manual_seed(10)).to(dev)
    g = torch.Generator(dev).manual_seed(11)
    with torch.no_grad():
        zs = sample_zs(b, gen.cfg, g, device=dev)
        st = gen.mapping(zs["z_nerf"], zs["z_inr"])
        world = gen.sample_world(b, RenderOptions(img_size=64, num_steps=S), g)
        wt = [w.detach() for w in rt.flat_weights(gen.siren, st)]
    errs = {}
    log(f"phase 6 compare: training kernels, r64 b={b} S={S} ({b * n} rays), flagship widths")
    with torch.no_grad():   # the D phase at step 0: exact sine, density noise 1.0
        draws = rt.draw_ray_randoms(b, n, S, True, g, dev)
        fea, _ = rt.ray_tile_cuda(wt, world.points, world.origins, world.dirs,
                                  world.z_vals[..., 0], *draws, 1.0)
        inr_check(f"r64 b={b} noise 1.0", gen.inr_net, st, fea)
    for mode, fs in (("residual", False), ("recompute", True)):
        for noise in (0.0, 0.5):
            draws = rt.draw_ray_randoms(b, n, S, noise != 0, g, dev)
            args = (wt, world.points, world.origins, world.dirs, world.z_vals[..., 0], *draws,
                    noise)
            d_fea = torch.randn((b, n, 32), generator=g, device=dev)
            d_dep = torch.randn((b, n, 1), generator=g, device=dev)
            tag = f"{mode} fast_sin={fs} noise={noise}"
            witness = None
            if noise:   # the plain backward with fine depths from a float64 resample
                d64 = [t.double() for t in (world.points, world.z_vals[..., 0], draws.u, draws.nc)]
                fz = rt.plain_fine_depths([w.double() for w in wt], *d64, noise, fast_sin=fs,
                                          mm_dtype=torch.float64)
                witness = rt.ray_tile_bwd_plain(*args, d_fea, d_dep, fast_sin=fs,
                                                fine_z=fz.float())
            out = {}
            for mm in (f32, bf16):
                dn = str(mm)[6:]
                res = None
                if mode == "residual":   # kernel #2r: outputs and residuals
                    fa, da, res = rt.ray_tile_cuda(*args, fast_sin=fs, mm_dtype=mm,
                                                   with_residuals=True)
                    fb, db, rp = rt.ray_tile_plain(*args, fast_sin=fs, mm_dtype=mm,
                                                   with_residuals=True)
                    tol = TOL["ray_tile", dn]
                    e, _, _ = compare(f"2r {tag} {dn} feature", fa, fb, tol)
                    compare(f"2r {tag} {dn} depth", da, db, tol)
                    # pre-activations reach |a| ~ 20: the tolerance's atol scaled to them
                    rtol = dict(rtol=tol["rtol"], atol=tol["atol"] * 20)
                    for name, x, y in zip(("rh", "ra", "rhc", "rac"), res, rp):
                        if x.dtype != y.dtype or x.shape != y.shape:
                            raise AssertionError(f"2r residual {name}: {x.dtype} {tuple(x.shape)}")
                        compare(f"2r {tag} {dn} {name} (points)", x, y, rtol)
                    if mm == f32 and noise == 0:
                        errs["ray_tile_residuals"] = e
                    out[mm, "fwd"] = (fa, fb)
                ga, pa = rt.ray_tile_bwd_cuda(*args, d_fea, d_dep, residuals=res, fast_sin=fs,
                                              mm_dtype=mm)
                gb, pb = rt.ray_tile_bwd_plain(*args, d_fea, d_dep, residuals=res, fast_sin=fs,
                                               mm_dtype=mm)
                torch.cuda.synchronize()
                out[mm] = (ga, gb)
                ge = max_grad_err(ga, gb)
                share = rays_outside(pa, pb, D_PTS_TOL[dn])
                line = (f"  3 {tag} {dn}: grads normalised err {ge:.2e} (tol {BWD_TOL[dn]}); "
                        f"d_pts rays outside {share:.2e} (bound {MAX_OUTSIDE}); max abs err "
                        f"{max((a - b_).abs().max().item() for a, b_ in zip(ga, gb)):.3e}")
                wit_ge = wit_share = None
                if witness is not None and mm == f32:
                    wit_ge = max_grad_err(witness[0], gb)
                    wit_share = rays_outside(witness[1], pb, D_PTS_TOL[dn])
                    line += (f"; float64-resample witness: grads {wit_ge:.2e}, d_pts rays "
                             f"outside {wit_share:.2e}")
                log(line)
                if not all(torch.isfinite(t).all() for t in ga + [pa]):
                    raise AssertionError(f"3 {tag} {dn}: non-finite grads")
                # a miss under noise counts only if the witness does not part as well
                if ge > BWD_TOL[dn] and not (wit_ge is not None and wit_ge >= BWD_TOL[dn]):
                    raise AssertionError(f"3 {tag} {dn}: grads outside tolerance")
                if share > MAX_OUTSIDE and not (wit_share is not None and wit_share >= MAX_OUTSIDE):
                    raise AssertionError(f"3 {tag} {dn}: d_pts rays outside tolerance")
                if mm == f32:
                    if noise == 0:
                        errs[f"ray_tile_bwd_{mode}"] = max(
                            (a - b_).abs().max().item() for a, b_ in zip(ga, gb))
                        # both against a float64 run of the plain backward
                        g64, _ = rt.ray_tile_bwd_plain(
                            [w.double() for w in wt], *[t.double() for t in args[1:8]], 0.0,
                            d_fea.double(), d_dep.double(), residuals=res, fast_sin=fs,
                            mm_dtype=torch.float64)
                        ek, ep = max_grad_err(ga, g64), max_grad_err(gb, g64)
                        log(f"  3 {tag} float32 vs a float64 plain backward: normalised grad "
                            f"err kernel {ek:.2e}, plain {ep:.2e} ({ek / max(ep, 1e-30):.2f}x, "
                            f"need <= {F64_RATIO})")
                        del g64
                        if ek > F64_RATIO * ep:
                            raise AssertionError(f"3 {tag}: the kernel is further from float64 "
                                                 f"than {F64_RATIO}x the plain backward")
                    again = rt.ray_tile_bwd_cuda(*args, d_fea, d_dep, residuals=res,
                                                 fast_sin=fs, mm_dtype=mm)
                    same = all(torch.equal(x, y) for x, y in zip(ga + [pa], again[0] + [again[1]]))
                    # the plain backward against autograd through the plain forward
                    leaves = [w.clone().requires_grad_() for w in wt]
                    with torch.enable_grad():
                        fea, dep = rt.ray_tile_plain(leaves, *args[1:], fast_sin=fs)
                        auto = torch.autograd.grad((fea, dep), leaves, (d_fea, d_dep))
                    ae = max_grad_err(gb, auto)
                    log(f"  3 {tag} float32: two runs bitwise equal: {same}; plain backward vs "
                        f"autograd of the plain forward {ae:.2e}; kernel vs autograd "
                        f"{max_grad_err(ga, auto):.2e}")
                    if not same or ae > BWD_TOL["float32"]:
                        raise AssertionError(f"3 {tag}: not deterministic, or plain vs autograd")
            # bf16: the f32 kernel (no rounding) is the control and must fail the bf16 tolerance
            ctrl = max_grad_err(out[f32][0], out[bf16][1])
            log(f"  3 {tag} bfloat16 CONTROL (f32 kernel vs bf16 plain): {ctrl:.2e}, fails "
                f"{BWD_TOL['bfloat16']}: {ctrl > BWD_TOL['bfloat16']}")
            if ctrl <= BWD_TOL["bfloat16"]:
                raise AssertionError(f"3 {tag}: the bf16 tolerance does not see the rounding")
            if mode == "residual":
                fa32, fb32 = out[f32, "fwd"]
                fa16, fb16 = out[bf16, "fwd"]
                check_bf16(f"2r {tag} bfloat16 feature", fa16, fb16, fb32, fa32,
                           TOL["ray_tile", "bfloat16"])
    return errs


def is_annotation(e):
    """A `record_function` range (a user annotation), not a kernel."""
    return bool(getattr(e, "is_user_annotation", False)) or re.match(
        r"(Optimizer\.\w+#|ProfilerStep#)", e.key) is not None


def step_snapshot(state):
    import torch

    return [[p.detach().clone() for p in m.parameters()]
            for m in (state.generator, state.discriminator, state.ema)]


def profile_step(fn, state, real, rng, log, label, smi, phase=8):
    """One more step under `torch.profiler`: the device time by operation,
    and the device's busy share of the step's host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(state, real, rng=rng)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0)
    # the device's own events (kernels, copies, sets): an operator's device time is also
    # credited to the host-side event that launched it, so those are not summed.  A
    # record_function range (Optimizer.step#Adam.step) shows on the device timeline as a
    # user annotation spanning the kernels inside it and the gaps between them: it is
    # listed apart and not summed either.
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    ranges = [e for e in events if is_annotation(e)]
    kernels = [e for e in events if not is_annotation(e)]
    busy = sum(dev_us(e) for e in kernels) / 1e3
    log(f"phase {phase} profile: train step {label}: {wall:.1f} ms on the host clock (profiled), "
        f"device busy {busy:.1f} ms = {100 * busy / wall:.1f} %, idle "
        f"{100 - 100 * busy / wall:.1f} %, {sum(e.count for e in kernels)} device events "
        f"[{smi}]; device time by kernel:")
    for e in sorted(kernels, key=dev_us, reverse=True)[:10]:
        log(f"    {dev_us(e) / 1e3:8.2f} ms {e.count:5d} x {e.key[:90]}")
    log("  record_function ranges on the device timeline (spans, not summed): " + (", ".join(
        f"{e.key[:60]} {dev_us(e) / 1e3:.2f} ms over {e.count}" for e in ranges) or "none"))


# each kernel's launch counter: (wrapper, attribute, the name the checks use)
KERNEL_COUNTERS = (("ray_tile_cuda", "launches", "ray_tile"),
                   ("ray_tile_cuda", "residual_launches", "ray_tile_residuals"),
                   ("ray_tile_bwd_cuda", "launches", "ray_tile_bwd_recompute"),
                   ("ray_tile_bwd_cuda", "residual_launches", "ray_tile_bwd_residual"),
                   ("inr_tile_cuda", "launches", "inr_tile"))


def _wrapper(name):
    from cips3d_tpu_torch.ops import inr_tile, ray_tile

    return getattr(inr_tile if name.startswith("inr") else ray_tile, name)


def kernel_counts():
    """Every kernel's launch count since the counters were last zeroed."""
    return {name: getattr(_wrapper(w), a) for w, a, name in KERNEL_COUNTERS}


def zero_kernel_counts():
    for w, a, _ in KERNEL_COUNTERS:
        setattr(_wrapper(w), a, 0)


def train_run(dev, cfg_g, steps, log, label="", smi="", tcfg=None, disc_kwargs=None,
              aux_reg=True, profile=True):
    """Phase 7: `steps` training steps (by default r64, b = 4, aux on);
    returns (host times per step in ms, launch counts, peak device memory
    in bytes); then, with ``profile``, profiles one more step."""
    import torch

    from cips3d_tpu_torch.models.discriminator import DiscriminatorMultiScaleAux
    from cips3d_tpu_torch.models.generator import GeneratorNerfINR, RenderOptions
    from cips3d_tpu_torch.train.state import TrainConfig
    from cips3d_tpu_torch.train.step import init_train_state, make_train_step

    gen = GeneratorNerfINR(cfg_g, generator=torch.Generator().manual_seed(20)).to(dev)
    disc = DiscriminatorMultiScaleAux(max_size=1024, **(disc_kwargs or {}),
                                      generator=torch.Generator().manual_seed(21)).to(dev)
    tcfg = tcfg or TrainConfig(img_size=64, batch_size=4, ema_start_itr=0)
    state = init_train_state(gen, disc, tcfg)
    fn = make_train_step(gen, disc, tcfg, RenderOptions(), aux_reg=aux_reg)
    rng = torch.Generator(dev).manual_seed(22)
    b, img = tcfg.batch_size, tcfg.img_size
    real = torch.rand((steps, b, 3, img, img), generator=rng, device=dev) * 2 - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = step_snapshot(state)
    zero_kernel_counts()
    times, metrics = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = fn(state, real[i], rng=rng)   # the metrics' floats wait for the step
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    for i, m in enumerate(metrics):
        if not all(math.isfinite(v) for v in m.values()) or m["d_finite"] != 1 or m["g_finite"] != 1:
            raise AssertionError(f"step {i}: non-finite metrics {m}")
    moved = [any(not torch.equal(a, b) for a, b in zip(x, y))
             for x, y in zip(before, step_snapshot(state))]
    if not all(moved):
        raise AssertionError(f"parameters did not move (G, D, EMA): {moved}")
    first, last = metrics[0], metrics[-1]
    log(f"  losses step 0 -> {steps - 1}: d {first['d_loss']:.4f} -> {last['d_loss']:.4f}, "
        f"g {first['g_loss']:.4f} -> {last['g_loss']:.4f}, r1 {first['grad_penalty']:.4f} -> "
        f"{last['grad_penalty']:.4f}, norms d {last['d_total_norm']:.3f} g "
        f"{last['g_total_norm']:.3f}; G, D and EMA moved; launches {counts}")
    if profile:
        profile_step(fn, state, real[-1], rng, log, label, smi)
    return times, counts, peak


def inr_check(tag, inr_net, style, fea):
    """Kernel #1 against its plain version on the D phase's own features
    (f32, the ToRGB heads as they are), and both against a float64 decode
    of the same inputs; raises if the kernel is further than F64_RATIO
    times the plain version from float64.  Returns the max abs error."""
    import torch

    from cips3d_tpu_torch.ops import inr_tile

    weights, mods = inr_tile.extract_inr_weights(inr_net, inr_tile.num_blocks(1024))
    s, d = inr_tile.compute_inr_mods(mods, style, weights.wrest.shape[-1])
    x = fea.float().contiguous()
    got = inr_tile.inr_tile_cuda(x, s, d, weights)
    ref = inr_tile.inr_tile_plain(x, s, d, weights)
    exact = inr_tile.inr_tile_plain(x, s, d, weights, mm_dtype=torch.float64)
    tag = (f"1 inr_tile D-phase features {tag} (|x| <= {x.abs().max().item():.3f}, out "
           f"{ref.min().item():.4f}..{ref.max().item():.4f}) float32")
    e, _, _ = compare(tag, got, ref, TOL["inr_tile x1", "float32"])
    ek = (got.double() - exact).abs().max().item()
    ep = (ref.double() - exact).abs().max().item()
    log(f"  {tag}: max abs err against a float64 decode: kernel {ek:.3e}, plain {ep:.3e} "
        f"({ek / max(ep, 1e-30):.1f}x, need <= {F64_RATIO})")
    if ek > F64_RATIO * ep:
        raise AssertionError(f"{tag}: the kernel is further from float64 than the plain version")
    return e


def to_device(x, d):
    """Tensors of nested dicts, lists and tuples (NamedTuples too) moved to
    ``d``; anything else passes through."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(d)
    if isinstance(x, dict):
        return {k: to_device(v, d) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        items = [to_device(v, d) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
    return x


def step_vs_cpu(dev, log, noise, cfg=None, label="exact sine, residual backward",
                tcfg_kw=None, disc_kw=None, aux=True, opts_kw=None):
    """Phase 7b: one r32, b = 2 step at full width (by default exact sine,
    residual backward; else ``cfg``, the TrainConfig fields ``tcfg_kw``,
    the discriminator's ``disc_kw``, ``aux`` and the RenderOptions fields
    ``opts_kw``), density noise ``noise``
    at step 0, on the card (kernels) and on the CPU (plain versions) from
    the same weights and draws (DiffAug's too).  With noise
    it first holds the INR-tile kernel against its plain version on this
    step's D-phase features.  The D phase's fakes of the two steps are held
    to the ray tile's f32 tolerance.  With noise it also runs the witness:
    the CPU step again with its D-phase fakes moved by Gaussian noise as
    large (rms) as the card's fakes differ from the CPU's.  Returns the gaps
    (losses rel err, D grads, G grads, G, D, EMA shares of parameters off)
    of the card step, and of the witness (None without noise), from the CPU
    step."""
    import copy

    import torch

    import cips3d_tpu_torch.train.step as step_mod
    from cips3d_tpu_torch.models.discriminator import (DiscriminatorMultiScaleAux,
                                                       draw_disc_diffaug)
    from cips3d_tpu_torch.models.generator import (ForwardDraws, GeneratorConfig,
                                                   GeneratorNerfINR, RenderOptions, sample_zs)
    from cips3d_tpu_torch.ops import ray_tile
    from cips3d_tpu_torch.train.state import TrainConfig
    from cips3d_tpu_torch.train.step import (PhaseDraws, StepDraws, init_train_state,
                                             make_train_step)

    b, img, S = 2, 32, 12
    cfg = cfg or GeneratorConfig(fused_ray=True, fused_ray_vjp="pallas_residual")
    tcfg = TrainConfig(**dict(dict(img_size=img, batch_size=b, ema_start_itr=0,
                                   nerf_noise_disable=noise == 0), **(tcfg_kw or {})))
    gc = torch.Generator().manual_seed(30)
    gen = GeneratorNerfINR(cfg, generator=torch.Generator().manual_seed(31))
    disc = DiscriminatorMultiScaleAux(max_size=1024, **(disc_kw or {}),
                                      generator=torch.Generator().manual_seed(32))
    n_d = b * (2 if aux else 1)   # D's batch: [inr | aux] fakes, the reals doubled
    ropts = RenderOptions(**(opts_kw or {}))

    def phase_draws(d_phase):
        da = {}
        if disc.main_disc.diffaug:   # the same DiffAug draws on the card and the CPU
            da["diffaug"] = draw_disc_diffaug(n_d, img, aux, gc)
            if d_phase:
                da["diffaug_real"] = draw_disc_diffaug(n_d, img, aux, gc)
        return PhaseDraws(sample_zs(b, cfg, gc), ForwardDraws(
            torch.rand((b, img * img, S, 1), generator=gc),
            (torch.randn((b, 1), generator=gc), torch.randn((b, 1), generator=gc)),
            ray_tile.draw_ray_randoms(b, img * img, S, True, gc, "cpu",
                                      hierarchical=ropts.hierarchical_sample)), **da)

    draws = StepDraws([phase_draws(True)], [phase_draws(False)])

    if noise:   # the D phase's features, as its generator forward computes them
        g_card, pd = copy.deepcopy(gen).to(dev), to_device(draws.d[0], dev)
        opts = RenderOptions(img_size=img, nerf_noise=noise)
        with torch.no_grad():
            style = g_card.mapping(pd.zs["z_nerf"], pd.zs["z_inr"])
            world = g_card.sample_world(b, opts, perturb_uniform=pd.forward.perturb,
                                        camera_draws=pd.forward.camera)
            fea, _ = ray_tile.fused_ray_render(
                g_card.siren, style, world.points, world.origins, world.dirs, world.z_vals,
                draws=pd.forward.rays, noise_std=noise, fast_sin=cfg.fast_sin)
            inr_check(f"r{img} b={b} noise {noise} (the step's)", g_card.inr_net, style, fea)

    real = torch.rand((b, 3, img, img), generator=gc) * 2 - 1
    results = {}
    clip = step_mod.clip_and_guard
    fakes = {}

    def d_phase_fakes(name, move=None):
        """Forward hook: keeps the D phase's fakes (the generator's call
        without gradient) and adds ``move`` to them."""
        def hook(module, inputs, out):
            if torch.is_grad_enabled():
                return None
            fakes[name] = out[0].detach().cpu()
            return None if move is None else (out[0] + move.to(out[0].device), out[1])
        return hook

    cpu = torch.device("cpu")
    for name, d in (("cpu", cpu), ("card", dev), ("witness", cpu)):
        move = None
        if name == "witness":
            if not noise:
                break
            rms = (fakes["card"] - fakes["cpu"]).pow(2).mean().sqrt().item()
            move = rms * torch.randn(fakes["cpu"].shape, generator=torch.Generator().manual_seed(33))
        g_m, d_m = copy.deepcopy(gen).to(d), copy.deepcopy(disc).to(d)
        hook = g_m.register_forward_hook(d_phase_fakes(name, move))
        state = init_train_state(g_m, d_m, tcfg)
        seen = []

        def recording(grads, max_norm):
            out = clip(grads, max_norm)
            seen.append([x.detach().cpu() for x in out[0]])
            return out

        step_mod.clip_and_guard = recording
        try:
            fn = make_train_step(g_m, d_m, tcfg, ropts, aux_reg=aux)
            t0 = time.perf_counter()
            state, m = fn(state, real.to(d), draws=to_device(draws, d))
            secs = time.perf_counter() - t0
        finally:
            step_mod.clip_and_guard = clip
            hook.remove()
        results[name] = (m, seen, step_snapshot(state), secs)
        if name == "card":
            compare(f"step r{img} b={b} {label} noise {noise}: D-phase fakes, card vs CPU",
                    fakes["card"].permute(0, 2, 3, 1), fakes["cpu"].permute(0, 2, 3, 1),
                    TOL["ray_tile", "float32"])
    names = [n for n, _ in gen.named_parameters()]

    def gap(name):
        """The losses' largest rel err, the clipped D and G grads' normalised
        errors, and the shares of G, D and EMA parameters beyond
        STEP_TOL["param"] * lr, of run ``name`` against the CPU step."""
        (mc, sc, pc, tc), (mg, sg, pg, _) = results["cpu"], results[name]
        lerr = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-6)
                   for k in ("d_loss", "g_loss", "grad_penalty"))
        gerr = [max(grad_err(a, b_) for a, b_ in zip(x, y)) for x, y in zip(sg, sc)]
        worst = sorted(((grad_err(a, b_), n) for n, a, b_ in zip(names, sg[1], sc[1])),
                       reverse=True)
        shares = []
        for lr, x, y in ((tcfg.gen_lr, pg[0], pc[0]), (tcfg.disc_lr, pg[1], pc[1]),
                         (tcfg.gen_lr, pg[2], pc[2])):
            far = sum(((a.cpu() - b_.cpu()).abs() > STEP_TOL["param"] * lr).sum().item()
                      for a, b_ in zip(x, y))
            shares.append(far / sum(a.numel() for a in x))
        what = ("card (kernels)" if name == "card" else
                f"CPU, D-phase fakes moved by {rms:.1e} N(0, 1) (witness),")
        log(f"  step r{img} b={b} {what} vs CPU plain path ({label}, noise "
            f"{noise}): losses rel err {lerr:.2e} (tol {STEP_TOL['loss_rtol']}), clipped grads "
            f"normalised err D {gerr[0]:.2e} G {gerr[1]:.2e} (tol {STEP_TOL['grad']}), "
            f"parameters beyond {STEP_TOL['param']} lr: G {shares[0]:.2e} D {shares[1]:.2e} "
            f"EMA {shares[2]:.2e} (bound {MAX_OUTSIDE}); CPU step {tc:.1f} s; largest G grad "
            f"errors: " + ", ".join(f"{n} {e:.1e}" for e, n in worst[:4]))
        return [lerr] + gerr + shares

    return gap("card"), (gap("witness") if noise else None)


def training_phases(dev, smi, log):
    """Phases 6-8; returns the summary entries of the training kernels."""
    import torch

    from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR, RenderOptions
    from cips3d_tpu_torch.models.generator import sample_zs
    from cips3d_tpu_torch.ops import build
    from cips3d_tpu_torch.ops import ray_tile as rt
    from cips3d_tpu_torch.train.state import TrainConfig

    t0 = time.perf_counter()
    errs = kernel_phase(dev, log)
    log(f"phase 6 done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    configs = {
        "exact sine, residual backward": GeneratorConfig(
            fast_sin=False, fused_ray=True, fused_ray_vjp="pallas_residual"),
        "fast_sin, recompute backward": GeneratorConfig(
            fast_sin=True, fused_ray=True, fused_ray_vjp="pallas"),
        # configs/ffhq.yaml's generator: the G phase is autograd through the unfused NeRF
        # stage, the D phase runs the ray tile and the INR tile by the auto-pick
        SHIPPED: GeneratorConfig(fast_sin=True, fused_ray=False),
    }
    need = {"exact sine, residual backward": ("ray_tile", "inr_tile", "ray_tile_residuals",
                                              "ray_tile_bwd_residual"),
            "fast_sin, recompute backward": ("ray_tile", "inr_tile", "ray_tile_bwd_recompute"),
            SHIPPED: ("ray_tile", "inr_tile")}
    step_ms, launches = {}, {}
    for label, cfg in configs.items():
        log(f"phase 7 train: {label}, r64 b=4 aux on, flagship widths, 10 steps")
        times, counts, _ = train_run(dev, cfg, 10, log, label, smi)
        missing = [k for k in need[label] if counts[k] <= 0]
        if missing:
            raise AssertionError(f"{label}: kernels not launched by the steps: {missing}")
        step_ms[label] = statistics.median(times[2:])
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        q = statistics.quantiles(times[2:], n=4)
        log(f"phase 8 time: train step r64 b=4 {label}: median {step_ms[label]:.1f} ms "
            f"(quartiles {q[0]:.1f}..{q[2]:.1f}, steps 2-9; first {times[0]:.1f} ms) = "
            f"{4e3 / step_ms[label]:.2f} images/s [{smi}]")
    # The card's step against the CPU's, every kernel of the path in, without density noise
    # and with the noise the stage starts with (1.0).  With noise, a miss in the G grads or
    # the parameters counts only if the witness (the CPU step with its D-phase fakes moved
    # by rounding-sized noise) stays inside the same tolerance: there the step turns such
    # moves into finite ones (PERF.md, section 7).  Losses and D grads must agree always.
    tols = [STEP_TOL["loss_rtol"], STEP_TOL["grad"], STEP_TOL["grad"]] + [MAX_OUTSIDE] * 3
    r256 = dict(tcfg_kw=dict(diffaug=True, warmup_d=True, train_aux_img=False,
                             nerf_noise_disable=True, gen_lr=1e-4, disc_lr=5e-4),
                disc_kw=dict(diffaug=True), aux=False)
    r256_cfg = GeneratorConfig(fast_sin=True, fused_ray=False, freeze_nerf=True)
    for noise, kw in ((0.0, {}), (1.0, {}),
                      (0.0, dict(cfg=configs[SHIPPED], label=SHIPPED)),
                      (1.0, dict(cfg=configs[SHIPPED], label=SHIPPED)),
                      # without hierarchical sampling both phases take the unfused stage
                      (0.0, dict(cfg=configs[SHIPPED], label=SHIPPED + ", hierarchical off",
                                 opts_kw=dict(hierarchical_sample=False))),
                      (0.0, dict(cfg=r256_cfg, label=R256, **r256))):
        t1 = time.perf_counter()
        card, witness = step_vs_cpu(dev, log, noise, **kw)
        log(f"  ({time.perf_counter() - t1:.1f} s)")
        for i, (x, tol) in enumerate(zip(card, tols)):
            if x > tol and (witness is None or i < 2 or witness[i] <= tol):
                raise AssertionError(f"the card's training step disagrees with the CPU step "
                                     f"({kw.get('label', 'exact sine')}, noise {noise}): {card} "
                                     f"against tolerances {tols}")
    # train_r256's settings at r256, b = 4, full width: one warm-up step, three timed
    log(f"phase 7 train: {R256}, r256 b=4, flagship widths, 1 + 3 steps")
    times, counts, peak = train_run(
        dev, r256_cfg, 4, log, R256, smi, tcfg=TrainConfig(img_size=256, batch_size=4,
                                                           ema_start_itr=0, **r256["tcfg_kw"]),
        disc_kwargs=r256["disc_kw"], aux_reg=False, profile=False)
    if counts["ray_tile"] <= 0 or counts["inr_tile"] <= 0:
        raise AssertionError(f"{R256}: kernels not launched by the steps: {counts}")
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    log(f"phase 8 time: train step r256 b=4 {R256}: steps 1-3 "
        f"{', '.join(f'{t:.1f}' for t in times[1:])} ms (median {statistics.median(times[1:]):.1f}"
        f" ms = {4e3 / statistics.median(times[1:]):.2f} images/s; warm-up {times[0]:.1f} ms), "
        f"max_memory_allocated {peak / 2 ** 30:.2f} GiB [{smi}]")
    log(f"phase 7 done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()

    # kernel times at the training shapes (r64, b = 4, S = 12, f32)
    b, S, n = 4, 12, 64 * 64
    H, L, C, R = 128, 2, 64, 32
    gen = GeneratorNerfINR(GeneratorConfig(fused_ray=True),
                           generator=torch.Generator().manual_seed(40)).to(dev)
    g = torch.Generator(dev).manual_seed(41)
    with torch.no_grad():
        zs = sample_zs(b, gen.cfg, g, device=dev)
        wt = rt.flat_weights(gen.siren, gen.mapping(zs["z_nerf"], zs["z_inr"]))
        world = gen.sample_world(b, RenderOptions(img_size=64, num_steps=S), g)
        args = (wt, world.points, world.origins, world.dirs, world.z_vals[..., 0],
                *rt.draw_ray_randoms(b, n, S, True, g, dev), 0.5)
        d_fea = torch.randn((b, n, R), generator=g, device=dev)
        d_dep = torch.randn((b, n, 1), generator=g, device=dev)
        res = rt.ray_tile_cuda(*args, with_residuals=True)[2]
        t_res = cuda_ms([lambda: rt.ray_tile_plain(*args, with_residuals=True),
                         lambda: rt.ray_tile_cuda(*args, with_residuals=True)], reps=10)
        t_bres = cuda_ms([lambda: rt.ray_tile_bwd_plain(*args, d_fea, d_dep, residuals=res),
                          lambda: rt.ray_tile_bwd_cuda(*args, d_fea, d_dep, residuals=res)],
                         reps=10)
        t_brec = cuda_ms([lambda: rt.ray_tile_bwd_plain(*args, d_fea, d_dep, fast_sin=True),
                          lambda: rt.ray_tile_bwd_cuda(*args, d_fea, d_dep, fast_sin=True)],
                         reps=10)
    occ = rt.kernel_occupancy(S, L, H, C, R)
    ptxas = ptxas_resources(build.build().with_suffix(".log").read_text())
    for name, key, (plain, kern) in (
            ("2r ray tile with residuals (exact sine)", "ray_tile_residuals", t_res),
            ("3 backward, residual mode (exact sine)", "ray_tile_bwd_residual", t_bres),
            ("3 backward, recompute mode (fast_sin)", "ray_tile_bwd_recompute", t_brec)):
        log(f"phase 8 time: {name} r64 b=4 S=12 noise 0.5 f32: kernel {kern:.3f} ms, plain "
            f"{plain:.3f} ms [{smi}]; {resources_line(key, occ, ptxas)}")
    log(f"phase 8 done in {time.perf_counter() - t0:.1f} s (step times in phase 7)")
    # bounds: multiply-adds at 2 FLOP each over the f32 FMA peak; bytes read once, written once
    pts = b * n * 2 * S
    macs = siren_macs(H, L, C, R)
    in_bytes = 4 * b * n * (S * 3 + 6 + 3 * S + 2 * S) + 4 * macs
    res_bytes = pts * 4 * (2 * L * H + 2 * C)
    grad_bytes = 4 * (macs + L * H + C + R + 1 + b * (2 * L * H + 2 * C) + b * n * S * 3)
    bwd_macs = pts * 2 * macs - (pts // 2) * 3 * H   # d-weight + d-input; fine points: no d x
    b2r = bound_ms(2 * pts * macs, in_bytes + res_bytes + 4 * b * n * (R + 1))
    b3s = bound_ms(2 * bwd_macs, in_bytes + res_bytes + 4 * b * n * (R + 1) + grad_bytes)
    b3c = bound_ms(2 * (bwd_macs + pts * macs), in_bytes + 4 * b * n * (R + 1) + grad_bytes)

    def entry(name, source, replaces, count, err, t, bnd):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": count, "max_abs_err": err, "ms": t[1], "plain_ms": t[0],
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}

    return [
        entry("ray_tile_residuals", "cips3d_tpu_torch/csrc/ray_tile.cu",
              "cips3d_tpu/ops/pallas/ray_tile.py:207", launches["ray_tile_residuals"],
              errs["ray_tile_residuals"], t_res, b2r),
        entry("ray_tile_bwd_residual", "cips3d_tpu_torch/csrc/ray_tile_bwd.cu",
              "cips3d_tpu/ops/pallas/ray_tile.py:421", launches["ray_tile_bwd_residual"],
              errs["ray_tile_bwd_residual"], t_bres, b3s),
        entry("ray_tile_bwd_recompute", "cips3d_tpu_torch/csrc/ray_tile_bwd.cu",
              "cips3d_tpu/ops/pallas/ray_tile.py:421", launches["ray_tile_bwd_recompute"],
              errs["ray_tile_bwd_recompute"], t_brec, b3c),
    ]


def cli_phase(log, tmp, data):
    """Phase 9: the training CLI as a user runs it, in subprocesses at the
    full width of configs/ffhq.yaml on the blob zip ``data`` (the port's
    `data.synthetic`), writing under ``tmp``: `train_r32 --debug`, then
    `train_r64 --debug` finetuning from the r32 tree; then r64's G_ema, read
    by the port's snapshot reader, serves one frame on the card."""
    import os

    import numpy as np

    from cips3d_tpu_torch.apps.serve import RenderService
    from cips3d_tpu_torch.eval.cli import load_generator, serving_config
    from cips3d_tpu_torch.ops import inr_tile, ray_tile

    root = os.path.dirname(os.path.abspath(__file__))
    for command, extra in (("train_r32", []),
                           ("train_r64", ["finetune_dir",
                                          f"{tmp}/train_r32/ckptdir/best_fid"])):
        t1 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "cips3d_tpu_torch.train.cli", "--config",
             "configs/ffhq.yaml", "--command", command, "--debug", "--opts", "data_path",
             data, "outdir", tmp, "num_workers", "2", *extra],
            cwd=root, capture_output=True, text=True, timeout=600)
        lines = [ln for ln in p.stdout.splitlines()
                 if ln.startswith(("step ", "loading finetune", "monitor"))]
        log(f"phase 9 cli: {command} --debug exit {p.returncode} in "
            f"{time.perf_counter() - t1:.1f} s: " + " | ".join(lines))
        if p.returncode != 0:
            log(p.stderr[-4000:])
            raise AssertionError(f"{command}: the training CLI failed")
        run = os.path.join(tmp, command)
        logs = os.listdir(os.path.join(run, "textdir"))
        best = os.path.join(run, "ckptdir", "best_fid")
        snap = sorted(os.listdir(best)) if os.path.isdir(best) else []
        want = [f"step {i}: d_loss=" for i in (1, 2)] + ["FID_surrogate="] + (
            [f"loading finetune weights from {tmp}/train_r32/ckptdir/best_fid"]
            if command == "train_r64" else [])
        missing = [w for w in want if w not in p.stdout]
        missing += [f for f in ("train.d_loss.d_loss.log", "eval.FID_surrogate."
                                "FID_surrogate.log") if f not in logs]
        missing += [f for f in ("generator.npz", "G_ema.npz", "discriminator.npz")
                    if f not in snap]
        keys = np.load(os.path.join(best, "G_ema.npz")).files if "G_ema.npz" in snap else []
        if "['params']['siren']['film_0']['linear']['kernel']" not in keys:
            missing.append("JAX key paths in G_ema.npz")
        log(f"  {command}: textdir {len(logs)} logs, ckptdir/best_fid {snap}")
        if missing:
            raise AssertionError(f"{command}: missing {missing}")
    gen = load_generator(os.path.join(tmp, "train_r64", "ckptdir", "best_fid"),
                         serving_config(), "G_ema", device="cuda")
    ray_tile.ray_tile_cuda.launches = 0
    inr_tile.inr_tile_cuda.launches = 0
    frame = RenderService(gen, img_size=64, num_steps=12).frame(seed=0)
    counts = (ray_tile.ray_tile_cuda.launches, inr_tile.inr_tile_cuda.launches)
    log(f"  r64 G_ema served: frame {frame.shape} {frame.dtype}, std {frame.std():.2f}; "
        f"launches ray_tile {counts[0]}, inr_tile {counts[1]}")
    if frame.shape != (64, 64, 3) or frame.dtype != np.uint8 or frame.std() == 0 \
            or min(counts) <= 0:
        raise AssertionError("the CLI's snapshot did not serve a frame through the kernels")


def variant_pipeline(name, command, opts=()):
    """configs/<name>.yaml's ``command`` node (with dotted ``opts``) as the
    port's pipeline, as the CLI builds it."""
    import os

    from cips3d_tpu_torch.config.config import resolve_command
    from cips3d_tpu_torch.train import variant_loop

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = resolve_command(os.path.join(root, "configs", f"{name}.yaml"), command, list(opts))
    build = (variant_loop.build_diffcam_pipeline if name == "diffcam"
             else variant_loop.build_pigan_pipeline)
    return build(cfg)


def variant_modules(state):
    """The modules a variant step updates: G, D, EMA (and the camera)."""
    return [m for m in (state.generator, state.discriminator, state.ema,
                        getattr(state, "camera", None)) if m is not None]


def variant_train(dev, name, steps, log, smi):
    """Phase 10: ``steps`` steps of configs/<name>.yaml's train_r64 at full
    width (EMA from step 0): losses finite, every module moves, no kernel
    launched.  Returns (median step ms of steps 2 on, batch, peak bytes)."""
    import torch

    from cips3d_tpu_torch.train.loop import LoopConfig

    pipe = variant_pipeline(name, "train_r64", ["ema_start_itr", "0"])
    cfg = pipe.train_cfg
    state = pipe.init_state(LoopConfig(device=str(dev), seed=50, fixed_z_bs=4))
    fn = pipe.make_step(state, cfg.train_aux_img, True)
    rng = torch.Generator(dev).manual_seed(51)
    b, img = cfg.batch_size, cfg.img_size
    real = torch.rand((steps, b, 3, img, img), generator=rng, device=dev) * 2 - 1
    before = [[p.detach().clone() for p in m.parameters()] for m in variant_modules(state)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_kernel_counts()
    times, metrics = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = fn(state, real[i], rng=rng)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    peak = torch.cuda.max_memory_allocated(dev)
    counts = kernel_counts()
    for i, m in enumerate(metrics):
        if not all(map(math.isfinite, m.values())) or m["d_finite"] != 1 or m["g_finite"] != 1:
            raise AssertionError(f"{name} step {i}: non-finite metrics {m}")
    moved = [any(not torch.equal(a, p) for a, p in zip(x, mod.parameters()))
             for x, mod in zip(before, variant_modules(state))]
    if not all(moved):
        raise AssertionError(f"{name}: modules did not move (G, D, EMA, camera): {moved}")
    if any(counts.values()):
        raise AssertionError(f"{name}: a port kernel was launched on a variant path: {counts}")
    first, last = metrics[0], metrics[-1]
    extra = (f", camera fx_raw {before[3][0].item():.4f} -> {state.camera.fx_raw.item():.4f}, "
             f"norm {last['cam_total_norm']:.3e}" if name == "diffcam" else
             f", identity penalty {first['identity_penalty']:.4f} -> "
             f"{last['identity_penalty']:.4f}")
    log(f"  {name}: losses step 0 -> {steps - 1}: d {first['d_loss']:.4f} -> "
        f"{last['d_loss']:.4f}, g {first['g_loss']:.4f} -> {last['g_loss']:.4f}{extra}; "
        f"{' '.join(('G', 'D', 'EMA', 'camera')[:len(moved)])} moved; kernel launches {counts}")
    profile_step(fn, state, real[-1], rng, log, f"r{img} b={b} {name}", smi, phase=10)
    return statistics.median(times[2:]), b, peak, times


def variant_step_vs_cpu(dev, log, name, noise):
    """Phase 10b: one r32, b = 2 step of configs/<name>.yaml at full width
    on the card and on the CPU, the same weights (built from one seed) and
    the same draws, density noise ``noise`` at step 0; with noise also the
    witness (the CPU step with its D-phase fakes moved by noise as large as
    the card's fakes differ from the CPU's).  Returns the gaps (losses rel
    err; clipped grads D, G (, camera); shares of G, D, EMA (, camera)
    parameters beyond STEP_TOL["param"] lr) of the card step and of the
    witness, against the CPU step."""
    import torch

    import cips3d_tpu_torch.train.diffcam_step as diffcam_step
    import cips3d_tpu_torch.train.pigan_step as pigan_step
    from cips3d_tpu_torch.core.rays import draw_camera
    from cips3d_tpu_torch.models.generator import sample_zs
    from cips3d_tpu_torch.models.generator_diffcam import draw_diffcam
    from cips3d_tpu_torch.models.pigan import draw_pigan
    from cips3d_tpu_torch.train.loop import LoopConfig

    b, img = 2, 32
    opts = ["img_size", str(img), "batch_size", str(b), "ema_start_itr", "0",
            "nerf_noise_disable", "true" if noise == 0 else "false"]
    gc = torch.Generator().manual_seed(60)
    pipe = variant_pipeline(name, "train_r32", opts)
    cfg = pipe.train_cfg
    if name == "diffcam":
        step_mod, lrs = diffcam_step, (cfg.disc_lr, cfg.gen_lr, cfg.cam_lr)
        nk = pipe.nerf_kwargs

        def phase():
            return diffcam_step.DiffcamPhaseDraws(
                sample_zs(b, pipe.gen_cfg, gc), draw_camera(b, "gaussian", gc),
                draw_diffcam(b, img * img, nk, gc))

        draws = diffcam_step.DiffcamStepDraws(phase(), phase())
        losses = ("d_loss", "g_loss", "grad_penalty")
    else:
        step_mod, lrs = pigan_step, (cfg.disc_lr, cfg.gen_lr)
        ropts = pipe.opts

        def phase():
            return pigan_step.PiGANPhaseDraws(torch.randn((b, pipe.gen_kwargs["z_dim"]),
                                                          generator=gc),
                                              draw_pigan(b, ropts, gc))

        draws = pigan_step.PiGANStepDraws(phase(), phase())
        losses = ("d_loss", "g_loss", "grad_penalty", "identity_penalty")
    real = torch.rand((b, 3, img, img), generator=gc) * 2 - 1
    clip = step_mod.clip_and_guard
    results, fakes = {}, {}
    cpu = torch.device("cpu")
    for run, d in (("cpu", cpu), ("card", dev), ("witness", cpu)):
        move = None
        if run == "witness":
            if not noise:
                break
            rms = (fakes["card"] - fakes["cpu"]).pow(2).mean().sqrt().item()
            move = rms * torch.randn(fakes["cpu"].shape,
                                     generator=torch.Generator().manual_seed(61))
        state = pipe.init_state(LoopConfig(device=str(d), seed=62, fixed_z_bs=4))
        gen = state.generator

        def keep(imgs, move=move, run=run):
            """The D phase's fakes (the generator's call without gradient),
            kept and moved by ``move``."""
            if torch.is_grad_enabled():
                return imgs
            fakes[run] = imgs.detach().cpu()
            return imgs if move is None else imgs + move.to(imgs.device)

        if name == "diffcam":
            forward_rays = gen.forward_rays

            def hooked(*a, **k):
                imgs, ret = forward_rays(*a, **k)
                return keep(imgs), ret

            gen.forward_rays = hooked
        else:
            gen.register_forward_hook(lambda mod, inp, out: (keep(out[0]), out[1]))
        seen = []

        def recording(grads, max_norm):
            out = clip(grads, max_norm)
            seen.append([x.detach().cpu() for x in out[0]])
            return out

        step_mod.clip_and_guard = recording
        try:
            fn = pipe.make_step(state, cfg.train_aux_img, True)
            t0 = time.perf_counter()
            state, m = fn(state, real.to(d), draws=to_device(draws, d))
            secs = time.perf_counter() - t0
        finally:
            step_mod.clip_and_guard = clip
        results[run] = (m, seen, [[p.detach().cpu() for p in mod.parameters()]
                                  for mod in variant_modules(state)], secs)
    fake_err = (fakes["card"] - fakes["cpu"]).abs().max().item()

    def gap(run):
        (mc, sc, pc, tc), (mg, sg, pg, _) = results["cpu"], results[run]
        lerr = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-6) for k in losses)
        gerr = [max(grad_err(a, b_) for a, b_ in zip(x, y)) for x, y in zip(sg, sc)]
        shares = []
        for lr, x, y in zip((lrs[1], lrs[0], lrs[1]) + lrs[2:], pg, pc):
            far = sum(((a - b_).abs() > STEP_TOL["param"] * lr).sum().item() for a, b_ in zip(x, y))
            shares.append(far / sum(a.numel() for a in x))
        what = ("card" if run == "card" else
                f"CPU, D-phase fakes moved by {rms:.1e} N(0, 1) (witness),")
        log(f"  {name} step r{img} b={b} {what} vs CPU, noise {noise}: losses rel err "
            f"{lerr:.2e} (tol {STEP_TOL['loss_rtol']}), clipped grads normalised err "
            + " ".join(f"{n} {e:.2e}" for n, e in zip(("D", "G", "camera"), gerr))
            + f" (tol {STEP_TOL['grad']}), parameters beyond {STEP_TOL['param']} lr: "
            + " ".join(f"{n} {e:.2e}" for n, e in zip(("G", "D", "EMA", "camera"), shares))
            + f" (bound {MAX_OUTSIDE}); D-phase fakes max abs diff card vs CPU {fake_err:.2e}; "
            f"CPU step {tc:.1f} s")
        return [lerr] + gerr + shares

    return gap("card"), (gap("witness") if noise else None)


def variant_cli(tmp, data, name):
    """Phase 10c: a variant's training CLI in subprocesses at full width:
    `train_r32 --debug`, and for diffcam then `train_r64 --debug`
    finetuning from it.  Returns [(label, seconds, process, missing)]."""
    import os

    import numpy as np

    root = os.path.dirname(os.path.abspath(__file__))
    out = []
    runs = [("train_r32", [])] + ([("train_r64", ["finetune_dir",
                                                  f"{tmp}/diffcam/train_r32/ckptdir/best_fid"])]
                                  if name == "diffcam" else [])
    for command, extra in runs:
        t1 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "cips3d_tpu_torch.train.cli", "--config",
             f"configs/{name}.yaml", "--command", command, "--debug", "--opts", "data_path",
             data, "outdir", f"{tmp}/{name}", "num_workers", "2", *extra],
            cwd=root, capture_output=True, text=True, timeout=600)
        run = os.path.join(tmp, name, command, "ckptdir")
        want = [f"step {i}: d_loss=" for i in (1, 2)] + ["FID_surrogate="] + (
            [f"loading finetune weights from {tmp}/diffcam/train_r32/ckptdir/best_fid"]
            if command == "train_r64" else [])
        missing = [w for w in want if w not in p.stdout]
        trees = {t: set(os.listdir(os.path.join(run, t))) if os.path.isdir(os.path.join(run, t))
                 else set() for t in ("best_fid", "resume")}
        need = {"best_fid": {"generator.npz", "G_ema.npz", "discriminator.npz"},
                "resume": {"g_opt.npz", "d_opt.npz"}}
        if name == "diffcam":
            need = {"best_fid": need["best_fid"] | {"cam_param.npz"},
                    "resume": need["resume"] | {"cam_param.npz", "cam_opt.npz"}}
        missing += [f"{t}/{f}" for t in need for f in sorted(need[t] - trees[t])]
        if "G_ema.npz" in trees["best_fid"]:
            key = ("['params']['siren']['film_0']['layer']['kernel']" if name == "pigan" else
                   "['params']['siren']['film_0']['linear']['kernel']")
            if key not in np.load(os.path.join(run, "best_fid", "G_ema.npz")).files:
                missing.append("JAX key paths in G_ema.npz")
        out.append((f"{name} {command}", time.perf_counter() - t1, p, missing))
    return out


def progressive_run(dev, tmp, data):
    """Phase 10d: `run_progressive` over the first two FFHQ_STAGES (r32,
    r64) under debug at configs/ffhq.yaml's full width, in process.
    Returns (state, captured stdout, seconds)."""
    import contextlib
    import io
    import os

    from cips3d_tpu_torch.config.config import resolve_command
    from cips3d_tpu_torch.train.cli import config_to_dataclasses
    from cips3d_tpu_torch.train.curriculum import FFHQ_STAGES, run_progressive

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = resolve_command(os.path.join(root, "configs", "ffhq.yaml"), "train_r32",
                          ["data_path", data, "num_workers", "2"])
    gen_cfg, train_cfg, opts, loop_cfg = config_to_dataclasses(cfg)
    loop_cfg.debug, loop_cfg.device, loop_cfg.outdir = True, str(dev), f"{tmp}/progressive"
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        state = run_progressive(gen_cfg, train_cfg, opts, loop_cfg, stages=FFHQ_STAGES[:2],
                                disc_kwargs=cfg.discriminator.to_dict())
    return state, buf.getvalue(), time.perf_counter() - t0


def variant_phase(dev, smi, log, tmp, data):
    """Phase 10: the diffcam and pi-GAN pipelines at full width (10 steps
    each at r64 with step time, images/s and peak memory), their r32 step
    on the card against the CPU, their CLI in subprocesses, and the
    flagship's two-stage `run_progressive`."""
    import os
    import threading

    steps = {}
    for name in ("diffcam", "pigan"):
        log(f"phase 10 train: {name} (configs/{name}.yaml train_r64), full width, 10 steps")
        ms, b, peak, times = variant_train(dev, name, 10, log, smi)
        steps[name] = ms
        q = statistics.quantiles(times[2:], n=4)
        log(f"phase 10 time: train step r64 b={b} {name}: median {ms:.1f} ms (quartiles "
            f"{q[0]:.1f}..{q[2]:.1f}, steps 2-9; first {times[0]:.1f} ms) = {b * 1e3 / ms:.2f} "
            f"images/s, max_memory_allocated {peak / 2 ** 30:.2f} GiB [{smi}]")

    # the CLI runs in subprocesses, one thread a variant, beside the in-process checks below
    cli = {name: [] for name in ("diffcam", "pigan")}
    workers = [threading.Thread(target=lambda n=name: cli[n].extend(variant_cli(tmp, data, n)))
               for name in cli]
    for w in workers:
        w.start()
    try:
        tols = [STEP_TOL["loss_rtol"]] + [STEP_TOL["grad"]] * 3 + [MAX_OUTSIDE] * 4
        zero_kernel_counts()
        for name in ("diffcam", "pigan"):
            for noise in (0.0, 1.0):
                t1 = time.perf_counter()
                card, witness = variant_step_vs_cpu(dev, log, name, noise)
                log(f"  ({time.perf_counter() - t1:.1f} s)")
                # with noise a miss past the losses and D grads counts only where the
                # witness stays inside (PERF.md, section 7)
                for i, (x, tol) in enumerate(zip(card, tols if name == "diffcam"
                                                 else tols[:3] + tols[4:7])):
                    if x > tol and (witness is None or i < 2 or witness[i] <= tol):
                        raise AssertionError(f"{name}: the card's step disagrees with the CPU "
                                             f"step (noise {noise}): {card}")
        counts = kernel_counts()
        if any(counts.values()):
            raise AssertionError(f"a port kernel was launched on a variant path: {counts}")
        state, out, secs = progressive_run(dev, tmp, data)
        lines = [ln for ln in out.splitlines() if ln.startswith(("step 2:", "loading finetune"))]
        log(f"phase 10 progressive: FFHQ_STAGES r32 -> r64 under debug, full width, "
            f"{secs:.1f} s: " + " | ".join(lines))
        best = f"{tmp}/progressive/r32/ckptdir/best_fid"
        if state.step != 2 or f"loading finetune weights from {best}" not in out or not all(
                os.path.isdir(f"{tmp}/progressive/{s}/ckptdir/best_fid") for s in ("r32", "r64")):
            raise AssertionError("run_progressive: stage 2 did not finetune from stage 1")
    finally:
        for w in workers:
            w.join()
    for label, secs, p, missing in cli["diffcam"] + cli["pigan"]:
        lines = [ln for ln in p.stdout.splitlines()
                 if ln.startswith(("step ", "loading finetune", "monitor"))]
        log(f"phase 10 cli: {label} --debug exit {p.returncode} in {secs:.1f} s: "
            + " | ".join(lines))
        if p.returncode != 0 or missing:
            log(p.stderr[-4000:])
            raise AssertionError(f"{label}: the training CLI failed or missed {missing}")
    if len(cli["diffcam"]) != 2 or len(cli["pigan"]) != 1:
        raise AssertionError("the variants' CLI runs did not finish")
    return steps


def main():
    import torch

    # ---- phase 1: device ------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA GPU")
    from cips3d_tpu_torch.apps.render import render_chunked
    from cips3d_tpu_torch.apps.serve import RenderService, serve
    from cips3d_tpu_torch.eval.cli import serving_config
    from cips3d_tpu_torch.models.generator import GeneratorNerfINR, RenderOptions, sample_zs
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
    cfg = serving_config(fast_sin=True)
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
    t_phase = time.perf_counter()
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
        # b = 2 with n ragged against the kernel's 64-pixel tile: 4059 = 63 x 64 + 27
        for b, n in ((1, 4096), (2, 4096), (2, 4059)):
            weights, mods = inr_tile.extract_inr_weights(gen.inr_net, 9)
            s, d = inr_tile.compute_inr_mods(mods, {k: v[:b] for k, v in st.items()}, 512)
            x = fea[:b, :n].contiguous()
            # at init the ToRGB heads are tiny (frequency_init(100)) and the output
            # sits near tanh(bias); x100 heads make the whole chain show in it
            for rgb_scale in (1, 100):
                w_s = weights._replace(wr=weights.wr * rgb_scale)
                outs = {mm: inr_tile.inr_tile_cuda(x, s, d, w_s, mm_dtype=mm) for mm in (f32, bf16)}
                plain = {mm: inr_tile.inr_tile_plain(x, s, d, w_s, mm_dtype=mm) for mm in (f32, bf16)}
                case = f"inr_tile x{rgb_scale}"
                tag = (f"inr_tile b={b} n={n} D=512 blocks=9 ToRGB x{rgb_scale} "
                       f"(out {plain[f32].min().item():.3f}..{plain[f32].max().item():.3f})")
                e, _, _ = compare(tag + " float32", outs[f32], plain[f32], TOL[case, "float32"])
                if b == 1 and rgb_scale == 1:   # the served shape: one batch row
                    err_at_main["inr_tile"] = e
                check_bf16(tag + " bfloat16", outs[bf16], plain[bf16], plain[f32], outs[f32],
                           TOL[case, "bfloat16"])

    log(f"phase 3 done in {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

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
        jpegs = {}
        for path in ("/render?seed=4&yaw=1.4", "/render?seed=4&depth=1"):
            with urllib.request.urlopen(base + path, timeout=120) as r:
                jpegs[path] = (r.status, r.headers.get("Content-Type"), r.read())
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
    for path, (status, ctype, body) in jpegs.items():
        # a baseline JPEG of a 128 x 128 frame: SOI first, EOI last, smaller than raw RGB
        ok = (status == 200 and ctype == "image/jpeg" and body[:2] == b"\xff\xd8"
              and body[-2:] == b"\xff\xd9" and 500 < len(body) < 128 * 128 * 3)
        log(f"  GET {path}: {status} {ctype}, {len(body)} bytes, SOI {body[:2].hex()} "
            f"EOI {body[-2:].hex()}")
        if not ok:
            raise AssertionError(f"GET {path} did not answer with a JPEG")
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

    log(f"phase 4 done in {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

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
    occ = ray_tile.kernel_occupancy(SERVING_STEPS, 2, 128, 64, 32)
    for mm in (torch.float32, torch.bfloat16):
        occ[f"inr_tile {str(mm)[6:]}"] = inr_tile.kernel_occupancy(512, mm)
    ptxas = ptxas_resources(lib_path.with_suffix(".log").read_text())
    for k, (plain, kern) in timings.items():
        entry = "ray_tile" if k == "ray_tile float32" else k
        extra = f"; {resources_line(entry, occ, ptxas)}" if entry in KERNEL_PARTS else ""
        log(f"phase 5 time: {k} r128 x{SERVING_STEPS} (n=16384): kernel {kern:.3f} ms, "
            f"plain {plain:.3f} ms [{smi}]{extra}")
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

    log(f"phase 5 done in {time.perf_counter() - t_phase:.1f} s")

    # bounds at the phase-5 shapes (b = 1, 16384 rays, 48 points a ray)
    n5, H, L, C, R = 128 * 128, 128, 2, 64, 32
    macs = siren_macs(H, L, C, R)
    fwd_in_bytes = 4 * n5 * (SERVING_STEPS * 3 + 6 + 3 * SERVING_STEPS + 2 * SERVING_STEPS)
    serve_bounds = {
        "ray_tile": bound_ms(2 * n5 * 2 * SERVING_STEPS * macs,
                             fwd_in_bytes + 4 * macs + 4 * n5 * (R + 1)),
        "inr_tile": bound_ms(2 * n5 * (32 * 512 + 17 * 512 * 512 + 6 * 512 * 3),
                             4 * n5 * (32 + 3) + 4 * (32 * 512 + 17 * 512 * 512)),
    }

    train = training_phases(dev, smi, log)

    import os
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        t_phase = time.perf_counter()
        data = os.path.join(tmp, "blobs_64.zip")
        subprocess.run([sys.executable, "-m", "cips3d_tpu_torch.data.synthetic", data, "--num",
                        "64", "--size", "64", "--seed", "1"], check=True, timeout=300,
                       capture_output=True, cwd=os.path.dirname(os.path.abspath(__file__)))
        cli_phase(log, tmp, data)
        log(f"phase 9 done in {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        variant_phase(dev, smi, log, tmp, data)
        log(f"phase 10 done in {time.perf_counter() - t_phase:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kernels = [
        {"name": "ray_tile", "route": "cuda", "source": "cips3d_tpu_torch/csrc/ray_tile.cu",
         "replaces": "cips3d_tpu/ops/pallas/ray_tile.py:137", "launches": launches["ray_tile"],
         "max_abs_err": err_at_main["ray_tile"], "ms": timings["ray_tile float32"][1],
         "plain_ms": timings["ray_tile float32"][0], "bound_ms": serve_bounds["ray_tile"][0],
         "bound_by": serve_bounds["ray_tile"][1], "library_ms": None},
        {"name": "inr_tile", "route": "cuda", "source": "cips3d_tpu_torch/csrc/inr_tile.cu",
         "replaces": "cips3d_tpu/ops/pallas/inr_tile.py:48", "launches": launches["inr_tile"],
         "max_abs_err": err_at_main["inr_tile"], "ms": timings["inr_tile float32"][1],
         "plain_ms": timings["inr_tile float32"][0], "bound_ms": serve_bounds["inr_tile"][0],
         "bound_by": serve_bounds["inr_tile"][1], "library_ms": None},
    ] + train
    log(nvidia_smi())   # the card's name and power limit, as nvidia-smi prints them
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
