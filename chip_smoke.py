#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`cips3d_tpu_torch`) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing one line (plus detail lines):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from `cips3d_tpu_torch/csrc/` (nvcc, sm_90a);
  3. hold each kernel against its plain PyTorch version on the same inputs
     at the serving shapes (the ray tile at S = 12, 24, 48 and the cap
     `ray_tile.MAX_STEPS`, past the 32 where each lane holds one sample; the
     INR tile also at b = 2 with n ragged against its 64-pixel tile), in f32
     and bf16, and bound the share of rays or pixels outside the stated
     tolerance (past S = 24 with density noise, at the larger of that bound
     and the float64-resample witness's share); check that the bf16 kernels
     round where the plain versions do, against a control that does not; beside
     each density-noise case, print how far a float64 resample moves the
     plain version (the noisy f32 resample is ill-conditioned);
  4. build the flagship generator at the full width of `GeneratorConfig()`
     from the port's seeded init, answer requests through
     `RenderService.frame` and the HTTP server, check the outputs, check
     that both kernels were launched by that run, and hold a small frame
     against the plain path on the CPU;
  5. median times (CUDA events) of each kernel and its plain version (the
     ray tile also at r128 x 48 and x the cap), and frame latencies;
     beside the ray tile's and the INR tile's times their resident warps per
     SM (CUDA occupancy API), shared memory and the ptxas registers and
     spills;
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
     float64-resample witness; then at S = 48 and the cap, without noise,
     #2r and #3 in both modes, f32 and bf16, the same checks (the plain
     backward against autograd both in float64 there);
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
     of the training kernels beside their plain versions (also at S = 48 and
     the cap), each with the warps per SM, shared memory, registers and
     spills of the kernels it launches;
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
     1's best_fid); (d) beside them, the training CLI without ``--debug``
     (`train/loop.py` in chunks), train_r32 at full width, 5 steps with
     evals after steps 1, 4 and 5, deterministic algorithms on, in
     subprocesses: the flagship with ``dispatch_chunk`` 1 (eager), 2, and 2
     in a one-rank NCCL group, diffcam with 1 and 2; each logs steps 1-5
     and ends with both counters at 5, the chunked ones capture a CUDA
     graph, and a config's resume trees agree bit for bit;
 11. the eval CLI and the apps at full width: a translate_rotate trajectory
     frame (explicit camera, rolled up vector) at r64 x 12 on the card vs
     the CPU (phase 4's rule); trajectory-frame times at r128 x 24 and r256
     x 12; inversion on the exact-sine config (#2r forward, #3 residual
     backward into the styles, the discriminator's perceptual term), 5 Adam
     steps, step 0 vs the CPU within rtol 1e-4, the loss falling, #2r and #3
     once a step, the median step time; the sigma volume at n = 64 on the
     card vs the CPU (normalised error 1e-4), its MRC read back, n = 128
     timed; then every mode of `python -m cips3d_tpu_torch.eval.cli` in
     subprocesses started together, from phase 9's r64 snapshot with
     configs/ffhq.yaml train_r64 and --serving: trajectory (8 frames r128 x
     24 with depth, two AVIs of JPEGs), viewer (2 x 3 x 9 JPEGs), multiview,
     gen, sample, fid with the surrogate on phase 9's zip, and fid without
     --allow-surrogate, which must refuse while the InceptionV3 checkpoint
     is absent.
 12. the data path at real sizes on the card's host: the native library's
     JPEG decode of PIL-made fixtures (4:2:0, 4:2:2, 4:4:4, grey, a restart
     interval) against PIL's pixels, exact; 256 seeded r256 images (224 PNG
     by `encode_png`, 32 JPEG by `encode_jpeg`) through `python -m
     cips3d_tpu_torch.data.dataset_tool` in a subprocess, every member
     decoded identically by the native and the plain readers; the
     DataLoader's images/s (4 threads, b = 4) at r256 plain and native and at
     r256 -> r64 native, which must be at least twice phase 8's shipped r64
     step rate; 10 shipped r64 steps fed from that zip (median beside phase
     8's); a CelebA list of 178 x 218 JPEGs through `get_dataset` and the
     loader, one item against the plain resize functions;
 13. training on several processes (`cips3d_tpu_torch/parallel/mesh.py`):
     (a) 10 shipped r64 b = 4 steps through a one-rank NCCL group (the flat
     gradient all-reduces, 3 collectives a step, and a `host_barrier`)
     against 10 steps without a group from the same weights and draws, bit
     for bit, with deterministic algorithms on in all three runs (two
     without a group, to show they agree); (b) two gloo ranks sharing the
     card, started as the training CLI is (the CIPS3D_* env; ``python3
     chip_smoke.py --phase13-rank DIR`` is one rank): the shipped r64 step
     at b = 2 a rank against one process at b = 4, and train_r512's
     settings at r256 with ray_shards 2 (each rank renders half of the
     pixels of both rows, D sees one row) against one process at b = 2, at
     phase 7's tolerances without density noise, both ranks' parameters
     equal bit for bit, each rank's peak memory beside one process's, and
     #1 and #2 launched in every rank;
 14. a reference checkpoint (`utils/convert_torch.py`): phase 4's
     generator and a phase-7 discriminator through
     `export_reference_checkpoint_dir` (the JAX function's four files), read
     back as written, wrapped in ``{"state_dict": ...}`` and with the
     ``to_rbgs`` spelling by `load_reference_generator`, every tensor bit
     for bit; the loaded G served through `RenderService` at r128 x 24 and
     r256 x 12 against the source G's frames (bit for bit, else within
     FRAME_ATOL), #1 and #2 launched, and an r32 frame against the plain
     CPU path; the parity gate's ``--self-test`` (exit 0, 24 + 24 PNGs, a
     finite FID) and ``--dry-run`` in an empty directory (exit 1, the
     three artifacts named) in subprocesses; each class of
     `models/legacy.py` and `models/nerf_variants.py` on the card against
     the CPU from the same weights, forward and one backward, TF32 off;
 15. the benches and the bf16 path they drive (bf16 compute, f32
     parameters): (a) one bf16 r32 b = 2 step at full width without
     density noise of each bench leg (the shipped config; exact sine with
     the residual backward) on the card against the same bf16 step on the
     CPU, the CPU's f32 step as the witness (BF16_RATIO), and an r64 x 12
     bf16 serving frame likewise; (b) ``python -m
     cips3d_tpu_torch.bench.train`` (2 + 1 calls, 50 loader steps) and
     ``python -m cips3d_tpu_torch.bench.inference`` (BENCH_AB=1) at their
     default sizes in subprocesses: exit 0, one JSON line with every key and
     finite positive values, and per leg the kernels' launches by product
     dtype (bf16 only: #1 and #2 in every training leg and the fused
     serving leg, #2r and #3 in the exact-sine leg), #1's bf16
     instantiation in one profiled step or call, and the device's idle
     share there; (c) #2r and #3 with bf16 products and their plain
     versions, timed (phases 8 and 15 pass the density noise as the step
     does, a 0-d tensor on the device);
 16. chunked dispatch (`cips3d_tpu_torch/train/chunk.py`: K replays of a
     CUDA graph of the step), with deterministic algorithms on: (a) 10
     eager steps against one chunk of 10 for both bench legs (bf16 compute,
     r64 b = 4), 4 for diffcam and pi-GAN at full width, each from a fresh
     state of the same seeds and the same generator seed: bit for bit in
     every state tensor and metric, else within phase 7's tolerances (the
     line says which held), and the chunk's launches, counted through its
     replays, equal to the eager steps'; (b) the shipped leg at steps
     4998-5002 (the density noise to 0, the EMA on from 5000); (c) one
     chunk at train_r256's settings (r256 b = 4), its peak device memory at
     most CHUNK_PEAK_GIB; (d) phase 13(a)'s case through a one-rank NCCL
     group, 10 eager steps against 5 chunks of 2 (the all-reduces captured
     with the step), bit for bit, 3 collectives a step through the replays;
     (e) the shipped bench leg eager, then chunked (1 call of 10 steps
     each): images/s and a profiled run's device idle share,
     printed without a threshold.  In (a) the bench legs' last
     WITNESS_STEPS replays run under the profiler: the port's kernels that
     the trace shows on the device must equal the launches counted through
     those replays.  (c) also renders train_r256's eval (the loop's
     `gen_images` of the G_ema, b = 16, one captured program a batch shape)
     after releasing the chunk's graph, as the loop does before an eval:
     its peak at most CHUNK_PEAK_GIB beside the chunk's;
 17. the render side as one program a call (`cips3d_tpu_torch/utils/
     graphs.py`: a CUDA graph captured at a call's first use and replayed),
     deterministic algorithms on: (a) `RenderService` with two models at
     r128 x 24 and r256 x 12 sharing one pool, 4 seeds x 3 cameras each,
     replayed frames against eager frames, image and depth bit for bit
     (else phase 4's frame rule; the line says which held), #1 and #2
     counted through the replays; (b) `bench.inference`'s call of 16
     replays of one captured frame against 16 eager frames from the same
     generator seed, the checksum bit for bit; (c) the inversion on the
     exact-sine config with the percept term, 5 captured steps against 5
     eager ones, every style tensor and loss bit for bit, #2r and #3 once a
     step through the replays; (d) trajectory frames and the n = 64 sigma
     volume, captured against eager; (e) eager and captured times of the
     serving frames (r128 x 24, r256 x 12), the trajectory frame, the
     inversion step, the sigma volume (n = 128) and the bench's frames/s,
     each with a profiled call's idle share, and the memory of the service's
     graphs, without a threshold;
 18. the last slice of the port: (a) the training loop at train_r256's
     settings for 2 steps with an eval and its monitors (16 fixed latents
     at r256) after each, the chunk released before each eval and captured
     again after it, the peak memory at most CHUNK_PEAK_GIB, and the last
     eval's monitor grids (one program a model and pose) against eager
     calls, bit for bit with deterministic algorithms on; (b) diffcam's and
     pi-GAN's r64 eval fakes and monitors, captured against eager, bit for
     bit, equal launches; (c) `render_sharded` of the serving generator at
     r128 x 24 through a one-rank NCCL group, replays against eager calls
     bit for bit, #1, #2 and the all-gather counted through the replays;
     (e) configs/finetune.yaml's finetune_afhq through the training CLI in
     a subprocess at full width (``python3 chip_smoke.py --finetune-run
     <cli args>``), started after (a)'s loop and run beside (b) and (c): 5
     steps from a seeded snapshot the port writes on a 64-image r256 zip,
     exit 0, the snapshot loaded, G's NeRF equal to the source EMA's bit
     for bit after the run, its INR moved, #1 launched, the step time and
     the peak memory; (d) alone, after it: the surrogate FID on the card,
     the features of 2048 + 2048 r64 images against the CPU extractor's at
     FID_TOL (TF32 off) and the FID within 1e-4 relative, an eval of those
     images (fakes written, features, FID) timed with each extractor.
 19. the render path past 32 samples a ray (after 18, phase 9's snapshot):
     `RenderService` at r128 x 48 from a zeroed count (#1 and #2 launched)
     and the same generator's r128 x 48 frame on the card against the CPU;
     ``eval.cli multiview --serving --num-steps 24`` (S = 48) in process on
     phase 9's r64 snapshot, its launches counted, and its render (the
     CLI's generator and arguments, draws made on the host) on the card
     against the CPU; both by phase 4's frame rule.
 20. the streamed path, which takes every shape the Pallas kernels take
     where the resident kernels do not (`csrc/ray_tile_streamed.cu`,
     `csrc/inr_tile_streamed.cu`; the wrappers choose from the resident
     layouts' bytes against the card's shared memory, printed beside the
     library's own count): (a) #2 at nerf_hidden_layers 3 (r128 x 24), #2r
     and #3 in both modes at depth 3 (r64, b = 4, S = 12, density noise 0.5)
     and #1 at D = 1024 (r64) against their plain versions (f32 at the
     kernel rows' tolerances, bf16 with the controls), twice bit for bit,
     timed beside the plain versions and beside the resident kernels at
     the flagship shapes, which both paths take; then one call each of #2
     and #1 split launch by launch (`tools/stream_split.py`: stage, device
     time, FLOPs, bytes, rates, grid, registers); (b) from zeroed counts:
     `RenderService` serving the depth-3 flagship at r128 x 24 (captured
     replays against eager calls bit for bit, a frame against the CPU by
     phase 4's rule), an r32 b = 2 step at depth 3 with the exact sine
     (#2r, #3 residual) and one with the polynomial sine (#3 recompute)
     against the CPU by phase 7's tolerances, ``eval.cli multiview --serving
     --num-steps 48`` (S = 96) on phase 9's snapshot with its view against
     the CPU, and a wide generator (nerf_hidden_dim 256 with the colour
     layer as wide, inr_hidden_dim 1024) at r64 x 12 against the CPU; each
     with the streamed kernels' launches.
Phases 4, 5, 11, 14 and 15 go through the same captured programs (a frame,
the inversion step, the sigma chunk, the bench's frame; the eval CLI's
renders in its subprocesses): their launch counts include each program's
warm-up, which runs its kernels once before the capture.  The graphs and
their pools are released after phases 5, 11, 14, 15 and 16.
Phase 4 also fetches /render and /render?depth=1 and checks the JPEGs.
The second-to-last line is a JSON summary of the kernels (with each one's
bound on the card: the larger of its multiply-adds over the 67 TFLOP/s f32
FMA peak and its bytes over 3.35 TB/s), each also with bf16 products as
the benches run it (``bf16_*``: phase 15's launches, the bf16 time, plain
time and error, the bound at the 989 TFLOP/s bf16 peak) and the ray
tile's at S = 48 and at the cap (``ms_s48``, ``plain_ms_s48``,
``bound_ms_s48``, ``bound_by_s48``, ``max_abs_err_s48``, the same with
``s64``: #2 at phase 5's frame, #2r and #3 at phase 8's shapes), then the
streamed kernels of phase 20 (``*_streamed``: launches from phase 20(b),
times, errors and bounds at phase 20(a)'s shapes, the resident and the
streamed time at a shape both take, each kernel's ptxas registers and
spills and the shared memory); the last line the device summary.
Any failed check raises, so the exit code is not 0.
Without CUDA (or without the package beside it) the script exits with an
error before printing any result.
"""

import collections
import copy
import dataclasses
import glob
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

SERVING_STEPS = 24        # RenderService default: r128, 24 steps
LONG_STEPS = 48           # past the 32 a warp's lanes hold one to one: `--num-steps 48` of
                          # apps/serve.py, multiview's doubled 24 (apps/render.py:275)
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
# Phase 15: a bf16 result on the card may be at most BF16_RATIO x as far from the CPU's bf16
# result as that is from the CPU's f32 result, plus BF16_ATOL (tests/test_torch_bench.py's
# rule against JAX); a gradient or parameter tensor may have BF16_KINKS elements beyond it
BF16_RATIO, BF16_ATOL, BF16_KINKS = 2.0, 1e-6, 2
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
# A kernel's reading under density noise (the resample's conditioning aside) that misses its
# tolerance passes only where a witness on the same inputs misses it too, and then by at most
# this multiple of the witness's reading (phases 6 and 20)
WITNESS_RATIO = 2.0
SHIPPED = "shipped: fast_sin, unfused G phase"            # configs/ffhq.yaml's generator
R256 = "train_r256: freeze_nerf, DiffAug, warmup_d, aux off"   # the r256 stage's settings
F32_PEAK = 67e12          # FLOP/s, f32 FMA outside the tensor cores (H100 SXM data sheet)
BF16_PEAK = 989e12        # FLOP/s, dense bf16 on the tensor cores (the same sheet)
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


def check_bf16(name, kernel_bf16, plain_bf16, plain_f32, kernel_f32, tol, witness=None):
    """The bf16 kernel against the bf16 plain version (tolerance, rounding
    check), and the control: the f32 kernel, which skips the bf16 rounding,
    must fail the same checks.  With ``witness`` (another bf16 kernel's
    output on the same inputs) rows outside the tolerance count only as
    `held` against the witness's share.  Returns the bf16 kernel's max abs
    error."""
    import torch

    err_b, mean_b, share = compare(name, kernel_bf16, plain_bf16, tol, check=witness is None)
    if witness is not None:
        wit = outside(witness, plain_bf16, tol).float().mean().item()
        log(f"  {name}: witness outside_tol {wit:.2e}")
        if not torch.isfinite(kernel_bf16).all() or not held(share, MAX_OUTSIDE, wit):
            raise AssertionError(f"{name}: {share:.2e} of rows outside tolerance, witness {wit:.2e}")
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
    return err_b


def grad_err(a, b):
    """max|a - b| / (max|b| + 1) of one gradient leaf."""
    a, b = a.detach().double(), b.detach().double()
    return ((a - b).abs().max() / (b.abs().max() + 1)).item()


def max_grad_err(ga, gb):
    return max(grad_err(a, b) for a, b in zip(ga, gb))


def held(reading, tol, witness):
    """``reading`` within ``tol``, or, where ``witness`` misses ``tol`` as
    well, within WITNESS_RATIO x ``witness``."""
    return reading <= tol or (witness > tol and reading <= WITNESS_RATIO * witness)


def rays_outside(a, b, tol):
    """Share of rays (the first two axes) with any element beyond
    tol * (max|b| + 1)."""
    err = (a.detach().double() - b.detach().double()).abs()
    bound = tol * (b.detach().double().abs().max() + 1)
    return (err > bound).reshape(a.shape[0] * a.shape[1], -1).any(-1).double().mean().item()


def bound_ms(flops, nbytes, peak=F32_PEAK):
    """The least time on the card: (ms, what bounds it)."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def siren_macs(H, L, C, R):
    """Multiply-adds of the FiLM-SIREN per point."""
    return 3 * H + (L - 1) * H * H + H * C + C * R + H


def serve_bound(S, peak, n=128 * 128, widths=(128, 2, 64, 32)):
    """#2's bound at a one-row frame of n rays and S coarse samples a ray
    (phase 5's shapes; ``widths`` H, L, C, R, the flagship's by default):
    the multiply-adds of both passes at 2 FLOP each over ``peak``; the
    points, rays, depths and draws read once, the weights once, the
    features and depths written once (the bf16 calls take and give the same
    f32 tensors: the same bytes)."""
    H, L, C, R = widths
    macs = siren_macs(H, L, C, R)
    fwd_in_bytes = 4 * n * (S * 3 + 6 + 3 * S + 2 * S)
    return bound_ms(2 * n * 2 * S * macs, fwd_in_bytes + 4 * macs + 4 * n * (R + 1), peak)


def train_bounds(dn, S=12, widths=(128, 2, 64, 32)):
    """Bounds of #2r, #3 residual and #3 recompute at the training shapes
    timed in phases 8 and 15(c) (r64, b = 4, S = 12; phase 8 also S = 48
    and the cap; ``widths`` H, L, C, R, the flagship's by default, phase 20
    also depth 3) with ``dn`` ("float32" or "bfloat16") products: the
    multiply-adds at 2 FLOP each over that dtype's peak; each input read
    once and each output written once.  With bf16 products the residuals h
    and hc are bf16 (a and ac stay f32), and so is phase 15(c)'s #2r
    feature."""
    b, n = 4, 64 * 64
    H, L, C, R = widths
    half = dn == "bfloat16"
    peak = BF16_PEAK if half else F32_PEAK
    pts = b * n * 2 * S
    macs = siren_macs(H, L, C, R)
    in_bytes = 4 * b * n * (S * 3 + 6 + 3 * S + 2 * S) + 4 * macs
    res_bytes = pts * (L * H + C) * (2 + 4 if half else 8)
    fwd_out = b * n * (R * (2 if half else 4) + 4)   # feature, depth
    bwd_in = 4 * b * n * (R + 1)                     # their cotangents
    grad_bytes = 4 * (macs + L * H + C + R + 1 + b * (2 * L * H + 2 * C) + b * n * S * 3)
    bwd_macs = pts * 2 * macs - (pts // 2) * 3 * H   # d-weight + d-input; fine points: no d x
    return {"ray_tile_residuals": bound_ms(2 * pts * macs, in_bytes + res_bytes + fwd_out, peak),
            "ray_tile_bwd_residual": bound_ms(2 * bwd_macs,
                                              in_bytes + res_bytes + bwd_in + grad_bytes, peak),
            "ray_tile_bwd_recompute": bound_ms(2 * (bwd_macs + pts * macs),
                                               in_bytes + bwd_in + grad_bytes, peak)}


def frame_vs_cpu(gen, cpu_gen, dev, label, size=32, steps=12):
    """An r32 x 12 frame (or ``size`` x ``steps``; explicit camera, seeded
    draws) of ``gen`` on the card against ``cpu_gen``, the same weights on
    the plain CPU path; fails beyond FRAME_ATOL on more than MAX_OUTSIDE of
    the pixels or on depth."""
    import torch

    from cips3d_tpu_torch.apps.render import render_chunked
    from cips3d_tpu_torch.models.generator import RenderOptions, sample_zs
    from cips3d_tpu_torch.ops import ray_tile

    gc = torch.Generator().manual_seed(5)
    zs = sample_zs(1, gen.cfg, gc)
    opts = RenderOptions(img_size=size, num_steps=steps, h_stddev=0.0, v_stddev=0.0)
    pos = torch.tensor([[0.2, 0.15, 0.968]])
    pos = pos / pos.norm()
    n = size * size
    uniform = torch.rand((1, n, steps, 1), generator=gc)
    draws = [ray_tile.draw_ray_randoms(1, n, steps, False, gc, "cpu")]
    with torch.no_grad():
        st_c = cpu_gen.mapping(zs["z_nerf"], zs["z_inr"])
        st_g = {k: v.to(dev) for k, v in st_c.items()}
        ref_img, ref_dep = render_chunked(cpu_gen, st_c, opts, None, n, pos, -pos,
                                          return_depth=True, perturb_uniform=uniform,
                                          chunk_draws=draws)
        got_img, got_dep = render_chunked(
            gen, st_g, opts, None, n, pos.to(dev), -pos.to(dev), return_depth=True,
            perturb_uniform=uniform.to(dev),
            chunk_draws=[ray_tile.RayDraws(*(t.to(dev) for t in draws[0]))])
    e_img = (got_img.cpu() - ref_img).abs()
    e_dep = (got_dep.cpu() - ref_dep).abs()
    share = (e_img > FRAME_ATOL).any(1).float().mean().item()
    log(f"{label}: max_abs_err {e_img.max().item():.3e} "
        f"depth {e_dep.max().item():.3e}; pixels outside atol {FRAME_ATOL}: {share:.2e}")
    if share > MAX_OUTSIDE or e_dep.max().item() > FRAME_ATOL:
        raise AssertionError(f"{label}: the kernel path disagrees with the plain path")


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
    b = 4, S = 12.  Returns the max abs errors of the main-path cases: f32
    under the kernel's name, bf16 under "<name> bfloat16"."""
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
    # S = 12 as the training steps take it; then S = 48 and the cap (each lane of a ray's
    # warp holding several samples), without density noise
    for S in (12, LONG_STEPS, rt.MAX_STEPS):
        at = "" if S == 12 else f" S={S}"
        if S != 12:
            log(f"phase 6 compare: training kernels at S={S}, r64 b={b}, without noise")
            with torch.no_grad():
                world = gen.sample_world(b, RenderOptions(img_size=64, num_steps=S), g)
        for mode, fs in (("residual", False), ("recompute", True)):
            for noise in ((0.0, 0.5) if S == 12 else (0.0,)):
                draws = rt.draw_ray_randoms(b, n, S, noise != 0, g, dev)
                args = (wt, world.points, world.origins, world.dirs, world.z_vals[..., 0], *draws,
                        noise)
                d_fea = torch.randn((b, n, 32), generator=g, device=dev)
                d_dep = torch.randn((b, n, 1), generator=g, device=dev)
                tag = f"{mode} fast_sin={fs} noise={noise}" + at
                witness = None
                if noise:   # the plain backward with fine depths from a float64 resample
                    d64 = [t.double() for t in (world.points, world.z_vals[..., 0], draws.u,
                                                draws.nc)]
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
                        if noise == 0:
                            errs["ray_tile_residuals" + ("" if mm == f32 else " bfloat16") + at] = e
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
                    if mm == bf16 and noise == 0:
                        errs[f"ray_tile_bwd_{mode} bfloat16" + at] = max(
                            (a - b_).abs().max().item() for a, b_ in zip(ga, gb))
                    if mm == f32:
                        if noise == 0:
                            errs[f"ray_tile_bwd_{mode}" + at] = max(
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
                        # the plain backward against autograd through the plain forward; past
                        # S = 12 both in float64: f32 autograd through the 2S x 2S compositing
                        # products rounds beyond the tolerance there (1.35e-4 at S = 48, where
                        # both backwards lie 1.5e-5 from a float64 run)
                        dt = torch.float32 if S == 12 else torch.float64
                        leaves = [w.to(dt).clone().requires_grad_() for w in wt]
                        targs = [t.to(dt) for t in args[1:8]]
                        with torch.enable_grad():
                            fea, dep = rt.ray_tile_plain(leaves, *targs, noise, fast_sin=fs,
                                                         mm_dtype=dt)
                            auto = torch.autograd.grad((fea, dep), leaves,
                                                       (d_fea.to(dt), d_dep.to(dt)))
                        ref = gb if S == 12 else rt.ray_tile_bwd_plain(
                            [w.to(dt) for w in wt], *targs, noise, d_fea.to(dt), d_dep.to(dt),
                            fast_sin=fs, mm_dtype=dt)[0]
                        ae = max_grad_err(ref, auto)
                        del leaves, targs, fea, dep, ref
                        log(f"  3 {tag} float32: two runs bitwise equal: {same}; plain backward vs "
                            f"autograd of the plain forward {ae:.2e} ({str(dt)[6:]}); kernel vs "
                            f"autograd {max_grad_err(ga, auto):.2e}")
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


def host_metrics(m):
    """A step's metrics (0-d tensors on the device) as floats: waits for it."""
    return {k: float(v) for k, v in m.items()}


def step_snapshot(state):
    import torch

    return [[p.detach().clone() for p in m.parameters()]
            for m in (state.generator, state.discriminator, state.ema)]


def profile_step(fn, state, real, rng, log, label, smi, phase=8):
    """One more call ``fn(state, real, rng=rng)`` (a step) under
    `torch.profiler` (`bench/report.py::profile_call`): the device time by
    operation, and the device's busy share of the call's host time."""
    from cips3d_tpu_torch.bench import report

    p = report.profile_call(lambda: fn(state, real, rng=rng))
    log(f"phase {phase} profile: {label}: {p['wall_ms']:.1f} ms on the host clock (profiled), "
        f"device busy {p['busy_ms']:.1f} ms = {100 - p['idle_pct']:.1f} %, idle "
        f"{p['idle_pct']:.1f} %, {p['device_events']} device events [{smi}]; device time by "
        f"kernel:")
    for ms, count, key in p["top"]:
        log(f"    {ms:8.2f} ms {count:5d} x {key[:90]}")
    log("  record_function ranges on the device timeline (spans, not summed): " + (", ".join(
        f"{key[:60]} {ms:.2f} ms over {count}" for key, ms, count in p["ranges"]) or "none"))


def kernel_counts():
    """Every kernel's launch count since the counters were last zeroed."""
    from cips3d_tpu_torch.ops import build

    return {name: build.launches(name) for name in build.KERNELS}


def zero_kernel_counts():
    from cips3d_tpu_torch.ops import build

    build.reset_launches()


def train_run(dev, cfg_g, steps, log, label="", smi="", tcfg=None, disc_kwargs=None,
              aux_reg=True, profile=True, loader=None):
    """Phase 7: `steps` training steps (by default r64, b = 4, aux on);
    returns (host times per step in ms, launch counts, peak device memory
    in bytes); then, with ``profile``, profiles one more step.  With
    ``loader`` each step takes its reals from it (uint8 batches to the card,
    inside the timed step, as the training loop feeds them); else from
    seeded noise on the card."""
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
        batch = real[i] if loader is None else torch.from_numpy(next(loader)[0]).to(dev)
        state, m = fn(state, batch, rng=rng)
        m = host_metrics(m)   # waits for the step
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
        profile_step(fn, state, real[-1], rng, log, f"train step {label}", smi)
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
            m = host_metrics(m)
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
    """Phases 6-8; returns the median step ms of each r64 config, phase 6's
    max abs errors and the summary entries of the training kernels."""
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

    # kernel times at the training shapes (r64, b = 4, S = 12, f32); then S = 48 and the cap
    b, n = 4, 64 * 64
    H, L, C, R = 128, 2, 64, 32
    gen = GeneratorNerfINR(GeneratorConfig(fused_ray=True),
                           generator=torch.Generator().manual_seed(40)).to(dev)
    g = torch.Generator(dev).manual_seed(41)
    with torch.no_grad():
        zs = sample_zs(b, gen.cfg, g, device=dev)
        wt = rt.flat_weights(gen.siren, gen.mapping(zs["z_nerf"], zs["z_inr"]))
    ptxas = ptxas_resources(build.build().with_suffix(".log").read_text())
    times = {}
    for S in (12, LONG_STEPS, rt.MAX_STEPS):
        with torch.no_grad():
            world = gen.sample_world(b, RenderOptions(img_size=64, num_steps=S), g)
            args = (wt, world.points, world.origins, world.dirs, world.z_vals[..., 0],
                    *rt.draw_ray_randoms(b, n, S, True, g, dev),
                    torch.full((), 0.5, device=dev))   # the noise as the step passes it
            d_fea = torch.randn((b, n, R), generator=g, device=dev)
            d_dep = torch.randn((b, n, 1), generator=g, device=dev)
            res = rt.ray_tile_cuda(*args, with_residuals=True)[2]
            times[S] = {
                "ray_tile_residuals": cuda_ms(
                    [lambda: rt.ray_tile_plain(*args, with_residuals=True),
                     lambda: rt.ray_tile_cuda(*args, with_residuals=True)], reps=10),
                "ray_tile_bwd_residual": cuda_ms(
                    [lambda: rt.ray_tile_bwd_plain(*args, d_fea, d_dep, residuals=res),
                     lambda: rt.ray_tile_bwd_cuda(*args, d_fea, d_dep, residuals=res)], reps=10),
                "ray_tile_bwd_recompute": cuda_ms(
                    [lambda: rt.ray_tile_bwd_plain(*args, d_fea, d_dep, fast_sin=True),
                     lambda: rt.ray_tile_bwd_cuda(*args, d_fea, d_dep, fast_sin=True)], reps=10)}
            del world, args, res
        occ = rt.kernel_occupancy(S, L, H, C, R)
        for name, key in (("2r ray tile with residuals (exact sine)", "ray_tile_residuals"),
                          ("3 backward, residual mode (exact sine)", "ray_tile_bwd_residual"),
                          ("3 backward, recompute mode (fast_sin)", "ray_tile_bwd_recompute")):
            plain, kern = times[S][key]
            log(f"phase 8 time: {name} r64 b=4 S={S} noise 0.5 (a device operand) f32: kernel "
                f"{kern:.3f} ms, plain {plain:.3f} ms [{smi}]; {resources_line(key, occ, ptxas)}")
    t_res, t_bres, t_brec = (times[12][k] for k in ("ray_tile_residuals", "ray_tile_bwd_residual",
                                                    "ray_tile_bwd_recompute"))
    log(f"phase 8 done in {time.perf_counter() - t0:.1f} s (step times in phase 7)")
    bnd = train_bounds("float32")

    def entry(name, source, replaces, count, err, t, bnd):
        e = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": count, "max_abs_err": err, "ms": t[1], "plain_ms": t[0],
             "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}
        for S in (LONG_STEPS, rt.MAX_STEPS):   # the same row past 32 samples a ray
            b_s = train_bounds("float32", S)[name]
            e.update({f"ms_s{S}": times[S][name][1], f"plain_ms_s{S}": times[S][name][0],
                      f"bound_ms_s{S}": b_s[0], f"bound_by_s{S}": b_s[1],
                      f"max_abs_err_s{S}": errs[f"{name} S={S}"]})
        return e

    return step_ms, errs, [
        entry("ray_tile_residuals", "cips3d_tpu_torch/csrc/ray_tile.cu",
              "cips3d_tpu/ops/pallas/ray_tile.py:207", launches["ray_tile_residuals"],
              errs["ray_tile_residuals"], t_res, bnd["ray_tile_residuals"]),
        entry("ray_tile_bwd_residual", "cips3d_tpu_torch/csrc/ray_tile_bwd.cu",
              "cips3d_tpu/ops/pallas/ray_tile.py:421", launches["ray_tile_bwd_residual"],
              errs["ray_tile_bwd_residual"], t_bres, bnd["ray_tile_bwd_residual"]),
        entry("ray_tile_bwd_recompute", "cips3d_tpu_torch/csrc/ray_tile_bwd.cu",
              "cips3d_tpu/ops/pallas/ray_tile.py:421", launches["ray_tile_bwd_recompute"],
              errs["ray_tile_bwd_recompute"], t_brec, bnd["ray_tile_bwd_recompute"]),
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
    from cips3d_tpu_torch.ops import build

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
    zero_kernel_counts()
    frame = RenderService(gen, img_size=64, num_steps=12).frame(seed=0)
    counts = (build.launches("ray_tile"), build.launches("inr_tile"))
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
        m = host_metrics(m)
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
    profile_step(fn, state, real[-1], rng, log, f"train step r{img} b={b} {name}", smi, phase=10)
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
            m = host_metrics(m)
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


# phase 10(d): the training CLI without --debug, so that its loop chunks.  Of its 5 steps,
# step 0 runs alone (the step-0 eval), steps 1-2 as a chunk of 2 and step 3 as one of 1 (the
# eval after step 4), step 4 as one of 1 (the final eval)
LOOP_OPTS = ("total_iters", "5", "eval_every", "4", "log_every", "1", "num_images_real_eval",
             "16", "num_images_gen_eval", "16", "num_workers", "2")
LOOP_RUNS = {   # name: (config, dispatch_chunk, in a one-rank NCCL group)
    "flagship k=1": ("ffhq", 1, False), "flagship k=2": ("ffhq", 2, False),
    "flagship k=2 NCCL": ("ffhq", 2, True),
    "diffcam k=1": ("diffcam", 1, False), "diffcam k=2": ("diffcam", 2, False),
}


def loop_run(argv):
    """One training-CLI run of phase 10(d), in a subprocess that
    `loop_cli_runs` starts: ``argv`` as the CLI takes it, after ``--nccl``
    for a one-rank NCCL group made here (the loop then steps through the
    group, its all-reduces captured with the step).  Deterministic
    algorithms on, so that the runs agree bit for bit.  Prints the final
    state's host and device counters."""
    import torch
    import torch.distributed as dist

    from cips3d_tpu_torch.train import cli, loop

    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    nccl = argv[:1] == ["--nccl"]
    final, run_pipeline = [], loop.run_pipeline

    def keep_state(*args, **kw):
        final.append(run_pipeline(*args, **kw))
        return final[-1]

    loop.run_pipeline = cli.run_pipeline = keep_state
    t0 = time.perf_counter()
    if nccl:
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                                world_size=1, rank=0)
    try:
        rc = cli.run(cli.parse_args(argv[1:] if nccl else argv))
    finally:
        if nccl:
            dist.destroy_process_group()
    print(f"final state: step {final[0].step} step_t {int(final[0].step_t)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return rc


def loop_cli_runs(tmp, data):
    """Start the LOOP_RUNS together, each `loop_run` in a subprocess on
    train_r32 at full width on phase 9's zip, output to files under
    ``tmp``.  Returns {name: (process, outdir)}."""
    root = os.path.dirname(os.path.abspath(__file__))
    procs = {}
    for name, (config, k, nccl) in LOOP_RUNS.items():
        out = os.path.join(tmp, "loop", re.sub(r"\W+", "_", name))
        os.makedirs(out)
        cmd = ([sys.executable, os.path.abspath(__file__), "--loop-run"]
               + (["--nccl"] if nccl else [])
               + ["--config", f"configs/{config}.yaml", "--command", "train_r32", "--opts",
                  "data_path", data, "outdir", out, "dispatch_chunk", str(k), *LOOP_OPTS])
        with open(os.path.join(out, "stdout.txt"), "w") as fo, \
                open(os.path.join(out, "stderr.txt"), "w") as fe:
            procs[name] = (subprocess.Popen(cmd, cwd=root, stdout=fo, stderr=fe), out)
    return procs


def check_loop_runs(procs, log, smi):
    """Phase 10(d): every run logged steps 1-5 and its evals and ended with
    both counters at 5; a run of chunks of 2 captured its step into a CUDA
    graph, one of chunks of 1 stepped eagerly; the resume trees (modules
    and optimizer states, the camera's for diffcam) of a config's runs are
    equal bit for bit."""
    import numpy as np

    trees = {}
    for name, (p, out) in procs.items():
        rc = p.wait(timeout=900)
        text = open(os.path.join(out, "stdout.txt")).read()
        lines = [ln for ln in text.splitlines()
                 if ln.startswith(("step ", "dispatch:", "final state:"))]
        log(f"phase 10 loop: {name}: train_r32 {' '.join(LOOP_OPTS[:6])} exit {rc}: "
            + " | ".join(lines) + f" [{smi}]")
        k = LOOP_RUNS[name][1]
        missing = [w for w in [f"step {i}: d_loss=" for i in range(1, 6)]
                   + ["FID_surrogate=", "final state: step 5 step_t 5 "] if w not in text]
        captured = "captured into a CUDA graph" in text
        if rc != 0 or missing or captured != (k > 1) or (k == 1 and "dispatch:" in text):
            log(open(os.path.join(out, "stderr.txt")).read()[-4000:])
            raise AssertionError(f"phase 10 loop {name}: exit {rc}, missing {missing}, "
                                 f"captured {captured}")
        rdir = os.path.join(out, "train_r32", "ckptdir", "resume")
        trees[name] = {f"{f}/{key}": a for f in sorted(os.listdir(rdir)) if f.endswith(".npz")
                       for key, a in np.load(os.path.join(rdir, f)).items()}
    for ref in ("flagship k=1", "diffcam k=1"):
        for name in [n for n in trees if n != ref and n.split()[0] == ref.split()[0]]:
            a, b = trees[ref], trees[name]
            diff = [key for key in a if key not in b or not np.array_equal(a[key], b[key])]
            log(f"  {name} vs {ref}: resume trees {len(a)} vs {len(b)} arrays, "
                f"{len(diff)} differ")
            if diff or len(a) != len(b):
                raise AssertionError(f"phase 10 loop: {name}'s resume tree is not {ref}'s: "
                                     f"{diff[:5]}")


def variant_phase(dev, smi, log, tmp, data):
    """Phase 10: the diffcam and pi-GAN pipelines at full width (10 steps
    each at r64 with step time, images/s and peak memory), their r32 step
    on the card against the CPU, their CLI in subprocesses, the flagship's
    two-stage `run_progressive`, and the loop in chunks (`check_loop_runs`:
    the training CLI without ``--debug``, in subprocesses beside the
    rest)."""
    import gc
    import os
    import threading

    import torch

    steps = {}
    for name in ("diffcam", "pigan"):
        log(f"phase 10 train: {name} (configs/{name}.yaml train_r64), full width, 10 steps")
        ms, b, peak, times = variant_train(dev, name, 10, log, smi)
        steps[name] = ms
        q = statistics.quantiles(times[2:], n=4)
        log(f"phase 10 time: train step r64 b={b} {name}: median {ms:.1f} ms (quartiles "
            f"{q[0]:.1f}..{q[2]:.1f}, steps 2-9; first {times[0]:.1f} ms) = {b * 1e3 / ms:.2f} "
            f"images/s, max_memory_allocated {peak / 2 ** 30:.2f} GiB [{smi}]")

    # the CLI runs in subprocesses, one thread a variant, and the loop's runs in chunks,
    # beside the in-process checks below; this process's cached blocks go back to the card
    # first (seven subprocesses share it)
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    log(f"phase 10: {free / 2 ** 30:.2f} of {total / 2 ** 30:.2f} GiB of the card free before "
        f"the CLI runs in subprocesses")
    cli = {name: [] for name in ("diffcam", "pigan")}
    workers = [threading.Thread(target=lambda n=name: cli[n].extend(variant_cli(tmp, data, n)))
               for name in cli]
    for w in workers:
        w.start()
    loop_procs = {}
    try:
        loop_procs = loop_cli_runs(tmp, data)
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
        check_loop_runs(loop_procs, log, smi)
    finally:
        for p, _ in loop_procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
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


def timed(fn, reps):
    """Host-clock ms of each of ``reps`` calls of ``fn``, each ending in a
    synchronise."""
    import torch

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def median_line(times):
    q = statistics.quantiles(times, n=4)
    return (f"median {statistics.median(times):.2f} ms over {len(times)} (quartiles "
            f"{q[0]:.2f}..{q[2]:.2f}, min {min(times):.2f}, max {max(times):.2f})")


def eval_cli_runs(tmp, data):
    """Phase 11's CLI runs: every mode of `python -m cips3d_tpu_torch.eval.cli`
    on phase 9's r64 snapshot with configs/ffhq.yaml train_r64's generator
    and the serving flags, started together.  Returns {label: (seconds,
    CompletedProcess, out dir)}."""
    import os
    import threading

    root = os.path.dirname(os.path.abspath(__file__))
    common = ["--ckpt", f"{tmp}/train_r64/ckptdir/best_fid", "--config", "configs/ffhq.yaml",
              "--command", "train_r64", "--serving"]
    runs = {
        "trajectory": ["trajectory", "--trajectory-mode", "translate_rotate", "--num-frames", "8",
                       "--img-size", "128", "--num-steps", "24", "--depth"],
        "viewer": ["viewer", "--seeds", "0", "1"],
        "multiview": ["multiview", "--seeds", "0", "--img-size", "64"],
        "gen": ["gen", "--num-images", "8", "--img-size", "64"],
        "sample": ["sample", "--num-images", "4", "--img-size", "64"],
        "fid --allow-surrogate": ["fid", "--data", data, "--allow-surrogate", "--num-images", "8",
                                  "--img-size", "64"],
        "fid": ["fid", "--data", data, "--num-images", "8", "--img-size", "64"],
    }
    out = {}

    def one(label, args):
        out_dir = os.path.join(tmp, "eval", label.replace(" ", "_").replace("-", ""))
        if args[0] == "multiview":
            out_dir += ".png"
        if args[0] == "viewer":
            out_dir += ".html"
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "cips3d_tpu_torch.eval.cli", *args, *common,
                            "--out", out_dir], cwd=root, capture_output=True, text=True,
                           timeout=600)
        out[label] = (time.perf_counter() - t0, p, out_dir)

    workers = [threading.Thread(target=one, args=item) for item in runs.items()]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    if sorted(out) != sorted(runs):
        raise AssertionError(f"eval CLI runs missing: {sorted(set(runs) - set(out))}")
    return out


def check_eval_cli(out, log, smi):
    """The files each phase-11 CLI run must leave (JAX-layout snapshot in,
    PNG/AVI/HTML out); ``fid`` without --allow-surrogate must refuse unless
    the InceptionV3 checkpoint is found."""
    import base64
    import os

    import numpy as np

    from cips3d_tpu_torch.eval.inception import find_weights
    from cips3d_tpu_torch.utils import image_io, video

    def jpeg_ok(b):
        return b[:2] == b"\xff\xd8" and b[-2:] == b"\xff\xd9"

    failed = []
    for label, (secs, p, out_dir) in out.items():
        refuse = label == "fid" and find_weights() is None
        note = ""
        if refuse:
            ok = p.returncode != 0 and "InceptionV3 weights are unavailable" in p.stderr
            note = p.stderr.strip().splitlines()[-1] if p.stderr.strip() else "no message"
        elif p.returncode != 0:
            ok = False
        elif label == "trajectory":
            names = set(os.listdir(out_dir))
            avis = [video.read_mjpeg_avi(os.path.join(out_dir, f"{v}.avi"))
                    for v in ("video", "depth")]
            shapes = {image_io.read_png(os.path.join(out_dir, f"frame_{i:04d}.png")).shape
                      for i in range(8)}
            ok = (all(f"{k}_{i:04d}.png" in names for k in ("frame", "depth") for i in range(8))
                  and shapes == {(128, 128, 3)}
                  and all(len(a) == 8 and all(f.shape == (128, 128, 3) for f in a)
                          for a in avis))
            note = (f"{len(names)} files, {sum(len(a) for a in avis)} frames decoded from "
                    f"video.avi + depth.avi")
        elif label == "viewer":
            html = open(out_dir).read()
            grid = json.loads(re.search(r"const F = (.*?);", html).group(1))
            flat = [base64.b64decode(s) for s in np.ravel(grid)]
            ok = np.array(grid).shape == (2, 3, 9) and all(jpeg_ok(j) for j in flat)
            note = f"frames {np.array(grid).shape}, {len(html) / 1e6:.2f} MB"
        elif label == "multiview":
            shape = image_io.read_png(out_dir).shape
            ok, note = shape == (64, 320, 3), f"grid {shape}"
        elif label in ("gen", "sample"):
            files = sorted(os.listdir(out_dir))
            n = 8 if label == "gen" else 4
            ok = len(files) == n and image_io.read_png(os.path.join(out_dir, files[0])).shape \
                == (64, 64, 3)
            note = f"{len(files)} PNGs"
        else:
            ok = "FID" in p.stdout
            note = p.stdout.strip().splitlines()[0] if p.stdout.strip() else ""
        took = [ln for ln in p.stdout.splitlines() if "after loading" in ln]
        log(f"phase 11 cli: {label} exit {p.returncode} in {secs:.1f} s (wall, the 7 runs "
            f"together) {took[0] if took else ''}: {note} [{smi}]")
        if not ok:
            log(p.stdout[-2000:] + p.stderr[-4000:])
            failed.append(label)
    if failed:
        raise AssertionError(f"eval CLI runs failed their checks: {failed}")


def apps_phase(dev, smi, log, tmp, data, gen, cpu_gen):
    """Phase 11: the eval CLI and the apps on the card at full width: a
    translate_rotate trajectory frame (explicit camera with an up vector) on
    the card vs the CPU; inversion on the exact-sine config (#2r forward,
    #3 residual backward into the styles) on the card vs the CPU; the sigma
    volume on the card vs the CPU; times; then every eval CLI mode in
    subprocesses.  Returns the launch counts of its in-process checks."""
    import os

    import numpy as np
    import torch

    from cips3d_tpu_torch.apps import inversion, render, shapes
    from cips3d_tpu_torch.models.discriminator import DiscriminatorMultiScaleAux
    from cips3d_tpu_torch.models.generator import (GeneratorConfig, GeneratorNerfINR,
                                                   RenderOptions, sample_zs)
    from cips3d_tpu_torch.ops import ray_tile

    counts = {name: 0 for name in kernel_counts()}

    def add(c):
        for k, v in c.items():
            counts[k] += v

    # ---- a translate_rotate frame with a rolled up vector, card vs CPU, r64 x 12
    xyz, lookup, up = render.build_trajectory("translate_rotate", 30)
    i = 8 + 8 + 7                               # the 8th frame of the roll segment
    gc = torch.Generator().manual_seed(11)
    zs = sample_zs(1, gen.cfg, gc)
    opts = RenderOptions(img_size=64, num_steps=12, h_stddev=0.0, v_stddev=0.0)
    uniform = torch.rand((1, 4096, 12, 1), generator=gc)
    draws = ray_tile.draw_ray_randoms(1, 4096, 12, False, gc, "cpu")
    cam = [torch.as_tensor(v[i:i + 1]) for v in (xyz, lookup, up)]
    with torch.no_grad():
        st_c = cpu_gen.mapping(zs["z_nerf"], zs["z_inr"])
        st_g = {k: v.to(dev) for k, v in st_c.items()}
        ref_img, ref_dep = render.render_chunked(cpu_gen, st_c, opts, None, 4096, *cam,
                                                 return_depth=True, perturb_uniform=uniform,
                                                 chunk_draws=[draws])
        zero_kernel_counts()
        got_img, got_dep = render.render_chunked(
            gen, st_g, opts, None, 4096, *(c.to(dev) for c in cam), return_depth=True,
            perturb_uniform=uniform.to(dev),
            chunk_draws=[ray_tile.RayDraws(*(t.to(dev) for t in draws))])
        torch.cuda.synchronize()
    c = kernel_counts()
    add(c)
    e_img = (got_img.cpu() - ref_img).abs()
    e_dep = (got_dep.cpu() - ref_dep).abs()
    share = (e_img > FRAME_ATOL).any(1).float().mean().item()
    log(f"phase 11 frame: translate_rotate frame {i} (up {up[i].round(3).tolist()}), r64 x12, "
        f"card vs CPU: max_abs_err {e_img.max().item():.3e} depth {e_dep.max().item():.3e}; "
        f"pixels outside atol {FRAME_ATOL}: {share:.2e}; launches {c}")
    if share > MAX_OUTSIDE or e_dep.max().item() > FRAME_ATOL or \
            c["ray_tile"] <= 0 or c["inr_tile"] <= 0:
        raise AssertionError("the explicit-camera frame disagrees with the CPU or missed a kernel")

    # ---- trajectory-frame times, r128 x 24 and r256 x 12 (serving flags, full width)
    frame_ms = {}
    for size, steps in ((128, SERVING_STEPS), (256, 12)):
        o = RenderOptions(img_size=size, num_steps=steps, h_stddev=0.0, v_stddev=0.0)
        js = itertools.count()

        def frame():
            j = next(js) % len(xyz)
            img, dep = render.render_frame(gen, st_g, o, j, render.Draws(dev), 256 ** 2,
                                           xyz[j:j + 1], lookup[j:j + 1], up[j:j + 1],
                                           return_depth=True)
            return render.depth_to_uint8(dep[0, 0].float().cpu().numpy(), o), img.cpu()

        timed(frame, 2)
        zero_kernel_counts()
        times = timed(frame, 20)
        add(kernel_counts())
        frame_ms[size] = statistics.median(times)
        log(f"phase 11 time: trajectory frame r{size} x{steps} (translate_rotate, captured, "
            f"host clock, image and depth on the host): {median_line(times)} [{smi}]")

    # ---- inversion on the exact-sine config, r64 x 12, 5 steps, card vs CPU
    exact = GeneratorConfig(fast_sin=False, fused_ray=True, fused_ray_vjp="pallas_residual")
    inv_cpu = GeneratorNerfINR(exact, generator=torch.Generator().manual_seed(30))
    disc_cpu = DiscriminatorMultiScaleAux(max_size=1024, generator=torch.Generator().manual_seed(31))
    inv_dev, disc_dev = copy.deepcopy(inv_cpu).to(dev), copy.deepcopy(disc_cpu).to(dev)
    yy, xx = np.mgrid[0:64, 0:64] / 63.0
    target = np.stack([np.sin(3 * xx), np.cos(2 * yy), xx * yy * 2 - 1]).astype(np.float32) * 0.8
    d_cpu = inversion.draw_inversion(inv_cpu, 5, 64, 12, avg_samples=2000, seed=0)
    d_dev = inversion.InversionDraws(
        {k: v.to(dev) for k, v in d_cpu.avg_zs.items()},
        {k: v.to(dev) for k, v in d_cpu.noise.items()},
        [ray_tile.RayDraws(*(t.to(dev) for t in r)) for r in d_cpu.rays])
    kw = dict(img_size=64, num_steps=12, log_every=1)
    t1 = time.perf_counter()
    _, _, hist_cpu = inversion.project_image(
        inv_cpu, target, num_steps_opt=1, draws=d_cpu._replace(rays=d_cpu.rays[:1]),
        percept_fn=inversion.make_disc_percept_fn(disc_cpu), **kw)
    cpu_secs = time.perf_counter() - t1
    # each step timed on the host clock; step 0 warms up, captures and replays
    proj = inversion.Projector(inv_dev, target, 5, draws=d_dev,
                               percept_fn=inversion.make_disc_percept_fn(disc_dev), **kw)
    steps_ms = []
    zero_kernel_counts()
    for i in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        proj.step()
        torch.cuda.synchronize()
        steps_ms.append((time.perf_counter() - t1) * 1e3)
        if i == 0:
            c0 = kernel_counts()
            zero_kernel_counts()
    c = kernel_counts()
    _, img, hist = proj.result()
    proj.close()
    add(c0)
    add(c)
    rel = abs(hist[0] - hist_cpu[0]) / abs(hist_cpu[0])
    log(f"phase 11 inversion: exact sine (#2r + #3 residual), full width, r64 x12, D percept, "
        f"5 Adam steps on the card (one captured step, replayed): loss "
        f"{' -> '.join(f'{v:.6f}' for v in hist)}; step 0 CPU {hist_cpu[0]:.6f} (rel diff "
        f"{rel:.2e}, CPU step {cpu_secs:.1f} s); launches of step 0 (warm-up and replay) {c0}, "
        f"of steps 1-4 (replays) {c}")
    log(f"phase 11 time: inversion step r64 x12 (captured; host clock, steps 0-4, step 0 "
        f"includes the warm-up and the capture): {median_line(steps_ms)} [{smi}]")
    if rel > STEP_TOL["loss_rtol"] or not hist[-1] < hist[0] or not np.isfinite(img).all() \
            or c0["ray_tile_residuals"] != 2 or c0["ray_tile_bwd_residual"] != 2 \
            or c["ray_tile_residuals"] != 4 or c["ray_tile_bwd_residual"] != 4 \
            or c["ray_tile"] or c["inr_tile"] or c0["ray_tile"] or c0["inr_tile"]:
        raise AssertionError("inversion: the card's loss disagrees with the CPU's, did not "
                             "fall, or the step did not run #2r and #3 once each")
    profile_step(lambda *a, **k: inversion.project_image(
        inv_dev, target, num_steps_opt=3, draws=d_dev._replace(rays=d_dev.rays[:3]),
        percept_fn=inversion.make_disc_percept_fn(disc_dev), dispatch="eager", **kw), None,
        None, None, log, "inversion, 3 eager steps with the set-up (mean style of 2000 draws; "
        "phase 17(e) profiles a captured step)", smi, phase=11)

    # ---- the sigma volume: n = 64 card vs CPU, the MRC, n = 128 timed
    with torch.no_grad():
        vol_c = shapes.sample_sigma_volume(cpu_gen, n=64, styles=st_c)
        vol_g = shapes.sample_sigma_volume(gen, n=64, styles=st_g)
    err = np.abs(vol_g - vol_c).max() / (np.abs(vol_c).max() + 1)
    path = os.path.join(tmp, "sigma_64.mrc")
    shapes.write_mrc(path, vol_g)
    back = shapes.read_mrc(path)
    log(f"phase 11 shapes: sigma n=64 card vs CPU max|a-b|/(max|b|+1) {err:.2e} (sigma "
        f"{vol_c.min():.3f}..{vol_c.max():.3f}); MRC {os.path.getsize(path)} bytes read back "
        f"{'equal' if np.array_equal(back, vol_g) else 'DIFFERENT'}")
    if err > 1e-4 or not np.array_equal(back, vol_g):
        raise AssertionError("sigma volume: card vs CPU or the MRC round trip failed")
    times = timed(lambda: shapes.sample_sigma_volume(gen, n=128, styles=st_g), 3)
    log(f"phase 11 time: sigma volume n=128 (2.1 M points in 64 k chunks, one captured chunk "
        f"replayed, to the host once): {median_line(times)} [{smi}]")
    profile_step(lambda *a, **k: shapes.sample_sigma_volume(gen, n=128, styles=st_g), None, None,
                 None, log, "sigma volume n=128, captured", smi, phase=11)

    # ---- every eval CLI mode, from phase 9's r64 snapshot
    check_eval_cli(eval_cli_runs(tmp, data), log, smi)
    return counts


# ---- phase 12: the data path ------------------------------------------------

def photo(seed, h, w):
    """A seeded stand-in for a photograph: smooth waves and noise (PIL's
    PNG encoder picks a mix of row filters for it, Paeth the most)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    f = rng.uniform(3, 12, 3)
    ph = rng.uniform(0, 6, 3)
    base = np.stack([128 + 100 * np.sin(xx / f[0] + yy / 11 + ph[0]),
                     128 + 90 * np.cos(yy / f[1] + ph[1]),
                     128 + 80 * np.sin((xx - yy) / f[2] + ph[2])], -1)
    return np.clip(base + rng.normal(0, 10, base.shape), 0, 255).astype(np.uint8)


def plain_vs_native(path, idxs):
    """Decode members ``idxs`` of the zip through the plain reader (numpy's
    PNG decoder) and the native one; returns [(index, max abs diff)] of
    those that differ, and how many rows use each PNG filter.  Runs in a
    worker process: the plain decoder holds the GIL."""
    import zipfile
    import zlib

    import numpy as np

    from cips3d_tpu_torch.data.zip_dataset import ZipImageDataset

    nat, plain = ZipImageDataset(path), ZipImageDataset(path, use_native=False)
    bad, filters = [], np.zeros(5, np.int64)
    with zipfile.ZipFile(path) as zf:
        for i in idxs:
            a, b = nat[i][0], plain[i][0]
            if a.shape != b.shape or not np.array_equal(a, b):
                bad.append((i, int(np.abs(a.astype(int) - b).max()) if a.shape == b.shape else -1))
            data, pos, idat = zf.read(nat._names[i]), 8, b""
            while pos < len(data):   # the filter byte that starts each row
                n = int.from_bytes(data[pos:pos + 4], "big")
                if data[pos + 4:pos + 8] == b"IDAT":
                    idat += data[pos + 8:pos + 8 + n]
                pos += 12 + n
            rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(a.shape[1], -1)
            filters += np.bincount(rows[:, 0], minlength=5)[:5]
    return bad, filters


def loader_rate(dataset, batches, b=4, workers=4):
    """Images/s of the port's DataLoader over ``dataset``: from its start to
    the ``batches``-th batch (no batch waits in a queue before the clock)."""
    from cips3d_tpu_torch.data.zip_dataset import DataLoader

    t0 = time.perf_counter()
    loader = DataLoader(dataset, batch_size=b, seed=0, num_workers=workers)
    try:
        shapes = {next(loader)[0].shape for _ in range(batches)}
    finally:
        loader.close()
    return batches * b / (time.perf_counter() - t0), shapes


def data_phase(dev, smi, log, tmp, shipped_step_ms):
    """Phase 12: the data path at real sizes on the card's host: JPEG
    fixtures, the dataset tool on 256 r256 images, the loader's rates, 10
    shipped training steps fed from the zip, a CelebA list.  Returns the
    kernel launches of those steps."""
    import os
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
    from multiprocessing import get_context

    import numpy as np

    from cips3d_tpu_torch import native
    from cips3d_tpu_torch.data import named_datasets
    from cips3d_tpu_torch.data.zip_dataset import DataLoader, ZipImageDataset
    from cips3d_tpu_torch.models.generator import GeneratorConfig
    from cips3d_tpu_torch.utils import image_io, video

    root = os.path.dirname(os.path.abspath(__file__))
    # the JPEG fixtures PIL wrote and decoded: held exact (the CPU tests' bound)
    fx = os.path.join(root, "cips3d_tpu_torch", "native", "fixtures")
    names = sorted(f[:-4] for f in os.listdir(fx) if f.endswith(".jpg"))
    errs = []
    for name in names:
        got = native.read_image(os.path.join(fx, name + ".jpg")).astype(int)
        want = np.load(os.path.join(fx, name + ".npy"))
        d = np.abs(got - want) if got.shape == want.shape else np.full(1, 255)
        errs.append(f"{name} {d.max()}/{(d > 0).mean():.1%}")
        if d.max() > 0:
            raise AssertionError(f"JPEG fixture {name}: the native decode is not PIL's ({errs[-1]})")
    log(f"phase 12 fixtures: {len(names)} JPEGs vs PIL's pixels, max abs diff / share off: "
        f"{', '.join(errs)} (bound: exact)")

    # 256 seeded r256 images: 224 PNG (encode_png) and 32 JPEG (encode_jpeg)
    src = os.path.join(tmp, "faces")
    os.makedirs(src)

    def write(i):
        img = photo(1000 + i, 256, 256)
        data, ext = (image_io.encode_png(img), "png") if i < 224 else (
            video.encode_jpeg(img, 90), "jpg")
        with open(os.path.join(src, f"face{i:04d}.{ext}"), "wb") as f:
            f.write(data)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, range(256)))
    t_write = time.perf_counter() - t0
    data = os.path.join(tmp, "faces256.zip")
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "cips3d_tpu_torch.data.dataset_tool", "--source",
                        src, "--dest", data], capture_output=True, text=True, timeout=300,
                       cwd=root)
    t_tool = time.perf_counter() - t0
    if p.returncode != 0 or f"wrote 256 images to {data}" not in p.stdout:
        raise AssertionError(f"dataset_tool exit {p.returncode}: {p.stdout}{p.stderr[-3000:]}")
    nat = ZipImageDataset(data)
    if len(nat) != 256 or nat._names != [f"img{i:08d}.png" for i in range(256)]:
        raise AssertionError(f"the tool's zip holds {len(nat)} images: {nat._names[:3]}...")
    t0 = time.perf_counter()
    with ProcessPoolExecutor(8, mp_context=get_context("spawn")) as pool:
        parts = list(pool.map(plain_vs_native, [data] * 8, [range(k, 256, 8) for k in range(8)]))
    t_check = time.perf_counter() - t0
    bad = sum((b for b, _ in parts), [])
    filters = sum(f for _, f in parts)
    if bad:
        raise AssertionError(f"native and plain readers differ on members {bad[:10]}")
    if nat[0][0].shape != (3, 256, 256):
        raise AssertionError(f"member 0 decodes to {nat[0][0].shape}")
    log(f"phase 12 dataset_tool: 224 PNG + 32 JPEG r256 sources written in {t_write:.1f} s; "
        f"`python -m cips3d_tpu_torch.data.dataset_tool` -> 256 members "
        f"({os.path.getsize(data) / 2 ** 20:.1f} MiB) in {t_tool:.1f} s (subprocess wall); every "
        f"member decodes identically through the native and plain readers (checked in "
        f"{t_check:.1f} s, 8 processes); rows by PNG filter none/sub/up/average/paeth "
        f"{'/'.join(str(int(v)) for v in filters)}")

    # the loader's rate, 4 threads, b = 4
    rates = {}
    for label, ds, batches in (
            ("r256 plain", ZipImageDataset(data, use_native=False), 8),
            ("r256 native", ZipImageDataset(data), 64),
            ("r256->r64 native", ZipImageDataset(data, resize_resolution=64), 64)):
        rates[label], shapes = loader_rate(ds, batches)
        size = 64 if "r64" in label else 256
        if shapes != {(4, 3, size, size)}:
            raise AssertionError(f"loader {label}: batch shapes {shapes}")
    shipped = 4e3 / shipped_step_ms
    for label, rate in rates.items():
        log(f"phase 12 time: DataLoader (4 threads, b=4) {label}: {rate:.1f} images/s [{smi}]")
    log(f"phase 12 loader vs step: r256->r64 native {rates['r256->r64 native']:.1f} images/s, "
        f"phase 8's shipped r64 step {shipped:.2f} images/s: ratio "
        f"{rates['r256->r64 native'] / shipped:.1f} (at least 2)")
    if rates["r256->r64 native"] < 2 * shipped:
        raise AssertionError("the native loader at r256->r64 is not twice the shipped step's rate")

    # 10 steps of phase 8's shipped cell, fed from the tool's zip
    loader = DataLoader(ZipImageDataset(data, resize_resolution=64, xflip=True), batch_size=4,
                        seed=1, num_workers=4)
    try:
        times, counts, _ = train_run(dev, GeneratorConfig(fast_sin=True, fused_ray=False), 10,
                                     log, SHIPPED, smi, profile=False, loader=loader)
    finally:
        loader.close()
    if counts["ray_tile"] <= 0 or counts["inr_tile"] <= 0:
        raise AssertionError(f"training from the zip: kernels not launched: {counts}")
    med = statistics.median(times[2:])
    log(f"phase 12 time: train step r64 b=4 {SHIPPED}, reals from the zip (r256->r64, xflip): "
        f"median {med:.1f} ms (steps 2-9; {4e3 / med:.2f} images/s) beside phase 8's "
        f"{shipped_step_ms:.1f} ms on seeded noise [{smi}]")

    # a CelebA list of 178 x 218 JPEGs through get_dataset and the loader
    celeba = os.path.join(tmp, "celeba")
    os.makedirs(celeba)

    def write_celeba(i):
        with open(os.path.join(celeba, f"{i:06d}.jpg"), "wb") as f:
            f.write(video.encode_jpeg(photo(2000 + i, 218, 178), 90))

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write_celeba, range(64)))
    lst = os.path.join(tmp, "celeba.txt")
    with open(lst, "w") as f:
        f.write("\n".join(f"celeba/{i:06d}.jpg" for i in range(64)))
    ds = named_datasets.get_dataset("CelebA", 64, image_list_file=lst)
    img = native.read_image(os.path.join(celeba, "000003.jpg"))
    tall = round(218 * 320 / 178)   # the shorter side (178) to 320, then the centre 256
    top = (tall - 256) // 2
    plain = image_io.resize_bilinear(img, 320, tall)[top:top + 256, 32:288]
    plain = image_io.resize_nearest(plain, 64, 64)
    if len(ds) != 128 or not np.array_equal(ds[3][0], plain.transpose(2, 0, 1)) or \
            not np.array_equal(ds[64 + 3][0], plain[:, ::-1].transpose(2, 0, 1)):
        raise AssertionError("CelebA item 3 (and its flip) is not the plain versions' pipeline")
    rate, shapes = loader_rate(ds, 32)
    if shapes != {(4, 3, 64, 64)}:
        raise AssertionError(f"CelebA loader: batch shapes {shapes}")
    log(f"phase 12 time: CelebA list, 64 JPEGs 178x218 -> r64 (get_dataset, 4 threads, b=4): "
        f"{rate:.1f} images/s; item 3 and its flip equal the plain versions' pipeline [{smi}]")
    return counts


# ---- phase 13: training on several processes ---------------------------------

def dist_case(kind, dev):
    """The weights (seeded), TrainConfig, aux flag, reals and global draws
    (seeded on the CPU, the same in every process) of one phase-13 step:
    ``r64`` the shipped config at r64, B = 4; ``r256`` train_r512's settings
    (freeze_nerf, DiffAug, warm-up, aux off, no density noise) at r256, B = 2."""
    import torch

    from cips3d_tpu_torch.models.discriminator import DiscriminatorMultiScaleAux
    from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR, RenderOptions
    from cips3d_tpu_torch.train.state import TrainConfig
    from cips3d_tpu_torch.train.step import draw_step

    if kind == "r64":
        cfg_g, disc_kw, aux, batch = GeneratorConfig(fast_sin=True, fused_ray=False), {}, True, 4
        tcfg = TrainConfig(img_size=64, batch_size=batch, ema_start_itr=0,
                           nerf_noise_disable=True)
    else:
        cfg_g, disc_kw, aux, batch = (GeneratorConfig(fast_sin=True, fused_ray=False,
                                                      freeze_nerf=True), dict(diffaug=True),
                                      False, 2)
        tcfg = TrainConfig(img_size=256, batch_size=batch, ema_start_itr=0, diffaug=True,
                           warmup_d=True, train_aux_img=False, nerf_noise_disable=True,
                           gen_lr=1e-4, disc_lr=5e-4)
    gen = GeneratorNerfINR(cfg_g, generator=torch.Generator().manual_seed(50)).to(dev)
    disc = DiscriminatorMultiScaleAux(max_size=1024, **disc_kw,
                                      generator=torch.Generator().manual_seed(51)).to(dev)
    g = torch.Generator().manual_seed(52)
    n = tcfg.img_size ** 2
    gp = tcfg.grad_points ** 2 if tcfg.grad_points and tcfg.grad_points ** 2 < n else None
    draws = draw_step(cfg_g, disc.main_disc.diffaug, tcfg,
                      RenderOptions(img_size=tcfg.img_size, nerf_noise=0.0), aux, gp, batch, g,
                      "cpu")
    real = torch.rand((batch, 3, tcfg.img_size, tcfg.img_size), generator=g) * 2 - 1
    return gen, disc, tcfg, aux, real.to(dev), to_device(draws, dev)


def dist_step(kind, dev, mesh=None):
    """One step of `dist_case` ``kind`` (the rank's rows with ``mesh``): its
    metrics, clipped grads, G, D and EMA parameters after it, peak memory,
    kernel launches and host time."""
    import torch

    import cips3d_tpu_torch.train.step as step_mod
    from cips3d_tpu_torch.models.generator import RenderOptions

    gen, disc, tcfg, aux, real, draws = dist_case(kind, dev)
    state = step_mod.init_train_state(gen, disc, tcfg)
    fn = step_mod.make_train_step(gen, disc, tcfg, RenderOptions(), aux_reg=aux, mesh=mesh)
    if mesh is not None:
        n = real.shape[0] // mesh.world
        real = real[mesh.rank * n:(mesh.rank + 1) * n]
    clip, seen = step_mod.clip_and_guard, []

    def recording(grads, max_norm):
        out = clip(grads, max_norm)
        seen.append([x.detach().cpu() for x in out[0]])
        return out

    step_mod.clip_and_guard = recording
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_kernel_counts()
        t0 = time.perf_counter()
        state, m = fn(state, real, draws=draws)
        m = host_metrics(m)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        step_mod.clip_and_guard = clip
    return dict(metrics=m, grads=seen, params=[[p.cpu() for p in x] for x in step_snapshot(state)],
                peak=torch.cuda.max_memory_allocated(dev), counts=kernel_counts(), secs=secs,
                lrs=(tcfg.gen_lr, tcfg.disc_lr, tcfg.gen_lr))


def dist_gap(got, ref):
    """Phase 7's measures of a step against another: the losses' largest rel
    err, the clipped D and G grads' normalised errors, the shares of G, D and
    EMA elements beyond STEP_TOL["param"] * lr."""
    lerr = max(abs(got["metrics"][k] - ref["metrics"][k]) / max(abs(ref["metrics"][k]), 1e-6)
               for k in ("d_loss", "g_loss", "grad_penalty"))
    gerr = [max(grad_err(a, b) for a, b in zip(x, y)) for x, y in zip(got["grads"], ref["grads"])]
    shares = []
    for lr, x, y in zip(ref["lrs"], got["params"], ref["params"]):
        far = sum(((a - b).abs() > STEP_TOL["param"] * lr).sum().item() for a, b in zip(x, y))
        shares.append(far / sum(a.numel() for a in x))
    return [lerr] + gerr + shares


def phase13_rank(out_dir):
    """One rank of phase 13(b): joins the gloo group of the CIPS3D_* env on
    cuda:0, runs the r64 step (1-D) and the r256 step (ray_shards 2) on its
    rows, and saves what `dist_step` returns."""
    import torch
    import torch.distributed as dist

    from cips3d_tpu_torch.parallel.mesh import (COLLECTIVES, initialize_multihost, local_device,
                                                make_mesh)

    if not initialize_multihost(device="cuda", backend="gloo"):
        raise SystemExit("phase 13 rank: CIPS3D_COORDINATOR/NUM_PROCESSES/PROCESS_ID not set")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(local_device("cuda"))
    torch.cuda.set_device(dev)
    try:
        res = {kind: dist_step(kind, dev, make_mesh(r)) for kind, r in (("r64", 1), ("r256", 2))}
        res["collectives"] = dict(COLLECTIVES)
        torch.save(res, os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_phase(dev, smi, log, tmp):
    """Phase 13: (a) 10 shipped r64 b = 4 steps through a one-rank NCCL
    group (flat all-reduces, barrier) against 10 steps without a process
    group, from the same weights and draws: bit for bit, or within the
    no-group run's own run-to-run gap; (b) two gloo ranks sharing the card,
    started as the training CLI is (the CIPS3D_* env), each one step: the
    shipped r64 step at b = 2 a rank against one process at b = 4, and
    train_r512's settings at r256 with ray_shards 2 against one process at
    r256 b = 2, at phase 7's tolerances.  Returns the launches of #1 and #2."""
    import copy

    import torch
    import torch.distributed as dist

    from cips3d_tpu_torch.models.generator import RenderOptions
    from cips3d_tpu_torch.parallel.mesh import COLLECTIVES, host_barrier, make_mesh
    from cips3d_tpu_torch.train.state import TrainConfig
    from cips3d_tpu_torch.train.step import draw_step, init_train_state, make_train_step

    launches = {"ray_tile": 0, "inr_tile": 0}
    # ---- (a) one NCCL rank against no process group
    gen0, disc0, tcfg, aux, _, _ = dist_case("r64", dev)
    g = torch.Generator().manual_seed(53)
    steps = 10
    draws = [to_device(draw_step(gen0.cfg, False, tcfg, RenderOptions(img_size=64), aux, None, 4,
                                 g, "cpu"), dev) for _ in range(steps)]
    reals = [(torch.rand((4, 3, 64, 64), generator=g) * 2 - 1).to(dev) for _ in range(steps)]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
                            rank=0)
    # deterministic convolutions and index reductions, so that two runs can agree bit for bit
    # (by default cuDNN's backward and the atomic scatters make 10 steps of one run differ
    # from the next by as much as 3e-2)
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    runs = {}
    try:
        for name, mesh in (("no group", None), ("no group again", None),
                           ("NCCL rank", make_mesh(1))):
            gen, disc = copy.deepcopy(gen0), copy.deepcopy(disc0)
            state = init_train_state(gen, disc, tcfg)
            fn = make_train_step(gen, disc, tcfg, RenderOptions(), aux_reg=aux, mesh=mesh)
            zero_kernel_counts()
            COLLECTIVES.clear()
            times = []
            for i in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = fn(state, reals[i], draws=draws[i])
                m = host_metrics(m)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            runs[name] = (step_snapshot(state), times, kernel_counts(),
                          sum(COLLECTIVES.values()), m)
        barrier = host_barrier("chip_smoke_phase13")
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic = cudnn_det
        torch.use_deterministic_algorithms(False)

    def maxdiff(a, b):
        return max((x - y).abs().max().item() for xs, ys in zip(a, b) for x, y in zip(xs, ys))

    rerun = maxdiff(runs["no group again"][0], runs["no group"][0])
    got = maxdiff(runs["NCCL rank"][0], runs["no group"][0])
    per_step = runs["NCCL rank"][3] / steps
    med = {k: statistics.median(v[1][2:]) for k, v in runs.items()}
    counts = runs["NCCL rank"][2]
    log(f"phase 13 nccl: 10 shipped r64 b=4 steps, one NCCL rank (init_process_group('nccl'), "
        f"world 1) vs no process group, same weights and draws, deterministic algorithms on "
        f"(all three runs): G, D and EMA max abs diff "
        f"{got:.3e} (no group vs itself: {rerun:.3e}); {per_step:g} collectives a step (D grads, "
        f"G grads, metrics), barrier {barrier}; median step (steps 2-9, host clock) "
        f"NCCL rank {med['NCCL rank']:.1f} ms, no group {med['no group']:.1f} / "
        f"{med['no group again']:.1f} ms; launches {counts} [{smi}]")
    # bit for bit; a nonzero gap between two runs without a group (a nondeterministic
    # library kernel) bounds the NCCL run instead
    if got > rerun or per_step != 3 or not barrier:
        raise AssertionError("phase 13(a): the one-rank NCCL steps differ from the steps "
                             "without a process group")
    if counts["ray_tile"] <= 0 or counts["inr_tile"] <= 0:
        raise AssertionError(f"phase 13(a): kernels not launched: {counts}")
    for k in launches:
        launches[k] += counts[k]

    # ---- (b) two gloo ranks on the card against one process
    refs = {kind: dist_step(kind, dev) for kind in ("r64", "r256")}
    torch.cuda.empty_cache()
    port = free_port()
    out_dir = os.path.join(tmp, "phase13")
    os.makedirs(out_dir)
    procs, logs = [], []
    t0 = time.perf_counter()
    for rank in range(2):
        env = dict(os.environ, CIPS3D_COORDINATOR=f"127.0.0.1:{port}", CIPS3D_NUM_PROCESSES="2",
                   CIPS3D_PROCESS_ID=str(rank))
        # to a file, not a pipe: a full pipe would stall a rank inside a collective
        logs.append(os.path.join(out_dir, f"rank{rank}.log"))
        with open(logs[-1], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--phase13-rank", out_dir], env=env,
                stdout=f, stderr=subprocess.STDOUT,
                cwd=os.path.dirname(os.path.abspath(__file__))))
    try:
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.perf_counter() - t0
    for rank, (p, path) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            with open(path) as f:
                out = f.read()
            raise AssertionError(f"phase 13 rank {rank} exited {p.returncode}:\n{out[-3000:]}")
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    tols = [STEP_TOL["loss_rtol"], STEP_TOL["grad"], STEP_TOL["grad"]] + [MAX_OUTSIDE] * 3
    labels = {"r64": f"{SHIPPED}, r64, 2 ranks x b=2 (1-D) vs one process b=4",
              "r256": f"{R256}, r256, ray_shards 2, one ray group of 2 ranks (b=2, each half "
                      f"the pixels, D on 1 row) vs one process b=2"}
    for kind, label in labels.items():
        ref = refs[kind]
        for rank, res in enumerate(ranks):
            gap = dist_gap(res[kind], ref)
            log(f"phase 13 gloo: {label}: rank {rank}: losses rel err {gap[0]:.2e}, clipped grads "
                f"D {gap[1]:.2e} G {gap[2]:.2e}, parameters beyond {STEP_TOL['param']} lr: G "
                f"{gap[3]:.2e} D {gap[4]:.2e} EMA {gap[5]:.2e} (tolerances {tols}); peak memory "
                f"{res[kind]['peak'] / 2 ** 30:.2f} GiB vs one process "
                f"{ref['peak'] / 2 ** 30:.2f} GiB; step {res[kind]['secs'] * 1e3:.1f} ms vs "
                f"{ref['secs'] * 1e3:.1f} ms (first steps, host clock); launches "
                f"{res[kind]['counts']} [{smi}]")
            if any(x > tol for x, tol in zip(gap, tols)):
                raise AssertionError(f"phase 13(b): rank {rank} disagrees with one process "
                                     f"({kind}): {gap} against {tols}")
            if res[kind]["counts"]["ray_tile"] <= 0 or res[kind]["counts"]["inr_tile"] <= 0:
                raise AssertionError(f"phase 13(b): rank {rank} ({kind}) launched no kernel")
            for k in launches:
                launches[k] += res[kind]["counts"][k]
        same = all(torch.equal(a, b) for x, y in zip(ranks[0][kind]["params"],
                                                      ranks[1][kind]["params"])
                   for a, b in zip(x, y))
        if not same:
            raise AssertionError(f"phase 13(b): the two ranks' parameters differ ({kind})")
    log(f"phase 13 gloo: both ranks hold the same parameters bit for bit; collectives a rank "
        f"{ranks[0]['collectives']} on CUDA tensors (gloo, no staging); two ranks in "
        f"{secs:.1f} s wall (start-up included)")
    return launches


# ---- phase 14: a reference checkpoint on the card ----------------------------

ZOO_TOL = dict(rtol=1e-4, atol=1e-5)   # f32 modules, card vs CPU (TF32 off)


def zoo_cases():
    """(name, module, inputs) of every class of models/legacy.py and
    models/nerf_variants.py at its default widths (where the JAX module
    infers a width, the reference's: 32-wide features, 256 and 512 hidden),
    on b = 2 x 1024 points, seeded."""
    import numpy as np
    import torch

    from cips3d_tpu_torch.models import legacy as lg
    from cips3d_tpu_torch.models import nerf_variants as nv

    rng = np.random.default_rng(14)
    b, n = 2, 1024

    def x(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    def styles(keys, dim):
        return {k: x(b, dim) for k in keys}

    def prog(prefix, resolutions, dim):
        return styles([f"{prefix}_w{r}_{j}" for r in resolutions for j in (0, 1)], dim)

    pts = x(b, n, 3, scale=0.1)
    nerf = styles(["nerf_w0", "nerf_w1", "nerf_rgb"], 128)
    g = torch.Generator().manual_seed(140)
    return [
        ("CLN", lg.CLN(256, 256, generator=g), (x(b, n, 256, scale=3.0), x(b, 256))),
        ("CLNLayer", lg.CLNLayer(32, 256, 256, generator=g), (x(b, n, 32), x(b, 256))),
        ("INRNetwork", lg.INRNetwork(32, 256, 4, 256, generator=g),
         (x(b, n, 32), styles([f"inr_w{i}" for i in range(4)], 256))),
        ("INRNetworkSkip", lg.INRNetworkSkip(32, 9, 512, generator=g),
         (x(b, n, 32), styles([f"inr_w{i}_{j}" for i in range(9) for j in (0, 1)], 512))),
        ("PosEmbedding", lg.PosEmbedding(), (pts,)),
        ("FCNet", lg.FCNet(32, 256, 4, generator=g), (x(b, n, 32),)),
        ("ModulatedFCConv", lg.ModulatedFCConv(512, 512, 512, generator=g),
         (x(b, n, 512), x(b, 512))),
        ("INRNetworkSkipProg", lg.INRNetworkSkipProg(32, 256, generator=g),
         (x(b, n, 32), prog("inr", lg.PROG_RESOLUTIONS, 256))),
        ("CLNBlock", lg.CLNBlock(256, 256, 256, generator=g),
         (x(b, n, 256), x(b, 256), x(b, 256), True)),
        ("INRNetworkSkipCLN", lg.INRNetworkSkipCLN(32, 256, generator=g),
         (x(b, n, 32), prog("inr", lg.CLN_RESOLUTIONS, 256))),
        ("LinearSkipProg", lg.LinearSkipProg(32, 256, generator=g),
         (x(b, n, 32), styles(["linear_w"], 256))),
        ("ModSinLayer", lg.ModSinLayer(256, 256, generator=g), (x(b, n, 256, scale=3.0), x(b, 256))),
        ("ModSinLayer sine", lg.ModSinLayer(256, 256, use_sine=True, freq=2.0, generator=g),
         (x(b, n, 256), x(b, 256))),
        ("NeRFNetworkCLN", nv.NeRFNetworkCLN(generator=g), (pts, nerf)),
        ("FreqPhaseFiLM", nv.FreqPhaseFiLM(3, 128, generator=g), (pts, x(b, 256))),
        ("NeRFNetworkFreqPhase", nv.NeRFNetworkFreqPhase(generator=g),
         (pts, {"nerf_w0": x(b, 256), "nerf_w1": x(b, 256), "nerf_rgb": x(b, 128)})),
        ("NeRFNetworkFreqPhase pos_embed", nv.NeRFNetworkFreqPhase(use_pos_embed=True, generator=g),
         (pts, {"nerf_w0": x(b, 256), "nerf_w1": x(b, 256), "nerf_rgb": x(b, 128)})),
        ("NeRFNetworkSmall", nv.NeRFNetworkSmall(generator=g), (pts, nerf)),
        ("NeRFNetworkL", nv.NeRFNetworkL(generator=g), (pts, nerf)),
        ("LinearSinAct", nv.LinearSinAct(3, 64, generator=g), (pts,)),
        ("NeRFNetworkSigma", nv.NeRFNetworkSigma(generator=g), (pts, nerf)),
    ]


def zoo_on_card(dev, log):
    """Each zoo module on the card against the CPU, from the same weights:
    the forward at ZOO_TOL, one backward of a seeded cotangent (every
    parameter's and every input's grad) by the normalised error < 1e-4.
    A module whose grads miss that bound passes only if the card's grads
    are at most F64_RATIO times as far from a float64 CPU run as the CPU's
    own f32 grads are (rounding that the module amplifies, as in the deep
    conditional LayerNorms)."""
    import torch

    def leaves(a):
        if isinstance(a, dict):
            return list(a.values())
        return [a] if torch.is_tensor(a) else []

    def run(mod, inputs, d, dtype=torch.float32):
        for sub in mod.modules():   # the layers cast their inputs to their compute dtype
            if hasattr(sub, "dtype"):
                sub.dtype = dtype
        args = [({k: v.to(d, dtype).requires_grad_(True) for k, v in a.items()}
                 if isinstance(a, dict) else a.to(d, dtype).requires_grad_(True)
                 if torch.is_tensor(a) else a) for a in inputs]
        out = mod(*args)
        out = torch.cat(out, -1) if isinstance(out, tuple) else out
        cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(141)).to(d, dtype)
        wrt = list(mod.parameters()) + [t for a in args for t in leaves(a)]
        grads = torch.autograd.grad((out * cot).sum(), wrt, allow_unused=True)
        return out.detach().cpu(), [None if g_ is None else g_.cpu() for g_ in grads]

    def gerr(ga, gb):
        return max([grad_err(a, b) for a, b in zip(ga, gb) if b is not None] or [0.0])

    worst, cases = 0.0, zoo_cases()
    for name, cpu_mod, inputs in cases:
        dev_mod = copy.deepcopy(cpu_mod).to(dev)
        ref, g_ref = run(cpu_mod, inputs, "cpu")
        got, g_got = run(dev_mod, inputs, dev)
        err = (got - ref).abs()
        share = (err > ZOO_TOL["atol"] + ZOO_TOL["rtol"] * ref.abs()).float().mean().item()
        g_err = gerr(g_got, g_ref)
        worst = max(worst, g_err)
        witness = ""
        if g_err >= 1e-4:
            _, g64 = run(copy.deepcopy(cpu_mod).double(), inputs, "cpu", torch.float64)
            w_cpu, w_card = gerr(g_ref, g64), gerr(g_got, g64)
            witness = (f"; over 1e-4: from a float64 CPU run the card {w_card:.2e}, the CPU's "
                       f"f32 {w_cpu:.2e} (bound {F64_RATIO}x)")
        log(f"phase 14 zoo: {name} {tuple(got.shape)}: card vs CPU max_abs_err "
            f"{err.max().item():.3e}, outside rtol {ZOO_TOL['rtol']} atol {ZOO_TOL['atol']}: "
            f"{share:.2e}; grads ({len(g_ref)}) normalised err {g_err:.2e}{witness}")
        if share > 0 or not torch.isfinite(got).all() or (
                g_err >= 1e-4 and w_card > F64_RATIO * w_cpu):
            raise AssertionError(f"phase 14 zoo: {name} disagrees between the card and the CPU")
    return len(cases), worst


def checkpoint_phase(dev, smi, log, tmp, gen):
    """Phase 14: the seeded flagship ``gen`` and a phase-7 discriminator
    exported as the reference's checkpoint directory and read back three
    ways, bit for bit; the loaded G served through RenderService (#1, #2)
    against the source G's frames, and an r32 frame against the plain CPU
    path; the parity gate's self-test and dry run in subprocesses; the
    model zoo on the card against the CPU.  Returns the launches of the
    loaded G's serving."""
    import os

    import torch

    from cips3d_tpu_torch.apps.serve import RenderService
    from cips3d_tpu_torch.eval.cli import serving_config
    from cips3d_tpu_torch.models.discriminator import DiscriminatorMultiScaleAux
    from cips3d_tpu_torch.utils import convert_torch as ct

    # ---- (a) export and read back
    t1 = time.perf_counter()
    disc = DiscriminatorMultiScaleAux(max_size=1024, generator=torch.Generator().manual_seed(21))
    out = os.path.join(tmp, "reference_ckpt")
    ct.export_reference_checkpoint_dir(out, gen, generator=gen, info_msg="chip_smoke phase 14",
                                       discriminator=disc.state_dict())
    files = sorted(os.listdir(out))
    want = ["G_ema_model.pth", "discriminator_model.pth", "generator_model.pth", "info.txt"]
    with open(os.path.join(out, "info.txt")) as f:
        info = f.read()
    d_back = torch.load(os.path.join(out, "discriminator_model.pth"))
    d_same = sorted(d_back) == sorted(disc.state_dict()) and all(
        torch.equal(d_back[k], v) for k, v in disc.state_dict().items())
    sizes = {f: os.path.getsize(os.path.join(out, f)) for f in files}
    log(f"phase 14 export: {files} ({sum(sizes.values()) / 2 ** 20:.1f} MiB) in "
        f"{time.perf_counter() - t1:.1f} s [{smi}]; info.txt {info!r}; discriminator read back "
        f"bit for bit: {d_same}")
    if files != want or info != "chip_smoke phase 14\n" or not d_same:
        raise AssertionError(f"phase 14: the checkpoint directory is not the reference's: {files}")
    src = gen.state_dict()
    sd = torch.load(os.path.join(out, "G_ema_model.pth"))
    variants = {"as written": os.path.join(out, "G_ema_model.pth"),
                "wrapped": os.path.join(tmp, "G_ema_wrapped.pth"),
                "to_rbgs": os.path.join(tmp, "G_ema_to_rbgs.pth")}
    torch.save({"state_dict": sd, "epoch": 645500}, variants["wrapped"])
    torch.save({k.replace("inr_net.to_rgbs.", "inr_net.to_rbgs."): v for k, v in sd.items()},
               variants["to_rbgs"])
    loaded = {}
    for label, path in variants.items():
        t1 = time.perf_counter()
        g_l = ct.load_reference_generator(path, serving_config(), device=dev)
        secs = time.perf_counter() - t1
        own = g_l.state_dict()
        same = sorted(own) == sorted(src) and all(torch.equal(own[k], v) for k, v in src.items())
        log(f"phase 14 load: {label}: {len(own)} tensors, every one equal to the source bit for "
            f"bit: {same}; load_reference_generator to the card {secs:.2f} s [{smi}]")
        if not same:
            raise AssertionError(f"phase 14: the {label} checkpoint did not round-trip")
        loaded[label] = g_l

    # ---- (b) serve the loaded G against the source G
    g_l = loaded["as written"]
    frames = {}
    for who, model in (("source", gen), ("loaded", g_l)):
        svc = RenderService(model, img_size=128, num_steps=SERVING_STEPS)
        svc256 = RenderService(model, img_size=256, num_steps=12)
        zero_kernel_counts()
        t1 = time.perf_counter()
        frames[who] = [svc.render(seed=s, psi=0.7)[0] for s in (0, 1, 2)] + \
            [svc256.render(seed=0, psi=0.7)[0]]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        counts = kernel_counts()
        svc.close()
        svc256.close()
    launches = {"ray_tile": counts["ray_tile"], "inr_tile": counts["inr_tile"]}
    exact = all(torch.equal(a, b) for a, b in zip(frames["loaded"], frames["source"]))
    diff = max((a - b).abs().max().item() for a, b in zip(frames["loaded"], frames["source"]))
    log(f"phase 14 serve: loaded G through RenderService, r128 x{SERVING_STEPS} seeds 0-2 and "
        f"r256 x12 seed 0 (psi 0.7) in {secs:.2f} s [{smi}]: frames equal to the source G's bit "
        f"for bit: {exact}; max abs diff {diff:.3e} (bound FRAME_ATOL {FRAME_ATOL}); "
        f"launches {launches}")
    if diff > FRAME_ATOL or min(launches.values()) <= 0:
        raise AssertionError("phase 14: the loaded G does not serve the source G's frames "
                             "through the kernels")
    for f in frames["loaded"]:
        if not torch.isfinite(f).all():
            raise AssertionError("phase 14: a served frame is not finite")
    frame_vs_cpu(g_l, copy.deepcopy(g_l).cpu(), dev,
                 "phase 14 frame: loaded G, r32 x12, card vs plain CPU path")

    # ---- (c) the gate in subprocesses
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if not k.startswith("CIPS3D_")}
    gate = os.path.join(tmp, "gate")
    t1 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "cips3d_tpu_torch.tools.parity_gate", "--self-test",
                        "--outdir", gate], cwd=root, env=env, capture_output=True, text=True,
                       timeout=600)
    secs = time.perf_counter() - t1
    fid = re.search(r"FID = (\S+) ", p.stdout)
    fid = float(fid.group(1)) if fid else float("nan")
    n_real, n_fake = (len(glob.glob(os.path.join(gate, "fid", d, "*.png"))) for d in ("real", "fake"))
    log(f"phase 14 gate: --self-test exit {p.returncode} in {secs:.1f} s [{smi}]: {n_real} real, "
        f"{n_fake} fake PNGs, FID {fid} | " + " | ".join(
            ln.strip() for ln in p.stdout.splitlines()
            if ln.strip().startswith(("pool3", "reverse", "strict", "reference-class", "self-test"))))
    if p.returncode != 0 or n_real != 24 or n_fake != 24 or not math.isfinite(fid):
        log(p.stdout[-3000:] + p.stderr[-3000:])
        raise AssertionError("phase 14: the gate's self-test failed")
    empty = os.path.join(tmp, "empty")
    os.makedirs(empty)
    p = subprocess.run([sys.executable, "-m", "cips3d_tpu_torch.tools.parity_gate", "--dry-run"],
                       cwd=empty, env=dict(env, HOME=empty, PYTHONPATH=root), capture_output=True,
                       text=True, timeout=300)
    named = [w for w in ("- FFHQ dataset zip", "- InceptionV3 FID weights",
                         "- released reference checkpoints") if w in p.stdout]
    log(f"phase 14 gate: --dry-run in an empty directory exit {p.returncode}; the manifest "
        f"names {named}")
    if p.returncode != 1 or len(named) != 3:
        log(p.stdout[-3000:] + p.stderr[-3000:])
        raise AssertionError("phase 14: the gate's dry run did not name the missing artifacts")

    # ---- (d) the model zoo on the card
    t1 = time.perf_counter()
    n_cases, worst = zoo_on_card(dev, log)
    log(f"phase 14 zoo: {n_cases} modules card vs CPU in {time.perf_counter() - t1:.1f} s; worst "
        f"normalised grad err {worst:.2e}")
    return launches


# ---- phase 15: the benches and the bf16 path they drive -----------------------

def bf16_counts(before=None):
    """The kernels' launches by product dtype (`bench/report.py`), less
    ``before``."""
    from cips3d_tpu_torch.bench import report

    return report.launch_counts() if before is None else report.launches_since(before)


def bf16_run_step(gen, disc, cfg, dtype, dev, tcfg, draws, real):
    """One step of fresh ``dtype`` modules holding ``gen``'s and ``disc``'s
    weights on ``dev``: (metrics, [D grads, G grads] clipped, [D params, G
    params] after Adam, seconds), all on the CPU."""
    import torch

    import cips3d_tpu_torch.train.step as step_mod
    from cips3d_tpu_torch.models.discriminator import DiscriminatorMultiScaleAux
    from cips3d_tpu_torch.models.generator import GeneratorNerfINR, RenderOptions
    from cips3d_tpu_torch.train.step import init_train_state, make_train_step

    g_m = GeneratorNerfINR(cfg, dtype=dtype)
    g_m.load_state_dict(gen.state_dict())
    d_m = DiscriminatorMultiScaleAux(max_size=1024, dtype=dtype)
    d_m.load_state_dict(disc.state_dict())
    g_m, d_m = g_m.to(dev), d_m.to(dev)
    state = init_train_state(g_m, d_m, tcfg)
    clip, seen = step_mod.clip_and_guard, []

    def recording(grads, max_norm):
        out = clip(grads, max_norm)
        seen.append([x.detach().cpu() for x in out[0]])
        return out

    step_mod.clip_and_guard = recording
    try:
        fn = make_train_step(g_m, d_m, tcfg, RenderOptions(), aux_reg=True)
        t0 = time.perf_counter()
        m = host_metrics(fn(state, real.to(dev), draws=to_device(draws, dev))[1])
        secs = time.perf_counter() - t0
    finally:
        step_mod.clip_and_guard = clip
    params = [[p.detach().cpu() for p in mod.parameters()] for mod in (d_m, g_m)]
    return m, seen, params, secs


def bf16_grad_outliers(got, ref, ref32):
    """Elements of a gradient beyond BF16_RATIO x the witness's normalised
    error (ref against ref32), as `tests/test_torch_bench.py` counts them;
    and the distance and witness."""
    got, ref, ref32 = (x.double() for x in (got, ref, ref32))
    w = ((ref - ref32).abs().max() / (ref32.abs().max() + 1)).item()
    err = (got - ref).abs() / (ref.abs().max() + 1)
    return int((err > BF16_RATIO * w + BF16_ATOL).sum()), err.max().item(), w


def bf16_step_vs_cpu(dev, log, cfg, label):
    """Phase 15(a): one r32, b = 2 step at full width without density noise
    in bf16 on the card against the same bf16 step on the CPU (the plain
    versions), from the same weights, draws and reals, with the CPU's f32
    step (phase 7's) as the witness, by the rules of tests/test_torch_bench.py:
    losses within BF16_RATIO x the witness (abs); each clipped gradient's
    normalised error within BF16_RATIO x its witness on all but
    max(BF16_KINKS, 2 %) of its elements; after Adam, the parameters further
    than 2e-2 lr from the CPU bf16 step (or the CPU f32 step) at most
    BF16_RATIO x as many as the CPU bf16 step has from its f32 step, plus
    BF16_KINKS.  Returns the launches by product dtype on the card."""
    import torch

    from cips3d_tpu_torch.models.discriminator import DiscriminatorMultiScaleAux
    from cips3d_tpu_torch.models.generator import GeneratorNerfINR, RenderOptions
    from cips3d_tpu_torch.train.state import TrainConfig
    from cips3d_tpu_torch.train.step import draw_step

    b, img = 2, 32
    tcfg = TrainConfig(img_size=img, batch_size=b, ema_start_itr=0, nerf_noise_disable=True)
    gen = GeneratorNerfINR(cfg, generator=torch.Generator().manual_seed(51))
    disc = DiscriminatorMultiScaleAux(max_size=1024, generator=torch.Generator().manual_seed(52))
    gc = torch.Generator().manual_seed(50)
    draws = draw_step(cfg, False, tcfg, RenderOptions(img_size=img, nerf_noise=0.0), True, None,
                      b, gc, "cpu")
    real = torch.rand((b, 3, img, img), generator=gc) * 2 - 1
    cpu = torch.device("cpu")
    runs = {"cpu32": bf16_run_step(gen, disc, cfg, torch.float32, cpu, tcfg, draws, real),
            "cpu16": bf16_run_step(gen, disc, cfg, torch.bfloat16, cpu, tcfg, draws, real)}
    before = bf16_counts()
    runs["card16"] = bf16_run_step(gen, disc, cfg, torch.bfloat16, dev, tcfg, draws, real)
    launches = bf16_counts(before)
    (m32, g32, p32, s32), (m16, g16, p16, s16), (mc, gcard, pc, sc) = (
        runs[k] for k in ("cpu32", "cpu16", "card16"))
    losses = {k: (abs(mc[k] - m16[k]), abs(m16[k] - m32[k]))
              for k in ("d_loss", "g_loss", "grad_penalty")}
    bad = [k for k, (d, w) in losses.items() if d > BF16_RATIO * w + BF16_ATOL]
    names = [[n for n, _ in DiscriminatorMultiScaleAux(max_size=1024).named_parameters()],
             [n for n, _ in gen.named_parameters()]]
    worst, grad_fail = [], []
    for phase in (0, 1):
        for n, a, r, r32 in zip(names[phase], gcard[phase], g16[phase], g32[phase]):
            k, d, w = bf16_grad_outliers(a, r, r32)
            worst.append((d / max(w, 1e-12), n, d, w, k))
            if k > max(BF16_KINKS, 0.02 * a.numel()):
                grad_fail.append(n)
    param_fail, moved_total = [], [0, 0]
    for phase, lr in ((0, tcfg.disc_lr), (1, tcfg.gen_lr)):
        for n, a, r, r32 in zip(names[phase], pc[phase], p16[phase], p32[phase]):
            def moved(x, y):
                return int(((x.double() - y.double()).abs() > 2e-2 * lr).sum())

            d, w = min(moved(a, r), moved(a, r32)), moved(r, r32)
            moved_total[0] += d
            moved_total[1] += w
            if d > BF16_RATIO * w + BF16_KINKS:
                param_fail.append(f"{n} ({d} vs {w})")
    worst.sort(reverse=True)
    log(f"phase 15 bf16 step r{img} b={b} {label}, no noise, card vs CPU (witness: the CPU "
        f"bf16 step vs its f32 step): losses " + ", ".join(
            f"{k} {d:.2e} (witness {w:.2e})" for k, (d, w) in losses.items())
        + "; largest grad error over witness: " + ", ".join(
            f"{n} {d:.1e}/{w:.1e} ({k} beyond)" for _, n, d, w, k in worst[:3])
        + f"; parameters moved otherwise after Adam {moved_total[0]} (witness "
        f"{moved_total[1]}); steps: CPU f32 {s32:.1f} s, CPU bf16 {s16:.1f} s, card {sc:.2f} s; "
        f"card launches {launches}")
    if bad or grad_fail or param_fail:
        raise AssertionError(f"bf16 step {label}: the card disagrees with the CPU beyond the "
                             f"witness: losses {bad}, grads {grad_fail[:5]}, params "
                             f"{param_fail[:5]}")
    return launches


def bf16_frame_vs_cpu(gen, dev, log):
    """Phase 15(a): an r64 x 12 frame of the bf16 serving generator (both
    kernels, fast_sin; ``gen``'s weights) on the card against the same bf16
    frame on the CPU: the image's max abs error within BF16_RATIO x the
    witness (the CPU's bf16 frame against its f32 frame), and the share of
    depth pixels outside the bf16 tolerance within BF16_RATIO x the
    witness's share (at least MAX_OUTSIDE).  Returns the launches by product
    dtype."""
    import torch

    from cips3d_tpu_torch.apps.render import render_chunked
    from cips3d_tpu_torch.models.generator import GeneratorNerfINR, RenderOptions, sample_zs
    from cips3d_tpu_torch.ops import ray_tile

    gc = torch.Generator().manual_seed(55)
    zs = sample_zs(1, gen.cfg, gc)
    opts = RenderOptions(img_size=64, num_steps=12, h_stddev=0.0, v_stddev=0.0)
    pos = torch.tensor([[0.2, 0.15, 0.968]])
    pos = pos / pos.norm()
    uniform = torch.rand((1, 64 * 64, 12, 1), generator=gc)
    draws = ray_tile.draw_ray_randoms(1, 64 * 64, 12, False, gc, "cpu")
    out, launches = {}, None
    for name, dtype, d in (("cpu32", torch.float32, "cpu"), ("cpu16", torch.bfloat16, "cpu"),
                           ("card16", torch.bfloat16, dev)):
        g_m = GeneratorNerfINR(gen.cfg, dtype=dtype)
        g_m.load_state_dict(gen.state_dict())
        g_m = g_m.to(d).eval()
        before = bf16_counts()
        with torch.no_grad():
            st = g_m.mapping(zs["z_nerf"].to(d), zs["z_inr"].to(d))
            img, dep = render_chunked(g_m, st, opts, None, 64 * 64, pos.to(d), -pos.to(d),
                                      return_depth=True, perturb_uniform=uniform.to(d),
                                      chunk_draws=[ray_tile.RayDraws(*(t.to(d) for t in draws))])
        if name == "card16":
            launches = bf16_counts(before)
        out[name] = (img.float().cpu(), dep.float().cpu())
    (img16, dep16), (img32, dep32), (imgc, depc) = (out[k] for k in ("cpu16", "cpu32", "card16"))
    d = (imgc - img16).abs().max().item()
    w = (img16 - img32).abs().max().item()
    lim = BF16_RATIO * w + BF16_ATOL
    # depth, by the share of pixels outside the bf16 tolerance, as phase 3 holds it: a ray whose
    # depth-last density sits within a rounding of 0 moves its depth by up to the ray's length
    # (its 1e10 delta), so the bound is BF16_RATIO x the share the CPU's bf16 frame has outside
    # against its f32 frame, and never less than MAX_OUTSIDE
    tol = TOL["ray_tile", "bfloat16"]
    out_c = outside(depc.reshape(-1, 1), dep16.reshape(-1, 1), tol)
    out_w = outside(dep16.reshape(-1, 1), dep32.reshape(-1, 1), tol)
    share, wit = out_c.float().mean().item(), out_w.float().mean().item()
    lim_d = max(MAX_OUTSIDE, BF16_RATIO * wit)
    log(f"phase 15 bf16 frame r64 x12 (serving config, both kernels), card vs CPU (witness: "
        f"CPU bf16 vs f32): image max_abs_err {d:.3e} (witness {w:.3e}, limit {lim:.3e}); depth "
        f"max_abs_err {(depc - dep16).abs().max().item():.3e}, pixels outside rtol "
        f"{tol['rtol']} atol {tol['atol']}: {share:.2e} (witness {wit:.2e}, limit {lim_d:.2e}; "
        f"{int((out_c & ~out_w).sum())} of them where the witness is inside); card launches "
        f"{launches}")
    if d > lim or share > lim_d:
        raise AssertionError("bf16 frame: the card disagrees with the CPU beyond the witness "
                             "(image) or the bf16 tolerance (depth)")
    if set(launches) != {"ray_tile", "inr_tile"} or any(
            set(v) != {"bfloat16"} for v in launches.values()):
        raise AssertionError(f"bf16 frame: #1 and #2 not launched with bf16 products only: "
                             f"{launches}")
    return launches


# which kernels each bench leg must launch, all with bf16 products only
BENCH_LEGS = {
    ("train", "shipped"): ("ray_tile", "inr_tile"),
    ("train", "exact_sin"): ("ray_tile", "inr_tile", "ray_tile_residuals",
                             "ray_tile_bwd_residual"),
    ("train", "loader"): ("ray_tile", "inr_tile"),
    ("inference", "fused"): ("ray_tile", "inr_tile"),
    ("inference", "plain"): (),
}
INR_BF16_SYMBOL = re.compile(r"inr_tile_kernel(I13__nv_bfloat16E|<__nv_bfloat16>)")


def bench_run(module, args, env, log, smi, timeout):
    """``python -m cips3d_tpu_torch.bench.<module>`` in a subprocess with
    ``--report``; returns (its JSON line, its report, seconds)."""
    import os

    report = os.path.join(env["CHIP_SMOKE_TMP"], f"bench_{module}.json")
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", f"cips3d_tpu_torch.bench.{module}", *args,
                        "--report", report], capture_output=True, text=True, timeout=timeout,
                       env=env, cwd=os.path.dirname(os.path.abspath(__file__)))
    secs = time.perf_counter() - t0
    for line in p.stderr.strip().splitlines()[-14:]:
        log(f"    {line}")
    if p.returncode != 0:
        raise AssertionError(f"bench.{module} exited {p.returncode}: {p.stderr[-3000:]}")
    lines = [ln for ln in p.stdout.strip().splitlines() if ln.startswith("{")]
    if len(lines) != 1:
        raise AssertionError(f"bench.{module}: want one JSON line, got {p.stdout!r}")
    log(f"phase 15 bench.{module}: exit 0 in {secs:.1f} s: {lines[0]} [{smi}]")
    with open(report) as f:
        return json.loads(lines[0]), json.load(f), secs


def bench_phase(dev, smi, log, tmp, gen):
    """Phase 15: (a) the bf16 step of each bench leg and a bf16 frame on the
    card against the CPU; (b) both benches at their default sizes in
    subprocesses, their JSON lines and, per leg, the kernels' launches by
    product dtype, #1's bf16 symbol and the device's idle share of one
    profiled step or call; (c) #2r and #3 with bf16 products and their
    plain versions timed (phase 6 holds them against each other).  Returns
    the launches of each kernel (all bf16) and the times of (c), (plain ms,
    kernel ms) by kernel, for the summary line."""
    import os

    import torch

    from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR, RenderOptions
    from cips3d_tpu_torch.models.generator import sample_zs
    from cips3d_tpu_torch.ops import ray_tile as rt

    totals = {}

    def add(counts):
        for k, by in counts.items():
            totals[k] = totals.get(k, 0) + sum(by.values())

    t1 = time.perf_counter()
    legs = {"shipped": GeneratorConfig(fast_sin=True, fused_ray=False),
            "exact_sin": GeneratorConfig(fast_sin=False, fused_ray=True,
                                         fused_ray_vjp="pallas_residual")}
    for label, cfg in legs.items():
        counts = bf16_step_vs_cpu(dev, log, cfg, label)
        need = BENCH_LEGS["train", label]
        if set(counts) != set(need) or any(set(v) != {"bfloat16"} for v in counts.values()):
            raise AssertionError(f"bf16 step {label}: want {need} with bf16 products, got "
                                 f"{counts}")
        add(counts)
    add(bf16_frame_vs_cpu(gen, dev, log))
    log(f"phase 15(a) done in {time.perf_counter() - t1:.1f} s")

    # ---- (b) the benches as a user runs them
    env = dict(os.environ, CIPS3D_BENCH_DATA=os.path.join(tmp, "bench", "blobs_64.zip"),
               CHIP_SMOKE_TMP=tmp)
    for k in ("BENCH_FAST_SIN", "BENCH_FUSED", "BENCH_VJP", "BENCH_DPHASE", "BENCH_DPHASE_INR",
              "BENCH_BATCH", "BENCH_FUSED_INR"):
        env.pop(k, None)
    # 2 + 1 timed calls and 50 loader steps, not the bench's defaults 4 + 2 and 100: the
    # smoke run's time limit (the rates are the same measurement, over fewer calls)
    train_line, train_rep, _ = bench_run("train", ["--calls", "2", "--exact-calls", "1",
                                                   "--loader-steps", "50"], env, log, smi, 900)
    inf_line, inf_rep, _ = bench_run("inference", [], dict(env, BENCH_AB="1"), log, smi, 600)
    for line, keys, metric in (
            (train_line, ("exact_sin_imgs_per_sec", "loader_imgs_per_sec"),
             "train_imgs_per_sec_per_chip_r64"),
            (inf_line, ("xla_fps",), "novel_view_fps_per_chip_r256")):
        if line.get("metric") != metric or line.get("unit") not in ("imgs/s", "fps"):
            raise AssertionError(f"bench line {line}: want metric {metric}")
        for k in ("value", "vs_baseline") + keys:
            if not (isinstance(line.get(k), (int, float)) and math.isfinite(line[k])
                    and line[k] > 0):
                raise AssertionError(f"bench line {line}: {k} is not a finite positive number")
    for (bench, leg), need in BENCH_LEGS.items():
        rep = (train_rep if bench == "train" else inf_rep)[leg]
        counts = rep["launches"]
        add(counts)
        prof = rep.get("profile")
        what = prof and (f"chunk of {prof['steps']} steps" if bench == "train" else "call")
        idle = (f"; one profiled {what}: {prof['wall_ms']:.1f} "
                f"ms host clock, device busy {prof['busy_ms']:.1f} ms, idle "
                f"{prof['idle_pct']:.1f} %, {prof['device_events']} device events; the port's "
                f"kernels: {prof['kernels']}" if prof else "")
        rates = rep.get("rates")
        log(f"phase 15 bench.{bench} {leg}: launches by product dtype {counts}"
            + (f"; per-call rates {[round(r, 2) for r in rates]} (over all calls "
               f"{rep['value']:.2f}, median {rep['median']:.2f})" if rates else "")
            + idle + f" [{smi}]")
        if set(counts) != set(need) or any(set(v) != {"bfloat16"} for v in counts.values()):
            raise AssertionError(f"bench.{bench} {leg}: want {need} launched with bf16 products "
                                 f"only, got {counts}")
        if "inr_tile" in need and prof is not None and not any(
                INR_BF16_SYMBOL.search(k) for k in prof["kernels"]):
            raise AssertionError(f"bench.{bench} {leg}: #1's bf16 instantiation is not in the "
                                 f"profile: {prof['kernels']}")
    log(f"phase 15(b) done in {time.perf_counter() - t1:.1f} s")

    # ---- (c) #2r and #3 with bf16 products at the bench's G-phase shapes
    b, S, n, R = 4, 12, 64 * 64, 32
    g_m = GeneratorNerfINR(GeneratorConfig(fused_ray=True),
                           generator=torch.Generator().manual_seed(40)).to(dev)
    g = torch.Generator(dev).manual_seed(41)
    bf16 = dict(mm_dtype=torch.bfloat16)
    with torch.no_grad():
        zs = sample_zs(b, g_m.cfg, g, device=dev)
        wt = rt.flat_weights(g_m.siren, g_m.mapping(zs["z_nerf"], zs["z_inr"]))
        world = g_m.sample_world(b, RenderOptions(img_size=64, num_steps=S), g)
        args = (wt, world.points, world.origins, world.dirs, world.z_vals[..., 0],
                *rt.draw_ray_randoms(b, n, S, True, g, dev),
                torch.full((), 0.5, device=dev))   # the noise as the step passes it
        d_fea = torch.randn((b, n, R), generator=g, device=dev)
        d_dep = torch.randn((b, n, 1), generator=g, device=dev)
        res = rt.ray_tile_cuda(*args, with_residuals=True, out_dtype=torch.bfloat16, **bf16)[2]
        times = {
            "ray_tile_residuals": cuda_ms(
                [lambda: rt.ray_tile_plain(*args, with_residuals=True, out_dtype=torch.bfloat16,
                                           **bf16),
                 lambda: rt.ray_tile_cuda(*args, with_residuals=True, out_dtype=torch.bfloat16,
                                          **bf16)], reps=10),
            "ray_tile_bwd_residual": cuda_ms(
                [lambda: rt.ray_tile_bwd_plain(*args, d_fea, d_dep, residuals=res, **bf16),
                 lambda: rt.ray_tile_bwd_cuda(*args, d_fea, d_dep, residuals=res, **bf16)],
                reps=10),
            "ray_tile_bwd_recompute": cuda_ms(
                [lambda: rt.ray_tile_bwd_plain(*args, d_fea, d_dep, fast_sin=True, **bf16),
                 lambda: rt.ray_tile_bwd_cuda(*args, d_fea, d_dep, fast_sin=True, **bf16)],
                reps=10)}
    bounds = train_bounds("bfloat16")
    for key, name in (("ray_tile_residuals", "2r ray tile with residuals"),
                      ("ray_tile_bwd_residual", "3 backward, residual mode"),
                      ("ray_tile_bwd_recompute", "3 backward, recompute mode (fast_sin)")):
        plain, kern = times[key]
        log(f"phase 15 time: #{name} r64 b=4 S=12 noise 0.5 (a device operand) bf16 products: kernel {kern:.3f} ms, "
            f"plain {plain:.3f} ms, bound {bounds[key][0]:.4f} ms ({bounds[key][1]}) [{smi}]")
    return totals, times


# ---- phase 16: chunked dispatch ----------------------------------------------

CHUNK_PEAK_GIB = 72.0   # phase 16(c): one chunk at train_r256's settings, peak device memory


def chunk_state(kind, dev, start=0):
    """(state, step function, batch shape, label) of one phase-16 case, built
    from seeds: ``shipped`` and ``exact`` the two bench legs (bf16 compute,
    f32 parameters, r64 b = 4, aux on), ``diffcam`` and ``pigan`` the
    variants' train_r64 at full width, ``r256`` train_r256's settings at
    r256 b = 4; the counter at ``start``, the EMA from step 5000."""
    import torch

    from cips3d_tpu_torch.bench import train as bench_train
    from cips3d_tpu_torch.models.discriminator import DiscriminatorMultiScaleAux
    from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR, RenderOptions
    from cips3d_tpu_torch.train.loop import LoopConfig
    from cips3d_tpu_torch.train.state import TrainConfig
    from cips3d_tpu_torch.train.step import init_train_state, make_train_step

    if kind in ("shipped", "exact"):
        kw = (dict(fused_ray=False) if kind == "shipped"
              else dict(fused_ray=True, fused_ray_vjp="pallas_residual"))
        gen, disc, tcfg, opts = bench_train.build(kind == "shipped", device=dev, seed=60, **kw)
        tcfg = dataclasses.replace(tcfg, ema_start_itr=5000)
        state = init_train_state(gen, disc, tcfg)
        fn = make_train_step(gen, disc, tcfg, opts, aux_reg=True)
        label = f"{SHIPPED if kind == 'shipped' else 'exact sine, residual backward'}, bf16"
    elif kind == "r256":
        gen = GeneratorNerfINR(GeneratorConfig(fast_sin=True, fused_ray=False, freeze_nerf=True),
                               generator=torch.Generator().manual_seed(60)).to(dev)
        disc = DiscriminatorMultiScaleAux(max_size=1024, diffaug=True,
                                          generator=torch.Generator().manual_seed(61)).to(dev)
        tcfg = TrainConfig(img_size=256, batch_size=4, ema_start_itr=0, diffaug=True,
                           warmup_d=True, train_aux_img=False, nerf_noise_disable=True,
                           gen_lr=1e-4, disc_lr=5e-4)
        state = init_train_state(gen, disc, tcfg)
        fn = make_train_step(gen, disc, tcfg, RenderOptions(), aux_reg=False)
        label = f"{R256}, r256 b=4"
    else:
        pipe = variant_pipeline(kind, "train_r64", ["ema_start_itr", "5000"])
        tcfg = pipe.train_cfg
        state = pipe.init_state(LoopConfig(device=str(dev), seed=60, fixed_z_bs=4))
        fn = pipe.make_step(state, tcfg.train_aux_img, True)
        label = f"{kind} train_r64 b={tcfg.batch_size}"
    state.step = start
    return state, fn, (tcfg.batch_size, 3, tcfg.img_size, tcfg.img_size), label


# The port's kernels in a profiler trace, each with the wrapper launches it runs for: a
# backward launch (#3) runs the cotangent, weight-grad and reduce kernels, and in recompute
# mode the forward kernel again first.  No symbol is a substring of another.
TRACE_SYMBOLS = {
    "ray_tile_kernel": ("ray_tile", "ray_tile_residuals", "ray_tile_bwd_recompute"),
    "ray_tile_bwd_cot": ("ray_tile_bwd_residual", "ray_tile_bwd_recompute"),
    "ray_tile_bwd_wgrad": ("ray_tile_bwd_residual", "ray_tile_bwd_recompute"),
    "ray_tile_bwd_reduce": ("ray_tile_bwd_residual", "ray_tile_bwd_recompute"),
    "inr_tile_kernel": ("inr_tile",),
}
WITNESS_STEPS = 2   # the last steps of a bench leg's chunk in phase 16(a), replayed under the profiler


def witness_replays(chunk, reals, log, label):
    """Replay ``chunk`` on ``reals`` under `torch.profiler` and hold the port's
    kernels that the trace shows ran on the device against the launches the
    chunk counted for these replays (its capture's record times the
    replays).  Returns the metric rows."""
    from cips3d_tpu_torch.bench import report

    before, rows = kernel_counts(), []
    prof = report.profile_call(lambda: rows.extend(chunk(reals).read()))
    counted = {k: n - before[k] for k, n in kernel_counts().items()}
    want = {sym: sum(counted[k] for k in ks) for sym, ks in TRACE_SYMBOLS.items()}
    traced = {sym: sum(n for key, n in prof["ours"].items() if sym in key)
              for sym in TRACE_SYMBOLS}
    log(f"  {label}: {len(reals)} replays under the profiler: the port's kernels on the device "
        f"{traced}, counted through the replays {want}")
    if traced != want or not any(want.values()):
        raise AssertionError(f"phase 16 {label}: the trace's kernels {traced} are not the "
                             f"launches counted through the replays {want}")
    return rows


def chunk_vs_eager(dev, log, smi, kind, K, start=0, witness=False):
    """K eager steps against one chunk of K replays (`train/chunk.py`), each
    from a fresh state built from the same seeds, the same generator seed
    and the same uint8 batches.  Bit for bit in every state tensor and
    metric, else within phase 7's tolerances (losses rtol, parameters beyond
    STEP_TOL["param"] * lr on at most MAX_OUTSIDE of the elements); the
    chunk's launches (counted through its replays) equal the eager steps'.
    With ``witness`` the chunk's last WITNESS_STEPS replays run under the
    profiler (`witness_replays`) and only the ones before are timed.
    Returns the chunk run's launches by kernel."""
    import numpy as np
    import torch

    from cips3d_tpu_torch.train.chunk import Metrics, make_chunk_fn, state_tensors

    runs = {}
    timed = K - WITNESS_STEPS if witness else K   # the chunk's replays on the host clock
    for mode in ("eager", "chunk"):
        state, fn, shape, label = chunk_state(kind, dev, start)
        reals = [np.random.default_rng(70 + i).integers(0, 256, shape, np.uint8)
                 for i in range(K)]
        rng = torch.Generator(dev).manual_seed(71)
        lrs = [g["lr"] for opt in (state.g_opt, state.d_opt) for g in opt.param_groups]
        torch.cuda.synchronize()
        if mode == "eager":
            zero_kernel_counts()
            t0 = time.perf_counter()
            rows = [Metrics.of_step(fn(state, torch.from_numpy(r).to(dev), rng=rng)[1]).read()[0]
                    for r in reals]
            secs = time.perf_counter() - t0
        else:
            chunk = make_chunk_fn(fn, state, shape, rng, label=label)
            torch.cuda.synchronize()
            zero_kernel_counts()
            t0 = time.perf_counter()
            rows = chunk(reals[:timed]).read()
            secs = time.perf_counter() - t0
            if witness:
                rows += witness_replays(chunk, reals[timed:], log, label)
            chunk.close()
        counts = kernel_counts()
        if state.step != start + K or int(state.step_t) != start + K:
            raise AssertionError(f"phase 16 {label} {mode}: counter at {state.step} / "
                                 f"{int(state.step_t)}, want {start + K}")
        runs[mode] = (rows, [t.detach().float().cpu() for t in state_tensors(state)], counts,
                      secs, lrs)
        del state, fn
        torch.cuda.empty_cache()
    (er, et, ec, es, lrs), (cr, ct, cc, cs, _) = runs["eager"], runs["chunk"]
    exact = er == cr and all(torch.equal(a, b) for a, b in zip(et, ct))
    diff = max((a - b).abs().max().item() for a, b in zip(et, ct))
    lerr = max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-6) for x, y in zip(cr, er)
               for k in ("d_loss", "g_loss"))
    held = "bit for bit" if exact else "phase 7's tolerances"
    log(f"phase 16 chunk: {label}, steps {start}-{start + K - 1}: {K} eager steps vs one chunk "
        f"of {K} replays: {held} (state max abs diff {diff:.3e}, loss rel err {lerr:.2e}); "
        f"host {es:.2f} s eager ({K} steps), {cs:.2f} s chunk ({timed} replays) = "
        f"{shape[0] * K / es:.2f} vs {shape[0] * timed / cs:.2f} images/s; launches {cc} [{smi}]")
    if not exact:
        if lerr > STEP_TOL["loss_rtol"] or any(
                r1["d_finite"] != r2["d_finite"] for r1, r2 in zip(cr, er)):
            raise AssertionError(f"phase 16 {label}: the chunk's losses leave the eager ones")
        far = sum(((a - b).abs() > STEP_TOL["param"] * min(lrs)).sum().item()
                  for a, b in zip(et, ct) if a.numel() > 1)
        if far > MAX_OUTSIDE * sum(a.numel() for a in et):
            raise AssertionError(f"phase 16 {label}: {far} state elements differ by more than "
                                 f"{STEP_TOL['param']} lr")
    if cc != ec:
        raise AssertionError(f"phase 16 {label}: the chunk launched {cc}, the eager steps {ec}")
    if "nerf_noise" in er[0]:
        log(f"  nerf_noise by step: {[r['nerf_noise'] for r in cr]} (chunk), "
            f"{[r['nerf_noise'] for r in er]} (eager); alpha {[r['alpha'] for r in cr]}")
    return cc


def chunk_phase(dev, smi, log, tmp):
    """Phase 16: chunked dispatch on the card.  (a) 10 eager steps against a
    chunk of 10 replays for both bench legs (bf16) and 4 for diffcam and
    pi-GAN, deterministic algorithms on; (b) the shipped leg at steps
    4998-5002 (the density noise to 0, the EMA on at 5000); (c) one chunk at
    train_r256's settings, its peak memory, then the loop's eval render of
    that G_ema after the chunk's graph is released (`eval.images.gen_images`,
    a captured program a batch), its peak; (d) phase 13(a) with chunks of 2
    through a one-rank NCCL group; (e) the shipped bench leg eager and
    chunked, images/s and a profiled chunk's idle share (no threshold).
    Returns the launches of the chunks of (a)-(d) by kernel."""
    import copy

    import numpy as np
    import torch
    import torch.distributed as dist

    from cips3d_tpu_torch.bench import train as bench_train
    from cips3d_tpu_torch.models.generator import RenderOptions
    from cips3d_tpu_torch.parallel.mesh import COLLECTIVES, make_mesh
    from cips3d_tpu_torch.train.chunk import make_chunk_fn
    from cips3d_tpu_torch.train.step import init_train_state, make_train_step

    totals = collections.Counter()
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    t0 = time.perf_counter()
    try:
        for kind, K in (("shipped", 10), ("exact", 10), ("diffcam", 4), ("pigan", 4)):
            totals.update(chunk_vs_eager(dev, log, smi, kind, K,
                                         witness=kind in ("shipped", "exact")))
        log(f"phase 16(a) done in {time.perf_counter() - t0:.1f} s")
        totals.update(chunk_vs_eager(dev, log, smi, "shipped", 5, start=4998))
        log(f"phase 16(b) done in {time.perf_counter() - t0:.1f} s")

        # (c) one chunk at train_r256's settings
        state, fn, shape, label = chunk_state("r256", dev)
        rng = torch.Generator(dev).manual_seed(72)
        reals = [np.random.default_rng(73 + i).integers(0, 256, shape, np.uint8)
                 for i in range(2)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_kernel_counts()
        chunk = make_chunk_fn(fn, state, shape, rng, label=label)
        t1 = time.perf_counter()
        rows = chunk(reals).read()
        secs = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        totals.update(kernel_counts())
        if not all(math.isfinite(v) for r in rows for v in r.values()):
            raise AssertionError(f"phase 16(c): non-finite metrics {rows}")
        log(f"phase 16 chunk: {label}: warm-up, capture and a chunk of 2 replays, peak "
            f"max_memory_allocated {peak:.2f} GiB (bound {CHUNK_PEAK_GIB:g}); the chunk "
            f"{secs * 1e3:.1f} ms on the host clock = {2 * shape[0] / secs:.2f} images/s "
            f"[{smi}]")
        if peak > CHUNK_PEAK_GIB:
            raise AssertionError(f"phase 16(c): peak {peak:.2f} GiB over {CHUNK_PEAK_GIB} GiB")
        # the loop's FID render of this G_ema at train_r256's eval settings (b = 16,
        # forward_points 256^2), as the loop runs it: the chunk's graph released first
        # (beside its pool the eval did not fit on the card), then one captured program a
        # batch shape, released at the end of the call
        from cips3d_tpu_torch.eval.images import gen_images

        chunk.close()
        torch.cuda.reset_peak_memory_stats(dev)
        t1 = time.perf_counter()
        n = gen_images(state.ema, os.path.join(tmp, "eval_r256"), 32, 256, batch_size=16,
                       num_steps=12, opts=RenderOptions(), forward_points=256 ** 2)
        secs = time.perf_counter() - t1
        ev_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        log(f"phase 16 chunk: {label}: the loop's eval render of its G_ema (r256 x12, 2 "
            f"batches of 16, one captured program), after the chunk's graph is released as "
            f"the loop releases it: {n} PNGs in {secs:.1f} s, peak max_memory_allocated "
            f"{ev_peak:.2f} GiB beside the chunk's {peak:.2f} GiB (bound {CHUNK_PEAK_GIB:g} "
            f"each) [{smi}]")
        if n != 32 or ev_peak > CHUNK_PEAK_GIB:
            raise AssertionError(f"phase 16(c): the eval render: {n} images, peak "
                                 f"{ev_peak:.2f} GiB")
        del state, fn, chunk
        torch.cuda.empty_cache()

        # (d) phase 13(a)'s case through a one-rank NCCL group: eager against chunks of 2
        gen0, disc0, tcfg, aux, _, _ = dist_case("r64", dev)
        g = torch.Generator().manual_seed(74)
        reals = [(torch.rand((4, 3, 64, 64), generator=g) * 255).to(torch.uint8).numpy()
                 for _ in range(10)]
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                                world_size=1, rank=0)
        runs = {}
        try:
            mesh = make_mesh(1)
            for name in ("eager", "chunks of 2"):
                gen, disc = copy.deepcopy(gen0), copy.deepcopy(disc0)
                state = init_train_state(gen, disc, tcfg)
                fn = make_train_step(gen, disc, tcfg, RenderOptions(), aux_reg=aux, mesh=mesh)
                rng = torch.Generator(dev).manual_seed(75)
                zero_kernel_counts()
                COLLECTIVES.clear()
                if name == "eager":
                    for r in reals:
                        fn(state, torch.from_numpy(r).to(dev), rng=rng)
                else:
                    chunk = make_chunk_fn(fn, state, reals[0].shape, rng, mesh,
                                          label="the one-rank NCCL step")
                    zero_kernel_counts()
                    COLLECTIVES.clear()
                    for i in range(0, 10, 2):
                        chunk(reals[i:i + 2])
                    chunk.close()
                torch.cuda.synchronize()
                runs[name] = (step_snapshot(state), kernel_counts(), sum(COLLECTIVES.values()))
        finally:
            dist.destroy_process_group()
        diff = max((x - y).abs().max().item() for a, b in zip(runs["eager"][0],
                                                             runs["chunks of 2"][0])
                   for x, y in zip(a, b))
        counts, coll = runs["chunks of 2"][1], runs["chunks of 2"][2]
        log(f"phase 16 nccl: phase 13(a)'s shipped r64 b=4 case, one NCCL rank, 10 steps eager "
            f"vs 5 chunks of 2 (dispatch_chunk 2), the all-reduces captured with the step: G, "
            f"D and EMA max abs diff {diff:.3e}; {coll / 10:g} collectives a step through the "
            f"replays; launches {counts} [{smi}]")
        if diff != 0 or coll != 30 or counts != runs["eager"][1]:
            raise AssertionError("phase 16(d): the chunked NCCL steps differ from the eager ones")
        totals.update(counts)
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
        torch.use_deterministic_algorithms(False)
    log(f"phase 16(d) done in {time.perf_counter() - t0:.1f} s")

    # (e) the shipped bench leg, eager and chunked, in turns
    rep = {}
    for tag, chunked in (("eager", False), ("chunked", True)):
        _, chunk = bench_train.measure(True, n_calls=1, K=10, device=str(dev), report=rep,
                                       tag=tag, chunked=chunked, fused_ray=False)
        if chunk is not None:
            chunk.close()
        torch.cuda.empty_cache()
    for tag, leg in rep.items():
        p = leg["profile"]
        log(f"phase 16 bench: shipped leg r64 b=4 bf16, {tag}: {leg['value']:.2f} images/s over "
            f"1 call of 10 steps (calls {[round(r, 2) for r in leg['rates']]}); a profiled "
            f"{'chunk' if leg['chunked'] else 'run'} of {p['steps']} steps: {p['wall_ms']:.1f} ms "
            f"host clock, device busy {p['busy_ms']:.1f} ms, idle {p['idle_pct']:.1f} %, "
            f"{p['device_events']} device events [{smi}]")
    log(f"phase 16 done in {time.perf_counter() - t0:.1f} s")
    return totals


# ---- phase 17: the render side as captured programs ---------------------------

def frames_agree(got, ref):
    """(bit for bit, phase 4's frame rule holds, the share of pixels
    outside FRAME_ATOL, the largest depth error) for lists of (image,
    depth) pairs."""
    import torch

    exact = all(torch.equal(a, b) for g, r in zip(got, ref) for a, b in zip(g, r))
    share = max((g[0] - r[0]).abs().gt(FRAME_ATOL).any(1).float().mean().item()
                for g, r in zip(got, ref))
    dep = max((g[1] - r[1]).abs().max().item() for g, r in zip(got, ref))
    return exact, share <= MAX_OUTSIDE and dep <= FRAME_ATOL, share, dep


def held_line(exact, rule_ok):
    return "bit for bit" if exact else ("phase 4's frame rule" if rule_ok else "NEITHER")


def idle_of(fn):
    """One call of ``fn`` under the profiler: (host ms, device busy ms,
    idle %)."""
    from cips3d_tpu_torch.bench import report

    p = report.profile_call(fn)
    return p["wall_ms"], p["busy_ms"], p["idle_pct"]


def render_phase(dev, smi, log, tmp, gen):
    """Phase 17: the render side as one program a call (`utils/graphs.py`),
    with deterministic algorithms on.  (a) `RenderService` with two models
    at r128 x 24 and r256 x 12 (one pool): 4 seeds x 3 cameras replayed
    against eager frames, image and depth bit for bit (else phase 4's frame
    rule, and the line says which held), #1 and #2 counted through the
    replays; (b) `bench.inference`'s call of 16 replays against 16 eager
    frames from the same generator seed, the checksum bit for bit; (c) the
    inversion on the exact-sine config with the percept term, 5 captured
    steps against 5 eager ones, every style tensor and loss bit for bit, #2r
    and #3 once a step through the replays; (d) a trajectory frame and the
    n = 64 sigma volume, captured against eager; (e) eager and captured
    times of each with the idle share of a profiled call, the service's
    graphs' memory.  Returns the launches of the replays of (a)-(d)."""
    import numpy as np
    import torch

    from cips3d_tpu_torch.apps import inversion, render, shapes
    from cips3d_tpu_torch.apps.serve import RenderService
    from cips3d_tpu_torch.bench import inference
    from cips3d_tpu_torch.eval.cli import serving_config
    from cips3d_tpu_torch.models.discriminator import DiscriminatorMultiScaleAux
    from cips3d_tpu_torch.models.generator import (GeneratorConfig, GeneratorNerfINR,
                                                   RenderOptions, sample_zs)
    from cips3d_tpu_torch.utils import graphs

    totals = collections.Counter()
    times = {}
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    t0 = time.perf_counter()
    try:
        # ---- (a) serving: two models, r128 x 24 and r256 x 12, one pool
        gen_b = GeneratorNerfINR(serving_config(fast_sin=True),
                                 generator=torch.Generator().manual_seed(80)).to(dev).eval()
        models = {"a": gen, "b": gen_b}
        cache = graphs.ProgramCache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        services = {"r128 x24": RenderService(models, 128, SERVING_STEPS, programs=cache),
                    "r256 x12": RenderService(models, 256, 12, programs=cache)}
        reqs = [(m, seed, yaw) for m in models for seed in (0, 1, 2, 3)
                for yaw in (math.pi / 2 - 0.3, math.pi / 2, math.pi / 2 + 0.25)]
        for svc in services.values():   # the first request of each key captures
            for m in models:
                svc.render(seed=9, model=m)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
        held = (torch.cuda.memory_allocated(dev) - base) / 2 ** 30
        for name, svc in services.items():
            runs = {}
            for dispatch in ("eager", "program"):
                zero_kernel_counts()
                runs[dispatch] = ([svc.render(s, y, model=m, dispatch=dispatch)
                                   for m, s, y in reqs], kernel_counts())
            torch.cuda.synchronize()
            exact, ok, share, dep = frames_agree(runs["program"][0], runs["eager"][0])
            ce, cp = runs["eager"][1], runs["program"][1]
            log(f"phase 17 serve: RenderService {name}, models a and b, {len(reqs)} requests "
                f"(4 seeds x 3 cameras each), replays vs eager: {held_line(exact, ok)} (pixels "
                f"outside {share:.2e}, depth {dep:.3e}); launches through the replays {cp}, "
                f"eager {ce} [{smi}]")
            if not ok or cp != ce or cp["ray_tile"] != len(reqs) or cp["inr_tile"] != len(reqs):
                raise AssertionError(f"phase 17(a) {name}: the replayed frames or launches "
                                     "differ from the eager ones")
            totals.update(cp)
        log(f"phase 17 serve: the service's 4 graphs (2 models x 2 sizes, one pool): peak "
            f"{peak:.2f} GiB over the models while capturing, {held:.2f} GiB held after [{smi}]")
        times["graphs GiB"] = (peak, held)
        log(f"phase 17(a) done in {time.perf_counter() - t0:.1f} s")

        # ---- (b) the render bench: 16 replays vs 16 eager frames, one generator seed
        legs = {}
        for dispatch in ("eager", "program"):
            g_b, _, run = inference.build_renderer(256, 12, 16, True, True, True, device=dev,
                                                   dispatch=dispatch)
            zs = sample_zs(1, g_b.cfg, torch.Generator(dev).manual_seed(0), device=dev)
            with torch.no_grad():
                st = g_b.mapping(zs["z_nerf"], zs["z_inr"])
            run(st, torch.Generator(dev).manual_seed(81))   # warm-up; the program captures
            zero_kernel_counts()
            rng = torch.Generator(dev).manual_seed(82)
            s = run(st, rng)
            legs[dispatch] = (s, kernel_counts(), rng.get_state(), run, st)
        (se, ce, ge, run_e, st), (sp, cp, gp, run_p, _) = legs["eager"], legs["program"]
        log(f"phase 17 bench: bench.inference r256 x12 bf16, one call of 16 frames from "
            f"generator seed 82: checksum replayed {sp!r}, eager {se!r}: "
            f"{'bit for bit' if sp == se else 'DIFFERENT'}; generator left alike "
            f"{torch.equal(ge, gp)}; launches through the replays {cp}, eager {ce} [{smi}]")
        if sp != se or not torch.equal(ge, gp) or cp != ce or min(cp.get(k, 0) for k in (
                "ray_tile", "inr_tile")) != 16:
            raise AssertionError("phase 17(b): the bench's replays differ from its eager frames")
        totals.update(cp)
        bench_runs, bench_styles = {"eager": run_e, "program": run_p}, st
        del legs
        log(f"phase 17(b) done in {time.perf_counter() - t0:.1f} s")

        # ---- (c) inversion, exact sine with the percept term: 5 captured vs 5 eager steps
        exact_cfg = GeneratorConfig(fast_sin=False, fused_ray=True, fused_ray_vjp="pallas_residual")
        inv = GeneratorNerfINR(exact_cfg, generator=torch.Generator().manual_seed(30)).to(dev)
        disc = DiscriminatorMultiScaleAux(max_size=1024,
                                          generator=torch.Generator().manual_seed(31)).to(dev)
        yy, xx = np.mgrid[0:64, 0:64] / 63.0
        target = (np.stack([np.sin(3 * xx), np.cos(2 * yy), xx * yy * 2 - 1]) * 0.8).astype(
            np.float32)
        d_inv = inversion.draw_inversion(inv, 6, 64, 12, avg_samples=2000, seed=0)

        def projector(dispatch):
            return inversion.Projector(inv, target, 6, img_size=64, num_steps=12, log_every=1,
                                       percept_fn=inversion.make_disc_percept_fn(disc),
                                       draws=d_inv, dispatch=dispatch)

        runs = {}
        for dispatch in ("eager", "program"):
            proj = projector(dispatch)
            counts = collections.Counter()
            for i in range(5):
                zero_kernel_counts()
                proj.step()
                if i:   # step 0 of the program also warms up and captures
                    counts.update(kernel_counts())
            styles, img, hist = proj.result()
            runs[dispatch] = ([v.clone() for v in styles.values()], img, hist, counts)
            proj.close()
            del proj
        (se, ie, he, ce), (sp, ip, hp, cp) = runs["eager"], runs["program"]
        exact = he == hp and np.array_equal(ie, ip) and all(
            torch.equal(a, b) for a, b in zip(se, sp))
        log(f"phase 17 inversion: exact sine (#2r + #3 residual), D percept, r64 x12, 5 steps "
            f"captured vs eager: styles, render and losses {'bit for bit' if exact else 'DIFFERENT'} "
            f"(losses {hp}); launches of steps 1-4 through the replays {dict(cp)}, eager "
            f"{dict(ce)} [{smi}]")
        if not exact or cp != ce or cp["ray_tile_residuals"] != 4 or \
                cp["ray_tile_bwd_residual"] != 4 or cp["ray_tile"] or cp["inr_tile"]:
            raise AssertionError("phase 17(c): the captured inversion steps differ from the "
                                 "eager ones, or missed #2r or #3")
        totals.update(cp)
        log(f"phase 17(c) done in {time.perf_counter() - t0:.1f} s")

        # ---- (d) a trajectory frame and the n = 64 sigma volume, captured vs eager
        xyz, lookup, up = render.build_trajectory("translate_rotate", 30)
        zs = sample_zs(1, gen.cfg, torch.Generator(dev).manual_seed(84), device=dev)
        with torch.no_grad():
            st = gen.mapping(zs["z_nerf"], zs["z_inr"])
        o = RenderOptions(img_size=128, num_steps=SERVING_STEPS, h_stddev=0.0, v_stddev=0.0)

        def traj(j, dispatch):
            img, dep = render.render_frame(gen, st, o, j, render.Draws(dev), 256 ** 2,
                                           xyz[j:j + 1], lookup[j:j + 1], up[j:j + 1],
                                           return_depth=True, dispatch=dispatch)
            return render.depth_to_uint8(dep[0, 0].float().cpu().numpy(), o), img, dep

        traj(0, "program")   # captures
        frames = {}
        for dispatch in ("eager", "program"):
            zero_kernel_counts()
            frames[dispatch] = ([traj(j, dispatch)[1:] for j in (3, 17, 23)], kernel_counts())
        exact, ok, share, dep = frames_agree(frames["program"][0], frames["eager"][0])
        log(f"phase 17 trajectory: translate_rotate frames 3, 17, 23 r128 x{SERVING_STEPS} "
            f"(rolled up vector), replays vs eager: {held_line(exact, ok)} (pixels outside "
            f"{share:.2e}, depth {dep:.3e}); launches {frames['program'][1]} [{smi}]")
        if not ok or frames["program"][1] != frames["eager"][1]:
            raise AssertionError("phase 17(d): the replayed trajectory frames differ")
        totals.update(frames["program"][1])
        vols = {d: shapes.sample_sigma_volume(gen, n=64, styles=st, dispatch=d)
                for d in ("eager", "program")}
        err = np.abs(vols["program"] - vols["eager"]).max() / (np.abs(vols["eager"]).max() + 1)
        same = np.array_equal(vols["program"], vols["eager"])
        log(f"phase 17 shapes: sigma volume n=64, 4 replays of one captured 65536-point chunk vs "
            f"eager: {'bit for bit' if same else f'max|a-b|/(max|b|+1) {err:.2e}'} [{smi}]")
        if not same and err > 1e-4:
            raise AssertionError("phase 17(d): the captured sigma volume differs")
        log(f"phase 17(d) done in {time.perf_counter() - t0:.1f} s")
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
        torch.use_deterministic_algorithms(False)

    # ---- (e) times, eager vs captured, each with a profiled call's idle share (deterministic
    # algorithms off again, as the apps and the benches run)
    for dispatch, run in bench_runs.items():
        rates = []
        for i in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            run(bench_styles, torch.Generator(dev).manual_seed(83 + i))
            rates.append(16 / (time.perf_counter() - t1))
        times["bench", dispatch] = (rates, idle_of(
            lambda: run(bench_styles, torch.Generator(dev).manual_seed(90))))
    for dispatch in ("eager", "program"):
        proj = projector(dispatch)
        proj.step()   # the program's warm-up and capture
        step_ms = timed(proj.step, 4)
        times["inversion", dispatch] = (step_ms, idle_of(proj.step))   # step 5
        proj.close()
    del bench_runs, proj, inv, disc
    torch.cuda.empty_cache()
    for name, svc in services.items():
        for dispatch in ("eager", "program"):
            svc.frame(seed=9, dispatch=dispatch)
            ts = []
            for i in range(21):
                t1 = time.perf_counter()
                svc.frame(seed=9, yaw=math.pi / 2 + 0.01 * i, dispatch=dispatch)
                ts.append((time.perf_counter() - t1) * 1e3)
            times["frame " + name, dispatch] = (ts, idle_of(
                lambda: svc.frame(seed=9, dispatch=dispatch)))
    for dispatch in ("eager", "program"):
        times["trajectory r128", dispatch] = (timed(lambda: traj(5, dispatch), 21),
                                             idle_of(lambda: traj(6, dispatch)))
        shapes.sample_sigma_volume(gen, n=128, styles=st, dispatch=dispatch)
        times["sigma n=128", dispatch] = (
            timed(lambda: shapes.sample_sigma_volume(gen, n=128, styles=st, dispatch=dispatch),
                  3),
            idle_of(lambda: shapes.sample_sigma_volume(gen, n=128, styles=st,
                                                       dispatch=dispatch)))
    for key in ("frame r128 x24", "frame r256 x12", "trajectory r128", "inversion",
                "sigma n=128", "bench"):
        parts = []
        for dispatch in ("eager", "program"):
            vals, prof = times[key, dispatch]   # ms, or frames/s for the bench
            stat = (f"{statistics.median(vals):.2f} frames/s (calls "
                    f"{', '.join(f'{v:.2f}' for v in vals)})" if key == "bench"
                    else f"median {statistics.median(vals):.2f} ms (min {min(vals):.2f}, max "
                         f"{max(vals):.2f}, {len(vals)} calls)")
            idle = (f"; profiled call {prof[0]:.1f} ms host, device busy {prof[1]:.1f} ms, idle "
                    f"{prof[2]:.1f} %")
            parts.append(f"{'captured' if dispatch == 'program' else 'eager'} {stat}{idle}")
        log(f"phase 17 time: {key}: " + " | ".join(parts) + f" [{smi}]")
    peak, held = times["graphs GiB"]
    log(f"phase 17 time: the service's graphs: {held:.2f} GiB held, capture peak {peak:.2f} "
        f"GiB [{smi}]")
    for svc in services.values():
        svc.close()
    graphs.release()
    torch.cuda.empty_cache()
    log(f"phase 17 done in {time.perf_counter() - t0:.1f} s")
    return totals


# ---- phase 18: the last slice ---------------------------------------------------

# phase 18(a, e): configs/finetune.yaml's finetune_afhq, 5 steps (step 0 alone, then chunks
# of 2: steps 3-4 are replays only) with evals after steps 1 and 5 of 16 + 16 images (the
# recipe's 2048 + 2048 cut for time; its eval_batch_size 16 and fixed_z_bs 16 kept)
FINETUNE_OPTS = ("total_iters", "5", "eval_every", "5", "log_every", "1", "dispatch_chunk", "2",
                 "num_images_real_eval", "16", "num_images_gen_eval", "16", "num_workers", "2")
FID_TOL = dict(rtol=1e-4, atol=1e-5)   # phase 18(d): card features vs the CPU's, TF32 off


def finetune_run(argv):
    """One run of the training CLI (`cips3d_tpu_torch.train.cli.main` on
    ``argv``) in a subprocess of phase 18(a, e); then a line with the
    kernels' launches (through the chunks' replays), the peak device
    memory, the chunk's captures and releases and the monitors in the
    order they came, and each eval's monitors' seconds."""
    import torch

    import cips3d_tpu_torch.train.chunk as chunk_mod
    import cips3d_tpu_torch.train.loop as loop_mod
    from cips3d_tpu_torch.train import cli

    events, mon_secs = [], []
    capture, close, monitors = (chunk_mod.GraphChunk.capture, chunk_mod.GraphChunk.close,
                                loop_mod.save_monitor_images)

    def spy_capture(self):
        events.append("capture")
        return capture(self)

    def spy_close(self):
        if self.graph is not None:
            events.append("release")
        return close(self)

    def spy_monitors(*a, **kw):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        monitors(*a, **kw)
        torch.cuda.synchronize()
        mon_secs.append(time.perf_counter() - t1)
        events.append("monitors")

    chunk_mod.GraphChunk.capture, chunk_mod.GraphChunk.close = spy_capture, spy_close
    loop_mod.save_monitor_images = spy_monitors
    rc = cli.main(argv)
    torch.cuda.synchronize()
    print("finetune run: " + json.dumps({"launches": kernel_counts(),
                                         "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                                         "events": events, "monitor_secs": mon_secs}),
          flush=True)
    return rc


def variant_evals():
    """``python3 chip_smoke.py --variant-evals``: diffcam's and pi-GAN's eval
    fakes as configs/{diffcam,pigan}.yaml write them (train_r64 at full
    width, 2048 fakes in batches of 16 as PNGs, `variant_loop._dump_fakes`),
    each batch rendered eagerly, as the pipelines do, or as one captured
    program a batch shape (`graphs.program_for`, the renders drawn inside
    from the batch's generator), in turns: eager, program, program, eager.
    One line a run on the host clock, one a variant with the sums, and
    whether the program's PNGs equal the eager ones byte for byte.  The
    measurement behind the pipelines' eager eval renders."""
    import shutil
    import tempfile

    import torch

    from cips3d_tpu_torch.models.generator import sample_zs
    from cips3d_tpu_torch.train.loop import LoopConfig
    from cips3d_tpu_torch.train.variant_loop import _dump_fakes
    from cips3d_tpu_torch.utils import graphs

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA GPU")
    dev, smi = torch.device("cuda"), nvidia_smi()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_evals_")

    def files(d):
        return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}

    try:
        for name in ("diffcam", "pigan"):
            pipe = variant_pipeline(name, "train_r64")
            state = pipe.init_state(LoopConfig(device=str(dev), seed=110))
            if name == "diffcam":
                def draw(m, b, g):
                    zs = sample_zs(b, pipe.gen_cfg, g, device=dev)
                    return pipe.render(m, state.camera, zs, g)
            else:
                opts = pipe.eval_opts()

                def draw(m, b, g):
                    return m(torch.randn((b, m.z_dim), generator=g, device=dev), opts, g)[0]
            secs, kept = collections.defaultdict(list), {}
            for i, d in enumerate(("eager", "program", "program", "eager")):
                out = os.path.join(tmp, f"{name}_{i}")
                cache = graphs.ProgramCache()

                def render(b, g):
                    if d == "eager":
                        return draw(state.ema, b, g)
                    return graphs.program_for(state.ema, (name, b), None,
                                              lambda m, _, gg: draw(m, b, gg),
                                              f"{name} eval render b={b}", uses_generator=True,
                                              programs=cache)(None, g)

                torch.cuda.synchronize()
                t1 = time.perf_counter()
                try:
                    _dump_fakes(render, out, 2048, 16, dev)
                    torch.cuda.synchronize()
                finally:
                    cache.close()
                secs[d].append(time.perf_counter() - t1)
                log(f"variant eval: {name} train_r64, {len(os.listdir(out))} fakes (128 batches "
                    f"of 16), {d}: {secs[d][-1]:.2f} s [{smi}]")
                if d in kept:
                    shutil.rmtree(out)
                else:
                    kept[d] = out
            same = files(kept["eager"]) == files(kept["program"])
            log(f"variant eval: {name}: eager {sum(secs['eager']):.2f} s over 2 runs, program "
                f"{sum(secs['program']):.2f} s over 2 runs; the program's PNGs "
                f"{'equal' if same else 'DIFFER FROM'} the eager ones [{smi}]")
            if not same:
                raise AssertionError(f"{name}: the program's fakes differ from the eager ones")
            for out in kept.values():
                shutil.rmtree(out)
            del pipe, state
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


def nerf_leaves(tree, prefix=""):
    import numpy as np

    for k, v in tree.items():
        if isinstance(v, dict):
            yield from nerf_leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def finetune_phase(tmp, log, smi):
    """Phase 18(a, e): a seeded full-width G, G_ema and D of
    configs/finetune.yaml written as a snapshot by the port, a 64-image r256
    zip, and `finetune_run` on them in a subprocess, alone on the card;
    then its exit, load line, launches, step time and peak memory, and G's
    NeRF (siren, NeRF mapping, aux head) against the source G_ema's.  The
    recipe trains at train_r256's settings (r256, b = 4, freeze-NeRF, aux
    off, evals of b = 16 and monitors of 16 fixed latents) but for the D
    warm-up, so the run is also (a): the chunk released before each eval
    and captured again after it, the eval with its monitors (op by op,
    timed) at most CHUNK_PEAK_GIB."""
    import numpy as np
    import torch

    from cips3d_tpu_torch.config.config import resolve_command
    from cips3d_tpu_torch.data.synthetic import make_blob_dataset
    from cips3d_tpu_torch.models.discriminator import DiscriminatorMultiScaleAux
    from cips3d_tpu_torch.models.generator import GeneratorNerfINR
    from cips3d_tpu_torch.train import cli
    from cips3d_tpu_torch.utils import convert
    from cips3d_tpu_torch.utils.checkpoint import CheckpointManager

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = resolve_command(os.path.join(root, "configs", "finetune.yaml"), "finetune_afhq")
    gen_cfg = cli.config_to_dataclasses(cfg)[0]
    trees = {k: convert.jax_tree_from_state_dict(GeneratorNerfINR(
        gen_cfg, generator=torch.Generator().manual_seed(seed)).state_dict())
        for k, seed in (("generator", 140), ("G_ema", 141))}
    trees["discriminator"] = convert.jax_d_tree_from_state_dict(DiscriminatorMultiScaleAux(
        **cfg.discriminator.to_dict(), generator=torch.Generator().manual_seed(142)).state_dict())
    snap = CheckpointManager(os.path.join(tmp, "ft_src", "ckptdir"))
    snap.save_snapshot("best_fid", trees)
    snap_dir = os.path.join(snap.ckpt_dir, "best_fid")
    data = make_blob_dataset(os.path.join(tmp, "afhq_256.zip"), 64, img_size=256, seed=143)
    out = os.path.join(tmp, "ft18")
    os.makedirs(out)
    t1 = time.perf_counter()
    with open(os.path.join(out, "stdout.txt"), "w") as fo, \
            open(os.path.join(out, "stderr.txt"), "w") as fe:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--finetune-run",
                             "--config", "configs/finetune.yaml", "--command", "finetune_afhq",
                             "--opts", "data_path", data, "finetune_dir", snap_dir, "outdir",
                             out, *FINETUNE_OPTS], cwd=root, stdout=fo, stderr=fe,
                            timeout=600).returncode
    secs = time.perf_counter() - t1
    stdout = open(os.path.join(out, "stdout.txt")).read()
    if rc != 0:
        log(stdout[-3000:] + open(os.path.join(out, "stderr.txt")).read()[-3000:])
        raise AssertionError(f"phase 18(e): the finetune CLI exited {rc}")
    run = json.loads(next(ln for ln in stdout.splitlines()
                          if ln.startswith("finetune run: "))[len("finetune run: "):])
    rate = [float(m.group(1)) for m in re.finditer(r"^step 4: .* ([0-9.]+) img/s$", stdout,
                                                   re.M)]
    got = CheckpointManager(os.path.join(out, "finetune_afhq", "ckptdir")).load_snapshot(
        "resume", ("generator",))["generator"]["params"]
    nerf = ("siren", "mapping_network_nerf", "aux_to_rgb")
    src = {mod: dict(nerf_leaves(trees["G_ema"]["params"][mod])) for mod in nerf}
    now = {mod: dict(nerf_leaves(got[mod])) for mod in nerf}
    frozen = all(now[m] and now[m].keys() == src[m].keys()
                 and all(np.array_equal(v, src[m][k]) for k, v in now[m].items()) for m in nerf)
    src_inr = dict(nerf_leaves(trees["generator"]["params"]["inr_net"]))
    moved = sum(not np.array_equal(v, src_inr[k]) for k, v in nerf_leaves(got["inr_net"]))
    loaded = f"loading finetune weights from {snap_dir}" in stdout
    step_ms = 4 / rate[0] * 1e3 if rate else float("nan")
    resume = os.path.join(out, "finetune_afhq", "ckptdir", "resume")
    log(f"phase 18 loop: finetune_afhq at train_r256's settings, an eval after steps 1 and 5 "
        f"(16 + 16 images, FID_surrogate on the card, snapshots, the monitors of 16 latents op "
        f"by op): events {run['events']}; the monitors (5 grids, 10 renders of b=8) "
        f"{', '.join(f'{x:.2f}' for x in run['monitor_secs'])} s an eval; peak "
        f"max_memory_allocated {run['peak_gib']:.2f} GiB (bound {CHUNK_PEAK_GIB:g}) [{smi}]")
    if (run["events"] != ["capture", "release", "monitors", "capture", "release", "monitors"]
            or not os.path.exists(os.path.join(resume, "0G_flip_ema.jpg"))):
        raise AssertionError(f"phase 18(a): the loop's chunk and eval with monitors: events "
                             f"{run['events']}")
    log(f"phase 18 finetune: finetune_afhq (freeze-NeRF, no D warm-up, aux off, load_nerf_ema, "
        f"r256 b=4) through the training CLI at full width, alone on the card, 5 steps on a "
        f"64-image r256 zip from a seeded snapshot the port wrote: exit {rc} in {secs:.1f} s; "
        f"the snapshot loaded {loaded}; G's NeRF ({sum(map(len, now.values()))} tensors) equals "
        f"the source G_ema's {frozen}; INR tensors moved {moved} of {len(src_inr)}; launches "
        f"{run['launches']}; step 4 (a replay of a chunk of 2) {step_ms:.1f} ms "
        f"({rate[0] if rate else float('nan'):.2f} images/s); peak max_memory_allocated "
        f"{run['peak_gib']:.2f} GiB [{smi}]")
    if not (loaded and frozen and moved and run["launches"]["inr_tile"] > 0 and rate
            and run["peak_gib"] <= CHUNK_PEAK_GIB):
        raise AssertionError("phase 18(e): the finetune did not load, freeze, move or launch "
                             "as it should")


def last_slice_phase(dev, smi, log, tmp, gen):
    """Phase 18: what the port finished last, one part after another, none
    beside another process on the card.  (c) `render_sharded` of the
    serving generator at r128 x 24 through a one-rank NCCL group, with
    deterministic algorithms on, 3 replays against 3 eager calls, bit for
    bit, #1, #2 and one all-gather a call counted through the replays; (d)
    the surrogate FID of 2048 + 2048 r64 images: the G_ema's fakes written
    once, both directories' features with the CPU extractor and with the
    card's (real: CPU first, fake: card first), the card's features against
    the CPU's at FID_TOL and the FIDs within 1e-4 relative, an eval's time
    with each extractor; (a, e) configs/finetune.yaml's finetune_afhq
    through the training CLI in a subprocess at full width
    (`finetune_phase`): the loop at train_r256's settings, its chunk
    released and captured again around an eval with its monitors, the peak
    at most CHUNK_PEAK_GIB, and the frozen NeRF.  The variants' evals,
    eager against captured at their configs' size, are ``--variant-evals``
    (`variant_evals`), not part of this run.  Returns the launches counted
    in (c)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from cips3d_tpu_torch.apps import render
    from cips3d_tpu_torch.eval import fid
    from cips3d_tpu_torch.eval.images import gen_images
    from cips3d_tpu_torch.models.generator import (GeneratorConfig, GeneratorNerfINR,
                                                   RenderOptions, sample_zs)
    from cips3d_tpu_torch.parallel.mesh import COLLECTIVES, make_mesh
    from cips3d_tpu_torch.utils import graphs, image_io

    totals = collections.Counter()
    t0 = time.perf_counter()
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        # ---- (c) render_sharded through a one-rank NCCL group, captured vs eager
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                                world_size=1, rank=0)
        cache = graphs.ProgramCache()
        try:
            mesh = make_mesh(1)
            zs = sample_zs(1, gen.cfg, torch.Generator(dev).manual_seed(120), device=dev)
            with torch.no_grad():
                st = gen.mapping(zs["z_nerf"], zs["z_inr"])
            o = RenderOptions(img_size=128, num_steps=SERVING_STEPS, h_stddev=0.0, v_stddev=0.0)
            draws = render.Draws(dev)
            render.render_sharded(gen, st, o, 0, draws, mesh, return_depth=True,
                                  programs=cache)   # warm-up and capture
            runs = {}
            for d in ("eager", "program"):
                zero_kernel_counts()
                COLLECTIVES.clear()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                outs = [render.render_sharded(gen, st, o, key, draws, mesh, return_depth=True,
                                              dispatch=d, programs=cache) for key in (1, 2, 3)]
                torch.cuda.synchronize()
                runs[d] = (outs, kernel_counts(), dict(COLLECTIVES),
                           (time.perf_counter() - t1) / 3 * 1e3)
        finally:
            cache.close()
            dist.destroy_process_group()
        (oe, ce, le, te), (op, cp, lp, tp) = runs["eager"], runs["program"]
        exact = all(torch.equal(a, b) for x, y in zip(oe, op) for a, b in zip(x, y))
        log(f"phase 18 render_sharded: serving generator r128 x{SERVING_STEPS}, one NCCL rank, "
            f"keys 1-3, replays vs eager: {'bit for bit' if exact else 'DIFFERENT'}; launches "
            f"through the replays {cp}, collectives {lp}; eager {ce}, {le}; {tp:.2f} ms a "
            f"replayed call, {te:.2f} ms eager [{smi}]")
        if (not exact or cp != ce or lp != le or cp["ray_tile"] != 3 or cp["inr_tile"] != 3
                or lp.get("all_gather") != 3):
            raise AssertionError("phase 18(c): render_sharded's replays differ from its eager "
                                 "calls or miss #1, #2 or the all-gather")
        totals.update(cp)
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
        torch.use_deterministic_algorithms(False)
    log(f"phase 18(c) done in {time.perf_counter() - t0:.1f} s")

    # ---- (d) the surrogate FID: an eval of 2048 + 2048 r64 images, CPU vs card extractor
    rng = np.random.default_rng(130)
    real_dir, fake_dir = os.path.join(tmp, "fid18", "real"), os.path.join(tmp, "fid18", "fake")
    os.makedirs(real_dir)
    low = rng.integers(0, 256, (2048, 8, 8, 3)).astype(np.float32)
    reals = np.clip(np.repeat(np.repeat(low, 8, 1), 8, 2)
                    + rng.normal(0, 12, (2048, 64, 64, 3)), 0, 255).astype(np.uint8)
    for i, img in enumerate(reals):
        image_io.write_png(os.path.join(real_dir, f"real_{i:06d}.png"), img)
    g64 = GeneratorNerfINR(GeneratorConfig(fast_sin=True),
                           generator=torch.Generator().manual_seed(131)).to(dev).eval()
    ex = {"cpu": fid.surrogate_extractor(device="cpu"), "card": fid.surrogate_extractor(device=dev)}
    for e in ex.values():   # built and called once before the timed eval, as after a loop's first
        e(reals[:16])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    n = gen_images(g64, fake_dir, 2048, 64, batch_size=16)
    t_gen = time.perf_counter() - t1
    feats = {k: {} for k in ex}
    t_feat, t_fid, value = collections.Counter(), {}, {}
    for d, order in ((real_dir, ("cpu", "card")), (fake_dir, ("card", "cpu"))):
        for name in order:
            t1 = time.perf_counter()
            feats[name][d] = fid.extract_dir_features(d, ex[name])
            t_feat[name] += time.perf_counter() - t1
    for name in ex:
        t1 = time.perf_counter()
        value[name] = fid.frechet_distance(*fid.activation_statistics(feats[name][real_dir]),
                                           *fid.activation_statistics(feats[name][fake_dir]))
        t_fid[name] = time.perf_counter() - t1
    pairs = [(feats["card"][d], feats["cpu"][d]) for d in (real_dir, fake_dir)]
    bad = [np.abs(x - y).max() for x, y in pairs]
    outside = sum(int((np.abs(x - y) > FID_TOL["atol"] + FID_TOL["rtol"] * np.abs(y)).sum())
                  for x, y in pairs)
    rel = abs(value["card"] - value["cpu"]) / abs(value["cpu"])
    log(f"phase 18 fid: FID_surrogate of 2048 + 2048 r64 images: card {value['card']:.6f}, "
        f"CPU {value['cpu']:.6f} (relative {rel:.2e}, bound 1e-4); card features vs CPU: max "
        f"abs error real {bad[0]:.3e}, fake {bad[1]:.3e}, {outside} elements outside rtol "
        f"{FID_TOL['rtol']:g} / atol {FID_TOL['atol']:g} (TF32 off) [{smi}]")
    for name in ex:
        log(f"phase 18 fid time: an eval of 2048 + 2048 r64 images with the {name} extractor: "
            f"{t_gen + t_feat[name] + t_fid[name]:.2f} s ({n} fakes written in {t_gen:.2f} s, "
            f"once for both; features of both directories {t_feat[name]:.2f} s; the FID "
            f"{t_fid[name]:.2f} s) [{smi}]")
    if outside or rel > 1e-4 or not all(np.isfinite(v) for v in value.values()):
        raise AssertionError("phase 18(d): the card's surrogate features or FID differ from "
                             "the CPU's")
    del g64
    torch.cuda.empty_cache()
    log(f"phase 18(d) done in {time.perf_counter() - t0:.1f} s")

    # ---- (a, e) finetune_afhq through the training CLI at full width, alone on the card
    finetune_phase(tmp, log, smi)
    log(f"phase 18(a, e) done in {time.perf_counter() - t0:.1f} s")
    log(f"phase 18 done in {time.perf_counter() - t0:.1f} s")
    return totals


# ---- phase 19: the render path past 32 samples a ray ----------------------------

def host_draws():
    """The apps' `Draws` with every draw made on the host from its seed or
    key, then moved to the device: the same numbers on the card and the
    CPU (phases 19 and 20)."""
    import torch

    from cips3d_tpu_torch.apps import render as p_render
    from cips3d_tpu_torch.models.generator import sample_zs
    from cips3d_tpu_torch.ops import ray_tile

    class HostDraws(p_render.Draws):
        def zs(self, seed, n, cfg):
            zs = sample_zs(n, cfg, torch.Generator().manual_seed(int(seed)))
            return {k: v.to(self.device) for k, v in zs.items()}

        def render(self, key, b, opts, chunk):
            g = torch.Generator().manual_seed(int(key))
            n, S = opts.img_size ** 2, opts.num_steps
            uniform = torch.rand((b, n, S, 1), generator=g).to(self.device)
            draws = [ray_tile.RayDraws(*(t.to(self.device) for t in
                                         ray_tile.draw_ray_randoms(b, chunk, S, False, g, "cpu")))
                     for _ in range(n // chunk)]
            return dict(perturb_uniform=uniform, chunk_draws=draws)

    return HostDraws


def long_ray_phase(dev, smi, log, tmp, gen, cpu_gen):
    """Phase 19: the entry points past 32 samples a ray, where each lane of
    #2's warps holds several samples: (a) `RenderService` at r128 x 48
    (`apps/serve.py --num-steps 48`), frames from a zeroed count, #1 and #2
    launched, and the same generator's r128 x 48 frame on the card against
    the CPU by phase 4's rule; (b) ``eval.cli multiview --serving
    --num-steps 24`` (S = 48, multiview doubles the count) in process on
    phase 9's r64 snapshot, its launches counted, and its render (the CLI's
    generator and arguments, draws made on the host) on the card against
    the CPU by the same rule.  Returns the launches of (a) and (b)."""
    import os

    import numpy as np
    import torch

    from cips3d_tpu_torch.apps import render as p_render
    from cips3d_tpu_torch.apps.serve import RenderService
    from cips3d_tpu_torch.eval import cli
    from cips3d_tpu_torch.ops import build
    from cips3d_tpu_torch.utils import graphs, image_io

    t0 = time.perf_counter()
    counts = collections.Counter()
    service = RenderService(gen, img_size=128, num_steps=LONG_STEPS)
    zero_kernel_counts()
    frames = [service.frame(seed=0), service.frame(seed=1, yaw=math.pi / 2 + 0.3),
              service.frame(seed=1, depth=True)]
    torch.cuda.synchronize()
    got = {k: build.launches(k) for k in ("ray_tile", "inr_tile")}
    service.close()
    if any(f.shape != (128, 128, 3) or f.dtype != np.uint8 for f in frames) or min(got.values()) <= 0:
        raise AssertionError(f"RenderService r128 x{LONG_STEPS}: {[f.shape for f in frames]}, "
                             f"launches {got}")
    counts.update(got)
    log(f"phase 19 serve: RenderService r128 x{LONG_STEPS}, {len(frames)} frames, launches {got}")
    frame_vs_cpu(gen, cpu_gen, dev, f"  frame r128 x{LONG_STEPS} vs plain CPU path", size=128,
                 steps=LONG_STEPS)

    HostDraws = host_draws()
    root = os.path.dirname(os.path.abspath(__file__))
    ckpt = f"{tmp}/train_r64/ckptdir/best_fid"
    config = os.path.join(root, "configs/ffhq.yaml")
    out = os.path.join(tmp, "long_multiview.png")
    zero_kernel_counts()
    rc = cli.main(["multiview", "--ckpt", ckpt, "--config", config, "--command", "train_r64",
                   "--serving", "--num-steps", "24", "--seeds", "0", "--img-size", "64", "--out",
                   out])
    torch.cuda.synchronize()
    got = {k: build.launches(k) for k in ("ray_tile", "inr_tile")}
    shape = image_io.read_png(out).shape
    if rc != 0 or shape != (64, 320, 3) or min(got.values()) <= 0:
        raise AssertionError(f"eval.cli multiview --num-steps 24: exit {rc}, grid {shape}, "
                             f"launches {got}")
    counts.update(got)
    log(f"phase 19 cli: eval.cli multiview --serving --num-steps 24 (S = 48) --seeds 0 "
        f"--img-size 64: grid {shape}, launches {got}")
    gen_cfg = cli.serving_config(cli.generator_config(config, "train_r64"))
    mv = cli.load_generator(ckpt, gen_cfg, "G_ema", device=dev)
    mv_cpu = copy.deepcopy(mv).cpu()
    with torch.no_grad():   # the grid's last view (yaw offset 0.5)
        grid = p_render.render_multiview(mv, None, seeds=[0], yaw_offsets=(0.5,), img_size=64,
                                         num_steps=24, draws=HostDraws(dev))
        ref = p_render.render_multiview(mv_cpu, None, seeds=[0], yaw_offsets=(0.5,),
                                        img_size=64, num_steps=24, draws=HostDraws("cpu"))
    err = np.abs(grid - ref)
    share = (err > FRAME_ATOL).any(1).mean()
    log(f"  multiview view r64 x48 vs plain CPU path: max_abs_err {err.max():.3e}; pixels "
        f"outside atol {FRAME_ATOL}: {share:.2e}")
    if not np.isfinite(grid).all() or share > MAX_OUTSIDE:
        raise AssertionError("multiview at S = 48: the kernel path disagrees with the plain path")
    del mv, mv_cpu
    graphs.release()
    log(f"phase 19 done in {time.perf_counter() - t0:.1f} s [{smi}]")
    return counts


# ---- phase 20: every shape the Pallas kernels take: the streamed path ---------------

# the kernels each streamed entry launches (mangled-name patterns of its f32 build): #2r with
# the exact sine runs its FiLM layers as kFilmA products (mode 6) with film_sine after them and
# the head as the colour product, its sine and a kLinear (mode 1) rgb product; #3 runs each
# d-input product (mode 2) with film_bwd after it, the d pts product (mode 3), the weight
# grads' one launch and the final sums
STREAMED_PARTS = {
    "ray_tile_streamed": [r"gemm_kernelIffLb0ELi\d+ELi0E", r"head_kernelIfLb[01]E",
                          r"sigma_rowsIfE", r"coarse_pointsIfE", r"rays_resampleIfE",
                          r"rays_compositeE"],
    "ray_tile_bwd_residual_streamed": [r"coarse_pointsIfE", r"sigma_rowsIfE",
                                       r"gemm_kernelIffLb0ELi\d+ELi1E", r"rays_backwardIfE",
                                       r"bwd_prepIfE", r"gemm_kernelIffLb1ELi\d+ELi2E",
                                       r"film_backwardIfLb[01]E", r"gemm_kernelIffLb1ELi\d+ELi3E",
                                       r"wgrad_kernelIfLi\d+EE", r"(?<=\d)col_sumsE",
                                       r"(?<=\d)bwd_gatherE"],
    "inr_tile_streamed": [r"gemm_kernelIffLb0ELi128ELi4E", r"presplit_wIfLi128E", r"rgb_out"],
}
STREAMED_PARTS["ray_tile_residuals_streamed"] = STREAMED_PARTS["ray_tile_streamed"] + [
    r"gemm_kernelIffLb0ELi\d+ELi6E", r"film_sineIfE", r"gemm_kernelIffLb0ELi\d+ELi1E"]
STREAMED_PARTS["ray_tile_bwd_recompute_streamed"] = (STREAMED_PARTS["ray_tile_residuals_streamed"]
                                                     + STREAMED_PARTS["ray_tile_bwd_residual_streamed"])
L3 = (128, 3, 64, 32)        # H, L, C, R of the flagship at nerf_hidden_layers 3
WIDE_STEPS = 12              # the wide generator's frame: r64 x 12


def streamed_resources(name, ptxas, lib):
    """{kernel: [registers, spill store bytes, spill load bytes]} of every
    instantiation of each kernel a streamed entry launches (f32 build: each
    tile width, each sine) and the largest dynamic shared memory among them
    (the same at every shape); fails if a kernel has no ptxas report."""
    regs = {}
    for pat in STREAMED_PARTS[name]:
        found = {m.group(0): list(v) for k, v in ptxas.items() for m in [re.search(pat, k)] if m}
        if not found:
            raise AssertionError(f"phase 20: no ptxas report matches {pat} ({name})")
        regs.update(found)
    smem = (lib.cips_inr_tile_streamed_smem(0) if name == "inr_tile_streamed"
            else lib.cips_ray_tile_streamed_smem(0))
    return {"ptxas": regs, "smem_bytes": smem,
            "max_registers": max((v[0] or 0) for v in regs.values()),
            "spill_bytes": max(v[1] + v[2] for v in regs.values())}


def streamed_phase(dev, smi, log, tmp, gen, cpu_gen, lib_path):
    """Phase 20: the streamed path (`csrc/ray_tile_streamed.cu`,
    `csrc/inr_tile_streamed.cu`), which takes the shapes the resident
    kernels do not.  (a) Each streamed kernel against its plain version at
    the new shapes (f32 at the kernel rows' tolerances, bf16 with its
    control), twice bit for bit, timed beside the plain version and beside
    the resident kernel at a shape both take: #2 at nerf_hidden_layers 3,
    r128 x 24; #2r and #3 (both modes) at depth 3, r64, b = 4, S = 12; #1 at
    D = 1024, r64.  (b) The main paths on it, from zeroed counts, against
    the CPU: the depth-3 flagship served by `RenderService` (r128 x 24, #2
    streamed, #1 resident; replays against eager calls, bit for bit), one
    r32 b = 2 training step at depth 3 with the exact sine (#2r and #3
    residual, streamed) and one with the polynomial sine (#3 recompute), by
    phase 7's tolerances; ``eval.cli multiview --serving --num-steps 48`` (S
    = 96) on phase 9's r64 snapshot and its view against the CPU; a wide
    generator (nerf_hidden_dim 256, the colour layer as wide, inr_hidden_dim
    1024: #2 and #1 streamed) at r64 x 12 against the CPU.  Between them,
    `tools/stream_split.py`'s split of one call each of #2 (depth 3, r128 x
    24) and #1 (D = 1024, r64), launch by launch: stage, device time, FLOPs,
    bytes and rates, grid, registers, shared memory.  Returns the launches
    of (b) and the kernel entries of the summary line."""
    import numpy as np
    import torch

    from cips3d_tpu_torch.apps import render as p_render
    from cips3d_tpu_torch.apps.serve import RenderService
    from cips3d_tpu_torch.eval import cli
    from cips3d_tpu_torch.eval.cli import serving_config
    from cips3d_tpu_torch.models.generator import (GeneratorConfig, GeneratorNerfINR,
                                                   RenderOptions, sample_zs)
    from cips3d_tpu_torch.models.nerf_net import NeRFNetwork
    from cips3d_tpu_torch.ops import build, inr_tile, ray_tile
    from cips3d_tpu_torch.utils import image_io

    t0 = time.perf_counter()
    f32, bf16 = torch.float32, torch.bfloat16
    lib = build.library()
    optin = build.smem_optin(dev)
    for S, L, H, C, R in ((24, 2, 128, 64, 32), (24, 3, 128, 64, 32), (96, 2, 128, 64, 32),
                          (12, 2, 256, 256, 32)):
        mirror = ray_tile.resident_smem(S, L, H, C, R)
        own = ray_tile.library_smem(S, L, H, C, R)
        path = ray_tile.ray_path(S, L, H, C, R, f32, optin, ray_tile.library_smem)
        log(f"phase 20 path: S={S} L={L} H={H} C={C} R={R} f32: resident layouts {own} bytes "
            f"(mirror {mirror}), limit {optin}: {path}")
        if mirror != own:
            raise AssertionError("the wrappers' mirror of the resident layouts is not the library's")
    if ray_tile.ray_path(24, 3, 128, 64, 32, f32, optin, ray_tile.library_smem) != "streamed":
        raise AssertionError("depth 3 at the flagship widths in f32 should take the streamed path")
    g = torch.Generator(dev).manual_seed(20)
    gen3 = GeneratorNerfINR(serving_config(GeneratorConfig(nerf_hidden_layers=3)),
                            generator=torch.Generator().manual_seed(200)).to(dev).eval()

    def inputs(model, b, size, S, noise=0.0):
        zs = sample_zs(b, model.cfg, g, device=dev)
        with torch.no_grad():
            st = model.mapping(zs["z_nerf"], zs["z_inr"])
        opts = RenderOptions(img_size=size, num_steps=S, h_stddev=0.0, v_stddev=0.0)
        pos = torch.tensor([[0.3, 0.1, 0.95]], device=dev).repeat(b, 1)
        pos = pos / pos.norm(dim=-1, keepdim=True)
        world = model.sample_world(b, opts, g, pos, -pos)
        wt = [w.detach() for w in ray_tile.flat_weights(model.siren, st)]
        draws = ray_tile.draw_ray_randoms(b, size * size, S, noise != 0, g, dev)
        return st, (wt, world.points, world.origins, world.dirs, world.z_vals[..., 0], *draws)

    ptxas = ptxas_resources(lib_path.with_suffix(".log").read_text())
    entries, errs, times = {}, {}, {}
    with torch.no_grad():
        # ---- (a) #2: the depth-3 flagship's serving frame, r128 x 24
        st3, args = inputs(gen3, 1, 128, SERVING_STEPS)
        kw = dict(fast_sin=True)
        fa, da = ray_tile.ray_tile_cuda(*args, **kw)
        fb, db = ray_tile.ray_tile_plain(*args, **kw)
        errs["ray_tile_streamed"], _, _ = compare("ray_tile streamed L=3 r128 x24 f32 feature",
                                                  fa, fb, TOL["ray_tile", "float32"])
        compare("ray_tile streamed L=3 r128 x24 f32 depth", da, db, TOL["ray_tile", "float32"])
        fa2, da2 = ray_tile.ray_tile_cuda(*args, **kw)
        if not (torch.equal(fa, fa2) and torch.equal(da, da2)):
            raise AssertionError("#2 streamed: two runs differ")
        times["ray_tile_streamed"] = cuda_ms([lambda: ray_tile.ray_tile_plain(*args, **kw),
                                              lambda: ray_tile.ray_tile_cuda(*args, **kw)], reps=5)
        outs = {mm: ray_tile.ray_tile_cuda(*args, mm_dtype=mm, **kw)[0] for mm in (f32, bf16)}
        plain = {mm: ray_tile.ray_tile_plain(*args, mm_dtype=mm, **kw)[0] for mm in (f32, bf16)}
        errs["ray_tile_streamed bf16"] = check_bf16(
            "ray_tile streamed L=3 r128 x24 bfloat16 feature", outs[bf16], plain[bf16],
            plain[f32], outs[f32], TOL["ray_tile", "bfloat16"])
        del outs, plain, fa, fb, fa2
        # beside the resident path at the flagship (depth 2), which both paths take
        _, args2 = inputs(gen, 1, 128, SERVING_STEPS)
        ra_, rb_ = (ray_tile.ray_tile_cuda(*args2, path=p, **kw) for p in ("resident", "streamed"))
        same = all(torch.equal(x, y) for x, y in zip(ra_, rb_))
        compare("ray_tile streamed vs resident, flagship L=2 r128 x24 f32 feature", rb_[0],
                ra_[0], TOL["ray_tile", "float32"])
        times["ray_tile resident vs streamed"] = cuda_ms(
            [lambda: ray_tile.ray_tile_cuda(*args2, path="resident", **kw),
             lambda: ray_tile.ray_tile_cuda(*args2, path="streamed", **kw)], reps=5)
        log(f"phase 20 time: #2 L=3 r128 x24 f32: streamed {times['ray_tile_streamed'][1]:.3f} ms, "
            f"plain {times['ray_tile_streamed'][0]:.3f} ms; flagship L=2: resident "
            f"{times['ray_tile resident vs streamed'][0]:.3f} ms, streamed "
            f"{times['ray_tile resident vs streamed'][1]:.3f} ms (bit for bit the same: {same}) "
            f"[{smi}]")
        del args, args2, ra_, rb_

    # ---- (a) #2r and #3 at depth 3, r64, b = 4, S = 12 (phase 8's training shapes)
    st3, args = inputs(gen3, 4, 64, 12, noise=0.5)
    noise = torch.tensor(0.5, device=dev)
    d_fea = torch.randn((4, 4096, 32), generator=g, device=dev)
    d_dep = torch.randn((4, 4096, 1), generator=g, device=dev)
    tol = TOL["ray_tile", "float32"]
    # without noise, the strict tolerance (as phase 6 at S = 48 and 64)
    f0, d0, res0 = ray_tile.ray_tile_cuda(*args, 0.0, with_residuals=True)
    f0p, d0p = ray_tile.ray_tile_plain(*args, 0.0)
    errs["ray_tile_residuals_streamed"], _, _ = compare(
        "ray_tile residuals streamed L=3 r64 b=4 x12 f32 feature", f0, f0p, tol)
    compare("ray_tile residuals streamed L=3 r64 b=4 x12 f32 depth", d0, d0p, tol)
    fr, dr, res = ray_tile.ray_tile_cuda(*args, noise, with_residuals=True)
    fp, dp, rp = ray_tile.ray_tile_plain(*args, noise, with_residuals=True)
    compare("ray_tile residuals streamed L=3 r64 b=4 x12 noise 0.5 f32 feature", fr, fp, tol,
            check=False)
    # under noise the f32 resample's conditioning sets the share outside (phases 3 and 6): a
    # miss counts beyond the plain version with its fine depths from a float64 resample
    d64 = [t.double() for t in (args[1], args[4], args[5], args[6])]
    fz = ray_tile.plain_fine_depths([w.double() for w in args[0]], *d64, 0.5,
                                    mm_dtype=torch.float64).float()
    fw, dw = ray_tile.ray_tile_plain(*args, noise, fine_z=fz)
    kern = (outside(fr, fp, tol) | outside(dr, dp, tol)).float().mean().item()
    wit = (outside(fw, fp, tol) | outside(dw, dp, tol)).float().mean().item()
    log(f"  rays outside the f32 tolerance: streamed #2r {kern:.2e}; plain with float64 fine "
        f"depths {wit:.2e}")
    if kern > max(MAX_OUTSIDE, wit):
        raise AssertionError(f"#2r streamed: {kern:.2e} of rays outside, beyond the witness")
    for name, x, y in zip(("rh", "ra", "rhc", "rac"), res, rp):
        compare(f"  residual {name}", x, y, dict(rtol=tol["rtol"], atol=tol["atol"] * 20))
    witness = ray_tile.ray_tile_bwd_plain(*args, noise, d_fea, d_dep, fine_z=fz)
    wit_ge = max_grad_err(witness[0], ray_tile.ray_tile_bwd_plain(*args, noise, d_fea, d_dep)[0])
    # bf16 residuals under noise of each path: depth 3 at these widths fits the resident
    # layouts in bf16, so the resident bf16 kernel is the streamed one's witness
    resq = {p: ray_tile.ray_tile_cuda(*args, noise, mm_dtype=bf16, with_residuals=True, path=p)[2]
            for p in ("streamed", "resident")}
    for mode, r, r0 in (("recompute", None, None), ("residual", res, res0)):
        name = f"ray_tile_bwd_{mode}_streamed"
        # f32 without noise, at the strict tolerance
        g0, p0 = ray_tile.ray_tile_bwd_cuda(*args, 0.0, d_fea, d_dep, residuals=r0)
        g0p, p0p = ray_tile.ray_tile_bwd_plain(*args, 0.0, d_fea, d_dep, residuals=r0)
        e0, rays0 = max_grad_err(g0, g0p), rays_outside(p0, p0p, D_PTS_TOL["float32"])
        log(f"  #3 {mode} streamed L=3 r64 b=4 x12 f32, no noise: grads normalised err {e0:.2e} "
            f"(tol {BWD_TOL['float32']}), d pts rays outside {rays0:.2e} (bound {MAX_OUTSIDE})")
        if e0 > BWD_TOL["float32"] or rays0 > MAX_OUTSIDE:
            raise AssertionError(f"#3 {mode} streamed disagrees with the plain backward, no noise")
        errs[name] = max((a - b).abs().max().item() for a, b in zip(g0, g0p))
        # f32 under noise 0.5: a miss counts only if the float64-resample witness parts as well
        # (phase 6), and then by at most WITNESS_RATIO x the witness
        ga, pa = ray_tile.ray_tile_bwd_cuda(*args, noise, d_fea, d_dep, residuals=r)
        ga2, pa2 = ray_tile.ray_tile_bwd_cuda(*args, noise, d_fea, d_dep, residuals=r)
        gb, pb = ray_tile.ray_tile_bwd_plain(*args, noise, d_fea, d_dep, residuals=r)
        e, out_rays = max_grad_err(ga, gb), rays_outside(pa, pb, D_PTS_TOL["float32"])
        wit_rays = rays_outside(witness[1], pb, D_PTS_TOL["float32"])
        bits = all(torch.equal(x, y) for x, y in zip(ga + [pa], ga2 + [pa2]))
        log(f"  #3 {mode} streamed L=3 r64 b=4 x12 noise 0.5 f32: grads normalised err {e:.2e} "
            f"(tol {BWD_TOL['float32']}), d pts rays outside {out_rays:.2e}; float64-resample "
            f"witness: grads {wit_ge:.2e}, d pts rays {wit_rays:.2e}; two runs bit for bit: {bits}")
        if (not held(e, BWD_TOL["float32"], wit_ge) or not held(out_rays, MAX_OUTSIDE, wit_rays)
                or not bits):
            raise AssertionError(f"#3 {mode} streamed disagrees with the plain backward or itself")
        # bf16 under noise 0.5, each kernel on its own path's residuals and the plain version on
        # the same ones (phase 6): the streamed kernel held to the resident one as witness
        rq, rqr = (None, None) if r is None else (resq["streamed"], resq["resident"])
        # (in bf16 the resident layouts fit depth 3, so "auto" would take the resident kernel)
        gq, _ = ray_tile.ray_tile_bwd_cuda(*args, noise, d_fea, d_dep, residuals=rq,
                                           mm_dtype=bf16, path="streamed")
        gqr, _ = ray_tile.ray_tile_bwd_cuda(*args, noise, d_fea, d_dep, residuals=rqr,
                                            mm_dtype=bf16, path="resident")
        eq = max_grad_err(gq, ray_tile.ray_tile_bwd_plain(*args, noise, d_fea, d_dep,
                                                          residuals=rq, mm_dtype=bf16)[0])
        wq = max_grad_err(gqr, ray_tile.ray_tile_bwd_plain(*args, noise, d_fea, d_dep,
                                                           residuals=rqr, mm_dtype=bf16)[0])
        log(f"  #3 {mode} bfloat16 L=3 r64 b=4 x12 noise 0.5: grads normalised err streamed "
            f"{eq:.2e}, resident {wq:.2e} (tol {BWD_TOL['bfloat16']}); streamed vs resident "
            f"{max_grad_err(gq, gqr):.2e}")
        if not held(eq, BWD_TOL["bfloat16"], wq):
            raise AssertionError(f"#3 {mode} streamed bf16 under noise: beyond the resident kernel")
        # bf16 products without noise, each version on its own bf16 residuals; the control:
        # the f32 kernel
        rq = rqp = None
        if r is not None:
            rq = ray_tile.ray_tile_cuda(*args, 0.0, mm_dtype=bf16, with_residuals=True,
                                        path="streamed")[2]
            rqp = ray_tile.ray_tile_plain(*args, 0.0, mm_dtype=bf16, with_residuals=True)[2]
        gq, _ = ray_tile.ray_tile_bwd_cuda(*args, 0.0, d_fea, d_dep, residuals=rq, mm_dtype=bf16,
                                           path="streamed")
        gqp, _ = ray_tile.ray_tile_bwd_plain(*args, 0.0, d_fea, d_dep, residuals=rqp,
                                             mm_dtype=bf16)
        eb, ctrl = max_grad_err(gq, gqp), max_grad_err(g0, gqp)
        log(f"  #3 {mode} streamed bfloat16, no noise: grads normalised err {eb:.2e} (tol "
            f"{BWD_TOL['bfloat16']}); CONTROL f32 kernel vs bf16 plain {ctrl:.2e} (must fail)")
        if eb > BWD_TOL["bfloat16"] or ctrl <= BWD_TOL["bfloat16"]:
            raise AssertionError(f"#3 {mode} streamed bf16: check or control failed")
        errs[name + " bf16"] = max((a - b).abs().max().item() for a, b in zip(gq, gqp))
        del ga, ga2, gb, g0, g0p, gq, gqr, gqp, rq, rqr, rqp
    times["ray_tile_residuals_streamed"] = cuda_ms(
        [lambda: ray_tile.ray_tile_plain(*args, noise, with_residuals=True),
         lambda: ray_tile.ray_tile_cuda(*args, noise, with_residuals=True)], reps=5)
    times["ray_tile_bwd_residual_streamed"] = cuda_ms(
        [lambda: ray_tile.ray_tile_bwd_plain(*args, noise, d_fea, d_dep, residuals=res),
         lambda: ray_tile.ray_tile_bwd_cuda(*args, noise, d_fea, d_dep, residuals=res)], reps=5)
    times["ray_tile_bwd_recompute_streamed"] = cuda_ms(
        [lambda: ray_tile.ray_tile_bwd_plain(*args, noise, d_fea, d_dep),
         lambda: ray_tile.ray_tile_bwd_cuda(*args, noise, d_fea, d_dep)], reps=5)
    # with bf16 products: #2r's feature against the bf16 plain version with its control (at
    # depth 3 a bf16 sum flips a rounding on about 1e-3 of the rays: the resident bf16 kernel,
    # which takes depth 3 in bf16, is the witness, as for #3 above), and each training
    # kernel's time beside its bf16 plain version (the kernel rows' bf16 columns)
    fq, fqr = (ray_tile.ray_tile_cuda(*args, 0.0, mm_dtype=bf16, with_residuals=True, path=p)[0]
               for p in ("streamed", "resident"))
    fqp = ray_tile.ray_tile_plain(*args, 0.0, mm_dtype=bf16)[0]
    errs["ray_tile_residuals_streamed bf16"] = check_bf16(
        "ray_tile residuals streamed L=3 r64 b=4 x12 bfloat16 feature", fq, fqp, f0p, f0,
        TOL["ray_tile", "bfloat16"], witness=fqr)
    qb, qs = dict(mm_dtype=bf16), dict(mm_dtype=bf16, path="streamed")
    resb = ray_tile.ray_tile_cuda(*args, noise, with_residuals=True, **qs)[2]
    times["ray_tile_residuals_streamed bf16"] = cuda_ms(
        [lambda: ray_tile.ray_tile_plain(*args, noise, with_residuals=True, **qb),
         lambda: ray_tile.ray_tile_cuda(*args, noise, with_residuals=True, **qs)], reps=5)
    times["ray_tile_bwd_residual_streamed bf16"] = cuda_ms(
        [lambda: ray_tile.ray_tile_bwd_plain(*args, noise, d_fea, d_dep, residuals=resb, **qb),
         lambda: ray_tile.ray_tile_bwd_cuda(*args, noise, d_fea, d_dep, residuals=resb, **qs)],
        reps=5)
    times["ray_tile_bwd_recompute_streamed bf16"] = cuda_ms(
        [lambda: ray_tile.ray_tile_bwd_plain(*args, noise, d_fea, d_dep, **qb),
         lambda: ray_tile.ray_tile_bwd_cuda(*args, noise, d_fea, d_dep, **qs)], reps=5)
    del fq, fqr, fqp, resb
    _, args2 = inputs(gen, 4, 64, 12, noise=0.5)
    res2 = {p: ray_tile.ray_tile_cuda(*args2, noise, with_residuals=True, path=p)[2]
            for p in ("resident", "streamed")}
    for what, fn in (
            ("#2r", lambda p: ray_tile.ray_tile_cuda(*args2, noise, with_residuals=True, path=p)),
            ("#3 residual", lambda p: ray_tile.ray_tile_bwd_cuda(*args2, noise, d_fea, d_dep,
                                                                 residuals=res2[p], path=p)),
            ("#3 recompute", lambda p: ray_tile.ray_tile_bwd_cuda(*args2, noise, d_fea, d_dep,
                                                                  path=p))):
        t = cuda_ms([lambda: fn("resident"), lambda: fn("streamed")], reps=5)
        times[f"{what} resident vs streamed"] = t
        log(f"phase 20 time: {what} flagship L=2 r64 b=4 x12: resident {t[0]:.3f} ms, streamed "
            f"{t[1]:.3f} ms [{smi}]")
    for k in ("ray_tile_residuals_streamed", "ray_tile_bwd_residual_streamed",
              "ray_tile_bwd_recompute_streamed"):
        log(f"phase 20 time: {k} L=3 r64 b=4 x12 f32: streamed {times[k][1]:.3f} ms, plain "
            f"{times[k][0]:.3f} ms; bf16 products: streamed {times[k + ' bf16'][1]:.3f} ms, "
            f"plain {times[k + ' bf16'][0]:.3f} ms [{smi}]")
    del args, args2, res, res0, resq, res2, fr, fp, rp, fw, f0, f0p, witness

    # ---- (a) #1 at D = 1024, r64 (the wide generator's decode)
    gen_w = GeneratorNerfINR(serving_config(GeneratorConfig(nerf_hidden_dim=256,
                                                            inr_hidden_dim=1024)),
                             generator=torch.Generator().manual_seed(201))
    gen_w.siren = NeRFNetwork(hidden_dim=256, hidden_layers=2, rgb_dim=32,
                              style_dim=gen_w.cfg.nerf_style_dim, fast_sin=True,
                              color_hidden_dim=256, generator=torch.Generator().manual_seed(202))
    gen_w = gen_w.to(dev).eval()
    with torch.no_grad():
        st_w, _ = inputs(gen_w, 1, 8, 3)
        weights, mods = inr_tile.extract_inr_weights(gen_w.inr_net, 9)
        s_, d_ = inr_tile.compute_inr_mods(mods, st_w, 1024)
        x = torch.randn((1, 4096, 32), generator=g, device=dev)
        for scale in (1, 100):
            w_s = weights._replace(wr=weights.wr * scale)
            outs = {mm: inr_tile.inr_tile_cuda(x, s_, d_, w_s, mm_dtype=mm) for mm in (f32, bf16)}
            plain = {mm: inr_tile.inr_tile_plain(x, s_, d_, w_s, mm_dtype=mm) for mm in (f32, bf16)}
            case = f"inr_tile x{scale}"
            e, _, _ = compare(f"inr_tile streamed D=1024 r64 ToRGB x{scale} float32", outs[f32],
                              plain[f32], TOL[case, "float32"])
            e_b = check_bf16(f"inr_tile streamed D=1024 r64 ToRGB x{scale} bfloat16", outs[bf16],
                             plain[bf16], plain[f32], outs[f32], TOL[case, "bfloat16"])
            if scale == 1:
                errs["inr_tile_streamed"], errs["inr_tile_streamed bf16"] = e, e_b
                if not torch.equal(outs[f32], inr_tile.inr_tile_cuda(x, s_, d_, w_s)):
                    raise AssertionError("#1 streamed: two runs differ")
        times["inr_tile_streamed"] = cuda_ms(
            [lambda: inr_tile.inr_tile_plain(x, s_, d_, weights),
             lambda: inr_tile.inr_tile_cuda(x, s_, d_, weights)], reps=5)
        st1, _ = inputs(gen, 1, 8, 3)
        w1, m1 = inr_tile.extract_inr_weights(gen.inr_net, 9)
        s1, d1 = inr_tile.compute_inr_mods(m1, st1, 512)
        x1 = torch.randn((1, 16384, 32), generator=g, device=dev)
        a_, b_ = (inr_tile.inr_tile_cuda(x1, s1, d1, w1, path=p) for p in ("resident", "streamed"))
        compare("inr_tile streamed vs resident D=512 r128 f32", b_, a_, TOL["inr_tile x1", "float32"])
        for scale in (1, 100):   # and at D = 512, the width phase 3 checks the resident at
            w_s = w1._replace(wr=w1.wr * scale)
            outs = {mm: inr_tile.inr_tile_cuda(x1, s1, d1, w_s, mm_dtype=mm, path="streamed")
                    for mm in (f32, bf16)}
            plain = {mm: inr_tile.inr_tile_plain(x1, s1, d1, w_s, mm_dtype=mm) for mm in (f32, bf16)}
            check_bf16(f"inr_tile streamed D=512 r128 ToRGB x{scale} bfloat16", outs[bf16],
                       plain[bf16], plain[f32], outs[f32], TOL[f"inr_tile x{scale}", "bfloat16"])
            res_b = inr_tile.inr_tile_cuda(x1, s1, d1, w_s, mm_dtype=bf16, path="resident")
            log(f"  inr_tile D=512 x{scale} bfloat16: streamed bit for bit the resident: "
                f"{torch.equal(res_b, outs[bf16])}; max abs difference "
                f"{(res_b - outs[bf16]).abs().max().item():.3e}")
        t = cuda_ms([lambda: inr_tile.inr_tile_cuda(x1, s1, d1, w1, path="resident"),
                     lambda: inr_tile.inr_tile_cuda(x1, s1, d1, w1, path="streamed")], reps=5)
        times["#1 resident vs streamed"] = t
        log(f"phase 20 time: #1 D=1024 r64 f32: streamed {times['inr_tile_streamed'][1]:.3f} ms, "
            f"plain {times['inr_tile_streamed'][0]:.3f} ms; D=512 r128: resident {t[0]:.3f} ms, "
            f"streamed {t[1]:.3f} ms (bit for bit the same: {torch.equal(a_, b_)}) [{smi}]")
        del x, x1, a_, b_, outs, plain
    log(f"phase 20(a) done in {time.perf_counter() - t0:.1f} s")

    # ---- where a streamed call's time goes, launch by launch (`tools/stream_split.py`), in a
    # process of its own: after the profiled steps of the earlier phases a profiler session
    # here has come back without device events (the tool retries a profile that saw none)
    root = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.synchronize()
    proc = subprocess.run([sys.executable, "-m", "cips3d_tpu_torch.tools.stream_split"],
                          cwd=root, capture_output=True, text=True, timeout=600)
    for line in proc.stdout.splitlines():
        log(f"phase 20 split: {line}")
    if proc.returncode != 0 or proc.stdout.count(" launches, ") != 2:
        raise AssertionError(f"phase 20 split: exit {proc.returncode}: {proc.stderr[-2000:]}")
    log(f"phase 20 split done in {time.perf_counter() - t0:.1f} s [{smi}]")

    # ---- (b) the main paths on the streamed kernels, from zeroed counts
    counts = collections.Counter()
    svc = RenderService(gen3, img_size=128, num_steps=SERVING_STEPS)
    zero_kernel_counts()
    frames = [svc.frame(seed=0), svc.frame(seed=1, yaw=math.pi / 2 + 0.3),
              svc.frame(seed=1, depth=True)]
    torch.cuda.synchronize()
    got = kernel_counts()
    if (any(f.shape != (128, 128, 3) or f.dtype != np.uint8 for f in frames)
            or got["ray_tile_streamed"] <= 0 or got["inr_tile"] <= 0 or got["ray_tile"] != 0):
        raise AssertionError(f"RenderService depth 3: {[f.shape for f in frames]}, launches {got}")
    counts.update(got)
    log(f"phase 20 serve: RenderService depth 3 r128 x{SERVING_STEPS}, {len(frames)} frames, "
        f"launches {dict((k, v) for k, v in got.items() if v)}")
    runs = {}
    reqs = [(0, math.pi / 2), (1, math.pi / 2 + 0.3), (2, math.pi / 2 - 0.2)]
    for dispatch in ("eager", "program"):
        zero_kernel_counts()
        runs[dispatch] = ([svc.render(seed, yaw, dispatch=dispatch) for seed, yaw in reqs],
                          kernel_counts())
    torch.cuda.synchronize()
    exact, ok, share, dep = frames_agree(runs["program"][0], runs["eager"][0])
    log(f"phase 20 serve: depth-3 frames, captured replays vs eager calls: {held_line(exact, ok)} "
        f"(pixels outside {share:.2e}, depth {dep:.3e}); launches through the replays "
        f"{dict((k, v) for k, v in runs['program'][1].items() if v)}")
    if not exact or runs["program"][1] != runs["eager"][1]:
        raise AssertionError("phase 20: the streamed path's replays differ from its eager calls")
    counts.update(runs["program"][1])
    svc.close()
    gen3_cpu = copy.deepcopy(gen3).cpu()
    frame_vs_cpu(gen3, gen3_cpu, dev, f"  depth-3 frame r128 x{SERVING_STEPS} vs plain CPU path",
                 size=128, steps=SERVING_STEPS)
    del gen3_cpu
    tols = [STEP_TOL["loss_rtol"], STEP_TOL["grad"], STEP_TOL["grad"]] + [MAX_OUTSIDE] * 3
    for label, cfg, want in (
            ("exact sine, residual backward, NeRF depth 3",
             GeneratorConfig(fused_ray=True, fused_ray_vjp="pallas_residual", nerf_hidden_layers=3),
             ("ray_tile_residuals_streamed", "ray_tile_bwd_residual_streamed")),
            ("polynomial sine, recompute backward, NeRF depth 3",
             GeneratorConfig(fused_ray=True, fast_sin=True, nerf_hidden_layers=3),
             ("ray_tile_streamed", "ray_tile_bwd_recompute_streamed"))):
        zero_kernel_counts()
        card, _ = step_vs_cpu(dev, log, 0.0, cfg=cfg, label=label)
        got = kernel_counts()
        if any(x > tol for x, tol in zip(card, tols)) or min(got[k] for k in want) <= 0:
            raise AssertionError(f"phase 20 step ({label}): {card} against {tols}, launches {got}")
        counts.update(got)
        log(f"phase 20 train: {label}: launches {dict((k, v) for k, v in got.items() if v)}")
    root = os.path.dirname(os.path.abspath(__file__))
    ckpt = f"{tmp}/train_r64/ckptdir/best_fid"
    config = os.path.join(root, "configs/ffhq.yaml")
    out = os.path.join(tmp, "streamed_multiview.png")
    zero_kernel_counts()
    rc = cli.main(["multiview", "--ckpt", ckpt, "--config", config, "--command", "train_r64",
                   "--serving", "--num-steps", "48", "--seeds", "0", "--img-size", "64", "--out",
                   out])
    torch.cuda.synchronize()
    got = kernel_counts()
    shape = image_io.read_png(out).shape
    if rc != 0 or shape != (64, 320, 3) or got["ray_tile_streamed"] <= 0 or got["inr_tile"] <= 0:
        raise AssertionError(f"eval.cli multiview --num-steps 48: exit {rc}, grid {shape}, "
                             f"launches {got}")
    counts.update(got)
    log(f"phase 20 cli: eval.cli multiview --serving --num-steps 48 (S = 96) --seeds 0 "
        f"--img-size 64: grid {shape}, launches {dict((k, v) for k, v in got.items() if v)}")
    gen_cfg = serving_config(cli.generator_config(config, "train_r64"))
    mv = cli.load_generator(ckpt, gen_cfg, "G_ema", device=dev)
    mv_cpu = copy.deepcopy(mv).cpu()
    HostDraws = host_draws()
    with torch.no_grad():   # the grid's last view (yaw offset 0.5)
        grid = p_render.render_multiview(mv, None, seeds=[0], yaw_offsets=(0.5,), img_size=64,
                                         num_steps=48, draws=HostDraws(dev))
        ref = p_render.render_multiview(mv_cpu, None, seeds=[0], yaw_offsets=(0.5,),
                                        img_size=64, num_steps=48, draws=HostDraws("cpu"))
    err = np.abs(grid - ref)
    share = (err > FRAME_ATOL).any(1).mean()
    log(f"  multiview view r64 x96 vs plain CPU path: max_abs_err {err.max():.3e}; pixels "
        f"outside atol {FRAME_ATOL}: {share:.2e}")
    if not np.isfinite(grid).all() or share > MAX_OUTSIDE:
        raise AssertionError("multiview at S = 96: the kernel path disagrees with the plain path")
    del mv, mv_cpu
    zero_kernel_counts()
    frame_vs_cpu(gen_w, copy.deepcopy(gen_w).cpu(), dev,
                 f"  wide generator (H 256, C 256, D 1024) frame r64 x{WIDE_STEPS} vs plain CPU "
                 f"path", size=64, steps=WIDE_STEPS)
    got = kernel_counts()
    if got["ray_tile_streamed"] <= 0 or got["inr_tile_streamed"] <= 0 or got["inr_tile"] != 0:
        raise AssertionError(f"wide generator: launches {got}")
    counts.update(got)
    log(f"phase 20 wide: launches {dict((k, v) for k, v in got.items() if v)}")
    del gen_w, gen3

    # ---- the summary line's entries
    b_serve = serve_bound(SERVING_STEPS, F32_PEAK, widths=L3)
    b_train = train_bounds("float32", widths=L3)
    b_train_bf16 = train_bounds("bfloat16", widths=L3)
    n_w = 64 * 64
    b_inr = bound_ms(2 * n_w * (32 * 1024 + 17 * 1024 * 1024 + 6 * 1024 * 3),
                     4 * n_w * (32 + 3) + 4 * (32 * 1024 + 17 * 1024 * 1024))
    bounds = {"ray_tile_streamed": b_serve, "inr_tile_streamed": b_inr,
              "ray_tile_residuals_streamed": b_train["ray_tile_residuals"],
              "ray_tile_bwd_residual_streamed": b_train["ray_tile_bwd_residual"],
              "ray_tile_bwd_recompute_streamed": b_train["ray_tile_bwd_recompute"]}
    beside = {"ray_tile_streamed": "ray_tile resident vs streamed",
              "ray_tile_residuals_streamed": "#2r resident vs streamed",
              "ray_tile_bwd_residual_streamed": "#3 residual resident vs streamed",
              "ray_tile_bwd_recompute_streamed": "#3 recompute resident vs streamed",
              "inr_tile_streamed": "#1 resident vs streamed"}
    for name in build.STREAMED:
        inr = name == "inr_tile_streamed"
        entries[name] = dict(
            name=name, route="cuda",
            source=("cips3d_tpu_torch/csrc/inr_tile_streamed.cu" if inr
                    else "cips3d_tpu_torch/csrc/ray_tile_streamed.cu"),
            replaces=("cips3d_tpu/ops/pallas/inr_tile.py:48" if inr else
                      "cips3d_tpu/ops/pallas/ray_tile.py:421" if "bwd" in name else
                      "cips3d_tpu/ops/pallas/ray_tile.py:137"),
            launches=counts[name], max_abs_err=errs[name], ms=times[name][1],
            plain_ms=times[name][0], bound_ms=bounds[name][0], bound_by=bounds[name][1],
            library_ms=None, resident_ms_at_shared_shape=times[beside[name]][0],
            streamed_ms_at_shared_shape=times[beside[name]][1],
            **streamed_resources(name, ptxas, lib))
        if name + " bf16" in times:   # the training kernels with bf16 products
            key = name[:-len("_streamed")]
            entries[name].update(
                bf16_ms=times[name + " bf16"][1], bf16_plain_ms=times[name + " bf16"][0],
                bf16_max_abs_err=errs[name + " bf16"], bf16_bound_ms=b_train_bf16[key][0],
                bf16_bound_by=b_train_bf16[key][1])
    log(f"phase 20 done in {time.perf_counter() - t0:.1f} s [{smi}]")
    return counts, list(entries.values())


def main():
    import torch

    t_start = time.perf_counter()
    # ---- phase 1: device ------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA GPU")
    from cips3d_tpu_torch.apps.serve import RenderService, serve
    from cips3d_tpu_torch.eval.cli import serving_config
    from cips3d_tpu_torch.models.generator import GeneratorNerfINR, RenderOptions, sample_zs
    from cips3d_tpu_torch.ops import build, inr_tile, ray_tile
    from cips3d_tpu_torch.utils import graphs

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products accumulate in f32 (phase 15), as flax's bf16 compute does
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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
    from cips3d_tpu_torch import native

    t0 = time.perf_counter()
    native.library()
    log(f"phase 2 build: native image library {native.build().name} (g++, zipreader.cpp) "
        f"loaded in {time.perf_counter() - t0:.1f} s")

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
        for S in (12, SERVING_STEPS, LONG_STEPS, ray_tile.MAX_STEPS):
            world, st = world_and_styles(1, 128, S)
            wt = ray_tile.flat_weights(gen.siren, st)
            for noise in (0.0, 0.5):
                draws = ray_tile.draw_ray_randoms(1, 128 * 128, S, noise != 0, g, dev)
                args = (wt, world.points, world.origins, world.dirs, world.z_vals[..., 0],
                        *draws, noise)
                # past S = 24 under noise the f32 resample's conditioning sets the share
                # outside (PERF.md section 7): there a miss counts beyond the witness's
                long_noisy = noise != 0 and S > SERVING_STEPS
                for fs in ((True, False) if noise == 0 else (True,)):
                    tag = f"ray_tile S={S} noise={noise} fast_sin={fs}"
                    fa, da = ray_tile.ray_tile_cuda(*args, fast_sin=fs)
                    fb, db = ray_tile.ray_tile_plain(*args, fast_sin=fs)
                    if not (torch.isfinite(fa).all() and torch.isfinite(da).all()):
                        raise AssertionError(f"{tag}: kernel output is not finite")
                    e, _, _ = compare(tag + " float32 feature", fa, fb, TOL["ray_tile", "float32"],
                                      check=not long_noisy)
                    compare(tag + " float32 depth", da, db, TOL["ray_tile", "float32"],
                            check=not long_noisy)
                    if S in (SERVING_STEPS, LONG_STEPS, ray_tile.MAX_STEPS) and noise == 0 and fs:
                        err_at_main["ray_tile" + ("" if S == SERVING_STEPS else f" S={S}")] = e
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
                        if long_noisy and kern > max(MAX_OUTSIDE, wit):
                            raise AssertionError(f"{tag}: {kern:.2e} of rays outside the f32 "
                                                 f"tolerance, beyond the witness's {wit:.2e}")
                    if not fs or long_noisy:   # bf16 past S = 24 without noise
                        continue
                    outs = {mm: ray_tile.ray_tile_cuda(*args, fast_sin=fs, mm_dtype=mm, out_dtype=bf16)
                            for mm in (f32, bf16)}
                    plain = {mm: ray_tile.ray_tile_plain(*args, fast_sin=fs, mm_dtype=mm, out_dtype=bf16)
                             for mm in (f32, bf16)}
                    for i, part in ((0, "feature"), (1, "depth")):
                        e = check_bf16(f"{tag} bfloat16 {part}", outs[bf16][i], plain[bf16][i],
                                       plain[f32][i], outs[f32][i], TOL["ray_tile", "bfloat16"])
                        if S == SERVING_STEPS and noise == 0 and i == 0:
                            err_at_main["ray_tile bfloat16"] = e
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
                e = check_bf16(tag + " bfloat16", outs[bf16], plain[bf16], plain[f32], outs[f32],
                               TOL[case, "bfloat16"])
                if b == 1 and rgb_scale == 1:
                    err_at_main["inr_tile bfloat16"] = e

    log(f"phase 3 done in {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # ---- phase 4: the serving path ----------------------------------------
    service = RenderService(gen, img_size=128, num_steps=SERVING_STEPS)
    service_r256 = RenderService(gen, img_size=256, num_steps=12)
    zero_kernel_counts()
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
    launches = {k: build.launches(k) for k in ("ray_tile", "inr_tile")}
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
    frame_vs_cpu(gen, cpu_gen, dev, "  frame r32 x12 vs plain CPU path")

    log(f"phase 4 done in {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # ---- phase 5: timings -------------------------------------------------
    timings, long_times = {}, {}
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
        # #2 past 32 samples a ray, at the same frame: S = 48 and the cap
        for S in (LONG_STEPS, ray_tile.MAX_STEPS):
            world_l, st_l = world_and_styles(1, 128, S)
            args_l = (ray_tile.flat_weights(gen.siren, st_l), world_l.points, world_l.origins,
                      world_l.dirs, world_l.z_vals[..., 0],
                      *ray_tile.draw_ray_randoms(1, 128 * 128, S, False, g, dev))
            for mm in (torch.float32, torch.bfloat16):
                kw = dict(mm_dtype=mm, fast_sin=True)
                long_times[S, str(mm)[6:]] = cuda_ms(
                    [lambda: ray_tile.ray_tile_plain(*args_l, **kw),
                     lambda: ray_tile.ray_tile_cuda(*args_l, **kw)], reps=10)
            del world_l, st_l, args_l
    occ = ray_tile.kernel_occupancy(SERVING_STEPS, 2, 128, 64, 32)
    for mm in (torch.float32, torch.bfloat16):
        occ[f"inr_tile {str(mm)[6:]}"] = inr_tile.kernel_occupancy(512, mm)
    ptxas = ptxas_resources(lib_path.with_suffix(".log").read_text())
    for k, (plain, kern) in timings.items():
        entry = "ray_tile" if k == "ray_tile float32" else k
        extra = f"; {resources_line(entry, occ, ptxas)}" if entry in KERNEL_PARTS else ""
        log(f"phase 5 time: {k} r128 x{SERVING_STEPS} (n=16384): kernel {kern:.3f} ms, "
            f"plain {plain:.3f} ms [{smi}]{extra}")
    for (S, dn), (plain, kern) in long_times.items():
        occ_l = ray_tile.kernel_occupancy(S, 2, 128, 64, 32, getattr(torch, dn))["ray_tile"]
        log(f"phase 5 time: ray_tile {dn} r128 x{S} (n=16384): kernel {kern:.3f} ms, plain "
            f"{plain:.3f} ms [{smi}]; {occ_l[0]} warps/SM, {occ_l[1] / 1024:.1f} KB shared")
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
        log(f"phase 5 time: frame latency {name} (captured: a CUDA-graph replay a frame; host "
            f"clock, to uint8 on host): median {lat[name]:.2f} ms over {reps} (quartiles "
            f"{q[0]:.2f}..{q[2]:.2f}, min {min(ts):.2f}, max {max(ts):.2f}) [{smi}]")
    for svc in (service, service_r256):   # the frames' graphs and pools, before later phases
        svc.close()
    graphs.release()

    log(f"phase 5 done in {time.perf_counter() - t_phase:.1f} s")

    # bounds at the phase-5 shapes (b = 1, 16384 rays, 48 points a ray)
    n5 = 128 * 128
    serve_bounds, serve_bounds_bf16 = ({
        "ray_tile": serve_bound(SERVING_STEPS, peak),
        "inr_tile": bound_ms(2 * n5 * (32 * 512 + 17 * 512 * 512 + 6 * 512 * 3),
                             4 * n5 * (32 + 3) + 4 * (32 * 512 + 17 * 512 * 512), peak),
    } for peak in (F32_PEAK, BF16_PEAK))

    step_ms, train_errs, train = training_phases(dev, smi, log)

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
        t_phase = time.perf_counter()
        apps = apps_phase(dev, smi, log, tmp, data, gen, cpu_gen)
        graphs.release()
        log(f"phase 11 done in {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        data_counts = data_phase(dev, smi, log, tmp, step_ms[SHIPPED])
        log(f"phase 12 done in {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        dist_counts = dist_phase(dev, smi, log, tmp)
        log(f"phase 13 done in {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        ckpt_counts = checkpoint_phase(dev, smi, log, tmp, gen)
        graphs.release()
        log(f"phase 14 done in {time.perf_counter() - t_phase:.1f} s [{smi}]")
        t_phase = time.perf_counter()
        bench_counts, bf16_times = bench_phase(dev, smi, log, tmp, gen)
        graphs.release()
        log(f"phase 15 done in {time.perf_counter() - t_phase:.1f} s [{smi}]")
        chunk_counts = chunk_phase(dev, smi, log, tmp)
        graphs.release()
        render_counts = render_phase(dev, smi, log, tmp, gen)
        slice_counts = last_slice_phase(dev, smi, log, tmp, gen)
        graphs.release()
        long_counts = long_ray_phase(dev, smi, log, tmp, gen, cpu_gen)
        graphs.release()
        stream_counts, stream_entries = streamed_phase(dev, smi, log, tmp, gen, cpu_gen,
                                                       lib_path)
        graphs.release()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # launches on the main paths: serving (phase 4), training (phase 7), apps (phase 11),
    # training from the dataset tool's zip (phase 12), training on several processes (13),
    # a loaded reference checkpoint served (14), the bf16 step, frame and benches (15), the
    # chunks' replays (16), the render side's replays (17), render_sharded's replays through
    # one NCCL rank (18), the service and the eval CLI at 48 samples a ray (19); a program's
    # launches are counted
    # through its replays (and its warm-up's, which runs the kernels once before the capture)
    for k in ("ray_tile", "inr_tile"):
        launches[k] += (apps[k] + data_counts[k] + dist_counts[k] + ckpt_counts[k]
                        + bench_counts.get(k, 0) + chunk_counts[k] + render_counts[k]
                        + slice_counts[k] + long_counts[k] + stream_counts[k])
    for e in train:
        e["launches"] += (apps[e["name"]] + bench_counts.get(e["name"], 0)
                          + chunk_counts[e["name"]] + render_counts[e["name"]])
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
    # #2 past 32 samples a ray at phase 5's frame (the training rows carry theirs from phase 8)
    for S in (LONG_STEPS, ray_tile.MAX_STEPS):
        bnd = serve_bound(S, F32_PEAK)
        kernels[0].update({f"ms_s{S}": long_times[S, "float32"][1],
                           f"plain_ms_s{S}": long_times[S, "float32"][0], f"bound_ms_s{S}": bnd[0],
                           f"bound_by_s{S}": bnd[1],
                           f"max_abs_err_s{S}": err_at_main[f"ray_tile S={S}"]})
    # each kernel with bf16 products, as the benches launch it (phase 15, all bf16): its
    # time and plain time at the row's shapes (phase 5 for #1 and #2, phase 15(c) for #2r
    # and #3), its max abs error there against the bf16 plain version (phases 3 and 6) and
    # its bound at the bf16 peak
    bf16_t = dict(bf16_times, ray_tile=timings["ray_tile bfloat16"],
                  inr_tile=timings["inr_tile bfloat16"])
    bf16_err = dict(train_errs, **err_at_main)
    bf16_bounds = dict(train_bounds("bfloat16"), **serve_bounds_bf16)
    for e in kernels:
        k = e["name"]
        e.update(bf16_launches=bench_counts.get(k, 0), bf16_ms=bf16_t[k][1],
                 bf16_plain_ms=bf16_t[k][0], bf16_max_abs_err=bf16_err[k + " bfloat16"],
                 bf16_bound_ms=bf16_bounds[k][0], bf16_bound_by=bf16_bounds[k][1])
    kernels += stream_entries   # f32 at phase 20's shapes; the benches take no streamed kernel
    log(f"smoke wall time: {time.perf_counter() - t_start:.1f} s [{torch.cuda.get_device_name(0)}]")
    log(nvidia_smi())   # the card's name and power limit, as nvidia-smi prints them
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase13-rank"]:   # one rank of phase 13(b), started by main
        sys.exit(phase13_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--loop-run"]:   # one training-CLI run of phase 10(d), started by main
        sys.exit(loop_run(sys.argv[2:]))
    if sys.argv[1:2] == ["--finetune-run"]:   # phase 18(a, e)'s CLI run, started by main
        sys.exit(finetune_run(sys.argv[2:]))
    if sys.argv[1:2] == ["--variant-evals"]:   # the variants' 2048-image evals, timed
        sys.exit(variant_evals())
    sys.exit(main())
