"""The render-server cells: the program's `apps/serve.py::RenderService`
serving uint8 frames to viewers in a closed loop, as the HTTP server's
threads call `RenderService.frame` (the JPEG encode is left out).

Each viewer is a thread with its own seeded walk: yaw and pitch move by up
to ``step_rad`` a request inside the page's bounds (pi/2 +- ``yaw_range``,
pi/2 +- ``pitch_range``); with probability ``p_new_seed`` the viewer picks
another latent seed from a pool of ``seed_pool`` drawn from ``--seed``;
one request in 1 / ``p_depth`` asks for the depth image.  Every seed gives
every viewer the same number of requests of the same size.

Set-up makes the weights on the device from the seed, builds the service
and renders one frame of each kind (the program's capture of its frame).
The window runs ``--seconds``; the rate counts the frames returned inside
it, the tail every request sent inside it.

Correctness: once the window has closed and the service is freed,
`reference/generator.py` renders ``check_frames`` requests drawn from the
seed before the window among each viewer's first ``check_within`` (only
their frames are kept), and the slowest request of all, from the
same weights, latent seed, camera and draws, with TF32 off, and the frames
are compared level by level (``limits/<cell>.json``):
  frame_mean_diff  the largest mean difference of a checked frame's uint8
                   values;
  frame_off_share  the largest share of a checked frame's values that differ
                   by more than one level.
The largest single difference is printed beside them and not compared: a
ray whose coarse density sits at a resample boundary can pick other fine
samples on either side's rounding, and its pixel then differs by up to the
full range in a sound run.
"""

from __future__ import annotations

import gc
import math
import threading
import time
from typing import Dict, List, Optional

import numpy as np

import harness
from work.kernels import pixel_macs


class Viewer:
    """One viewer's requests, drawn as they are asked for: (latent seed,
    yaw, pitch, depth) each, from the viewer's own seeded generator."""

    def __init__(self, seed: int, viewer: int, tr: dict, pool: List[int]):
        self.rng = np.random.default_rng([seed, viewer])
        self.tr, self.pool = tr, pool
        self.yaw = self.pitch = math.pi / 2
        self.seed = int(pool[self.rng.integers(len(pool))])
        self.sent: List[tuple] = []

    def next(self) -> tuple:
        tr, rng = self.tr, self.rng
        self.yaw = float(np.clip(self.yaw + rng.uniform(-1, 1) * tr["step_rad"],
                                 math.pi / 2 - tr["yaw_range"], math.pi / 2 + tr["yaw_range"]))
        self.pitch = float(np.clip(self.pitch + rng.uniform(-1, 1) * tr["step_rad"],
                                   math.pi / 2 - tr["pitch_range"],
                                   math.pi / 2 + tr["pitch_range"]))
        if rng.random() < tr["p_new_seed"]:
            self.seed = int(self.pool[rng.integers(len(self.pool))])
        self.sent.append((self.seed, self.yaw, self.pitch, bool(rng.random() < tr["p_depth"])))
        return self.sent[-1]


def to_uint8(img: np.ndarray) -> np.ndarray:
    """(3, H, W) in [-1, 1] -> (H, W, 3) uint8, truncating as the server does."""
    return np.clip((img.astype(np.float32) + 1.0) * 127.5, 0, 255).astype(np.uint8) \
        .transpose(1, 2, 0)


def depth_to_uint8(d: np.ndarray, ray_start: float, ray_end: float) -> np.ndarray:
    d = (d.astype(np.float32) - ray_start) / (ray_end - ray_start)
    d8 = (np.clip(d, 0.0, 1.0) * 255).astype(np.uint8)
    return np.stack([d8] * 3, axis=-1)


def run(c: harness.Cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, control: Optional[str] = None, sizes: Optional[dict] = None,
        fault=None) -> harness.Run:
    import torch

    from cips3d_tpu_torch.apps.serve import RenderService
    from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR
    from reference.generator import Generator as RefG
    from reference.generator import GeneratorConfig as RefGCfg
    from reference.generator import RenderOptions as RefOpts
    from reference.generator import render_frame, sample_zs, truncated_styles

    tr, cfg = c.traffic, c.config
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    gen = {**cfg["generator"], **(sizes or {}).get("generator", {})}
    srv = {k: v for k, v in cfg["serving"].items() if k != "why"}
    render = cfg["render"]
    img = int((sizes or {}).get("img_size", tr["img_size"]))
    steps, fpts = int(tr["num_steps"]), int((sizes or {}).get("forward_points",
                                                               tr["forward_points"]))
    dtype = torch.bfloat16 if control == "bf16" else torch.float32
    harness.set_precision(torch, cfg)
    if cuda:
        harness.log(f"card: {harness.power_limit()}; precision flags: "
                    f"{harness.precision_flags(torch)}; program dtype {dtype}")
    ref_cfg = RefGCfg(**{k: v for k, v in {**gen, **srv}.items()
                         if k in RefGCfg.__dataclass_fields__})

    def ref_model():
        return harness.seeded_modules(lambda g: RefG(ref_cfg, generator=g), seed, dev).eval()

    # ---------------- set-up
    with torch.no_grad():
        ref = ref_model()
        with torch.device(dev):
            G = GeneratorNerfINR(GeneratorConfig(**{**gen, **srv}), dtype=dtype)
        harness.load_weights(G, ref.state_dict())
        del ref
    G.eval()
    service = RenderService(G, img_size=img, num_steps=steps, fov=render["fov"],
                            forward_points=fpts)
    frame = service.frame
    if fault is not None:
        frame = fault(frame)
    pool = [int(x) for x in np.random.default_rng(seed).integers(0, 2 ** 31, tr["seed_pool"])]
    viewers = [Viewer(seed, v, tr, pool) for v in range(int(tr["viewers"]))]
    s0, y0, p0 = pool[0], math.pi / 2, math.pi / 2
    frame(seed=s0, yaw=y0, pitch=p0, psi=tr["psi"], depth=False)
    frame(seed=s0, yaw=y0, pitch=p0, psi=tr["psi"], depth=True)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    harness.log(f"set-up {setup_s:.3f} s")

    # ---------------- window
    # the requests checked afterwards: drawn from the seed before the window, among each
    # viewer's first ``check_within``, and the slowest request of all
    rng = np.random.default_rng([seed, 7])
    per_viewer = max(1, int(tr["check_frames"]) // len(viewers))
    picks = {(v, int(i)) for v in range(len(viewers))
             for i in rng.choice(int(tr["check_within"]), per_viewer, replace=False)}
    kept: Dict[tuple, np.ndarray] = {}
    slowest = [-1.0, None, None]   # latency, (viewer, index), frame
    done: List[tuple] = []         # (viewer, index, latency s, finished at)
    errors: List[str] = []
    lock = threading.Lock()
    win = {}

    def viewer(v: int):
        i = 0
        while True:
            t = time.perf_counter()
            if t >= win["deadline"]:
                return
            s, yaw, pitch, depth = viewers[v].next()
            try:
                out = frame(seed=s, yaw=yaw, pitch=pitch, psi=tr["psi"], depth=depth)
                t1 = time.perf_counter()
                with lock:
                    done.append((v, i, t1 - t, t1))
                    if (v, i) in picks:
                        kept[(v, i)] = out
                    if t1 - t > slowest[0]:
                        slowest[:] = [t1 - t, (v, i), out]
            except Exception as e:   # a failed request misses every limit
                with lock:
                    errors.append(f"viewer {v} request {i}: {e!r}")
                    done.append((v, i, math.inf, math.inf))
            i += 1

    threads = [threading.Thread(target=viewer, args=(v,)) for v in range(len(viewers))]

    def start():
        win["t0"] = time.perf_counter()
        win["deadline"] = win["t0"] + seconds
        for t in threads:
            t.start()

    prof = None
    if trace and cuda:   # the profiler is on before any viewer launches work
        prof = harness.profile_slice(torch, lambda: (start(), time.sleep(tr["profile_seconds"])))
        prof["held_to"] = time.perf_counter()   # the profiler stopped and its trace read
    else:
        start()
    for t in threads:
        t.join()
    deadline = win["deadline"]
    window_s = seconds
    lat = np.array([d[2] for d in done])
    returned = sum(1 for d in done if d[3] <= deadline)
    failed = len(errors)
    values: Dict[str, float] = {
        "serve_frames_per_s": returned / window_s,
        "serve_p95_ms": float(np.percentile(lat, 95, method="linear") * 1e3) if len(lat) else
        math.inf,
        "setup_s": setup_s}
    device_rec = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if cuda:
        peak = torch.cuda.max_memory_allocated()
        values["peak_mem_gib"] = peak / 2 ** 30
        device_rec = dict(harness.card_record(torch, 1), memory_peak_bytes=peak)
    harness.log(f"window {window_s:.3f} s: {len(done)} requests, {returned} frames returned, "
                f"{failed} failed, p50 {np.median(lat) * 1e3:.3f} ms, "
                f"p95 {values['serve_p95_ms']:.3f} ms" + (f"; first error {errors[0]}"
                                                          if errors else ""))

    # ---------------- recorded eager frame (traced runs)
    readers = {m["name"]: harness.metric_reader(m["name"]) for m in c.per_layer} if trace else {}
    entries = [e for r in readers.values() for e in getattr(r, "ENTRIES", [])]
    rec = harness.Recorder(entries)
    if entries and cuda:
        with rec:
            service.render(seed=s0, yaw=y0, pitch=p0, psi=tr["psi"], dispatch="eager")
        torch.cuda.synchronize()
    # the rate of the frames outside the profiler's hold, under which they come slower
    slice_s = prof["held_to"] - win["t0"] if prof else 0.0
    in_slice = sum(1 for d in done if d[3] <= win["t0"] + slice_s)
    ctx = {"window_s": window_s - slice_s, "units": returned - in_slice,
           "flops_per_unit": 2.0 * img * img * pixel_macs(gen, steps), "profile": prof,
           "calls": rec.calls, "config": {"generator": gen},
           "time_call": lambda e, a, k: harness.time_call(torch, rec.originals[e], a, k)}
    per_layer = {}
    if trace and cuda:
        per_layer = {name: r.read(ctx) for name, r in readers.items()}
    rec.calls.clear()

    # ---------------- the reference, once the service is freed
    if slowest[1] is not None:
        kept[slowest[1]] = slowest[2]
    checked = [(v, i, kept[(v, i)]) for v, i in sorted(kept)]
    service.close()
    del service, G, frame
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    max_diff, mean_diff, off_share = 0, 0.0, 0.0
    try:
        ref = ref_model()
        opts = RefOpts(img_size=img, num_steps=steps, fov=render["fov"],
                       ray_start=render["ray_start"], ray_end=render["ray_end"],
                       h_stddev=0.0, v_stddev=0.0)
        chunk = min(fpts, img * img)
        while (img * img) % chunk:
            chunk -= 1
        avg_zs = sample_zs(2000, ref_cfg, torch.Generator(dev).manual_seed(0), dev)
        for v, i, got in checked:
            s, yaw, pitch, depth = viewers[v].sent[i]
            zs = sample_zs(1, ref_cfg, torch.Generator(dev).manual_seed(s), dev)
            styles = truncated_styles(ref, zs, tr["psi"], avg_zs)
            pos = torch.tensor([[math.sin(pitch) * math.cos(yaw), math.cos(pitch),
                                 math.sin(pitch) * math.sin(yaw)]])
            im, dm = render_frame(ref, styles, opts, torch.Generator(dev).manual_seed(s),
                                  pos.to(dev), (-pos).to(dev), chunk)
            want = (depth_to_uint8(dm[0, 0].cpu().numpy(), opts.ray_start, opts.ray_end)
                    if depth else to_uint8(im[0].cpu().numpy()))
            diff = np.abs(want.astype(np.int32) - np.asarray(got).astype(np.int32))
            max_diff = max(max_diff, int(diff.max()))
            mean_diff = max(mean_diff, float(diff.mean()))
            off_share = max(off_share, float((diff > 1).mean()))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    harness.log(f"checked {len(checked)} frames ({sum(viewers[v].sent[i][3] for v, i, _ in checked)} "
                f"depth) against the reference; largest difference {max_diff} levels")
    checks = {"frame_mean_diff": (mean_diff, float(c.limits["frame_mean_diff"])),
              "frame_off_share": (off_share, float(c.limits["frame_off_share"]))}
    if not checked:
        checks["frames_checked"] = (math.inf, 0.0)

    breakdown = None
    if trace and cuda:
        values.update({k: v for k, v in per_layer.items() if v is not None})
        if prof is not None:
            device_rec.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
            breakdown = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
        from cips3d_tpu_torch.ops import build

        harness.log(f"kernel launches (name, product dtype): {dict(build.LAUNCHES)}")
        harness.log(f"per-layer ({harness.power_limit()}; products at 495 TFLOP/s, bytes at "
                    f"3.35 TB/s): {per_layer}")
    return harness.Run(len(done), failed, values, device_rec, checks, breakdown)
