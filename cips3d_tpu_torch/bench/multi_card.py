"""Training on several cards, one process a card (NCCL): the flagship's
1-D and 2-D layouts (`parallel/mesh.py`) where one card cannot show them.

    python3 -m cips3d_tpu_torch.bench.multi_card             # every card of the machine
    python3 -m cips3d_tpu_torch.bench.multi_card --device cpu --ranks 4 --tiny   # gloo rehearsal

Ranks are started as the training CLI's are (the ``CIPS3D_*`` env), one
process a card, after one process has run the reference on card 0:
  1. 1-D: the shipped config (`configs/ffhq.yaml`: fast_sin, the unfused G
     phase, the D phase on the ray tile and the INR tile) at r64 with aux,
     b = 4 a rank (B = 4 x ranks), 10 steps from one seed's weights, draws
     and reals, against one process at b = B on card 0: the first step's
     losses and parameters (the smoke run's tolerances: losses rtol 1e-4, at
     most 0.1 % of the elements of G, D and G_ema further than 2e-2 lr), the
     median step time (steps 2-9, host clock) and images/s of both;
  2. 2-D: train_r512's settings (`configs/ffhq.yaml` train_r512: freeze_nerf,
     DiffAug, warm-up, aux off, no density noise) at r512 with ray_shards =
     ranks and b = 4 (one ray group: each rank renders a quarter of the
     pixels of the four rows on four ranks, D sees one row), 4 steps: finite
     losses, the same parameters on every rank, each rank's peak memory and
     step time.  No card holds that step in one process.
Products in full f32 (TF32 off), as in `chip_smoke.py`.  Prints one line
per check beside the card's name and power limit, then one JSON summary;
exits non-zero when a check fails.
"""

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import torch

TINY_G = dict(z_dim_nerf=16, z_dim_inr=32, nerf_hidden_dim=16, nerf_style_dim=16,
              nerf_mapping_layers=2, inr_hidden_dim=32, inr_style_dim=32, inr_mapping_layers=2)
TINY_D = {r: 16 for r in (4, 8, 16, 32, 64, 128, 256, 512, 1024)}
LOSS_RTOL, PARAM_LR, MAX_OUTSIDE = 1e-4, 2e-2, 1e-3


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        items = [_to(v, dev) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
    return x


def _case(kind, ranks, tiny):
    """(generator config, discriminator kwargs, TrainConfig, aux, B, steps)."""
    from cips3d_tpu_torch.models.generator import GeneratorConfig
    from cips3d_tpu_torch.train.state import TrainConfig

    widths = TINY_G if tiny else {}
    dkw = dict(channels_override=TINY_D) if tiny else {}
    if kind == "1d":
        return (GeneratorConfig(fast_sin=True, fused_ray=False, **widths), dkw,
                TrainConfig(img_size=16 if tiny else 64, batch_size=4, ema_start_itr=0,
                            nerf_noise_disable=True), True, 4 * ranks, 10)
    return (GeneratorConfig(fast_sin=True, fused_ray=False, freeze_nerf=True, **widths),
            dict(dkw, diffaug=True),
            TrainConfig(img_size=32 if tiny else 512, batch_size=4, ema_start_itr=0,
                        diffaug=True, warmup_d=True, train_aux_img=False, nerf_noise_disable=True,
                        gen_lr=1e-4, disc_lr=5e-4), False, 4, 4)


def run_steps(kind, ranks, tiny, dev, mesh=None):
    """The steps of case ``kind`` (this rank's rows with ``mesh``): the
    metrics and host ms of each step, the parameters after the first, a
    checksum of the last, the peak memory."""
    from cips3d_tpu_torch.models.discriminator import DiscriminatorMultiScaleAux
    from cips3d_tpu_torch.models.generator import GeneratorNerfINR, RenderOptions
    from cips3d_tpu_torch.train.step import draw_step, init_train_state, make_train_step

    # full f32 as the smoke run: with TF32 cuDNN picks other algorithms at other batch
    # sizes, and one process at b = B would round otherwise than the ranks at b = B / ranks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg_g, dkw, tcfg, aux, batch, steps = _case(kind, ranks, tiny)
    gen = GeneratorNerfINR(cfg_g, generator=torch.Generator().manual_seed(0)).to(dev)
    disc = DiscriminatorMultiScaleAux(max_size=1024, **dkw,
                                      generator=torch.Generator().manual_seed(1)).to(dev)
    state = init_train_state(gen, disc, tcfg)
    fn = make_train_step(gen, disc, tcfg, RenderOptions(), aux_reg=aux, mesh=mesh)
    g = torch.Generator().manual_seed(2)
    n = tcfg.img_size ** 2
    gp = tcfg.grad_points ** 2 if tcfg.grad_points and tcfg.grad_points ** 2 < n else None
    opts = RenderOptions(img_size=tcfg.img_size, nerf_noise=0.0)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    times, metrics, first = [], [], None
    for i in range(steps):
        draws = _to(draw_step(cfg_g, disc.main_disc.diffaug, tcfg, opts, aux, gp, batch, g, "cpu"),
                    dev)
        real = (torch.rand((batch, 3, tcfg.img_size, tcfg.img_size), generator=g) * 2 - 1)
        if mesh is not None:
            rows = batch // mesh.world
            real = real[mesh.rank * rows:(mesh.rank + 1) * rows]
        real = real.to(dev)
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = fn(state, real, draws=draws)
        if cuda:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            first = [[p.detach().cpu().clone() for p in mod.parameters()]
                     for mod in (state.generator, state.discriminator, state.ema)]
    checksum = sum(p.detach().double().sum().item() for mod in (state.generator,
                                                                 state.discriminator, state.ema)
                   for p in mod.parameters())
    return dict(metrics=metrics, times=times, first=first, checksum=checksum,
                lrs=(tcfg.gen_lr, tcfg.disc_lr, tcfg.gen_lr), batch=batch,
                peak=torch.cuda.max_memory_allocated(dev) if cuda else None)


def rank_main(out_dir, device, ranks, tiny):
    """One rank: both cases on its mesh; the results into ``out_dir``."""
    import torch.distributed as dist

    from cips3d_tpu_torch.parallel.mesh import initialize_multihost, local_device, make_mesh

    if not initialize_multihost(device=device):
        raise SystemExit("multi_card rank: CIPS3D_COORDINATOR/NUM_PROCESSES/PROCESS_ID not set")
    dev = torch.device(local_device(device))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    try:
        res = {"1d": run_steps("1d", ranks, tiny, dev, make_mesh(1)),
               "2d": run_steps("2d", ranks, tiny, dev, make_mesh(dist.get_world_size()))}
        torch.save(res, os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _smi():
    if not torch.cuda.is_available():
        return "no CUDA device (CPU rehearsal)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def _share(got, ref, lr):
    """Share of elements further apart than PARAM_LR * lr."""
    far = sum(((a - b).abs() > PARAM_LR * lr).sum().item() for a, b in zip(got, ref))
    return far / sum(a.numel() for a in ref)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--ranks", type=int, default=None, help="default: every card")
    p.add_argument("--tiny", action="store_true", help="tiny widths and sizes (a rehearsal)")
    p.add_argument("--rank-of", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank_of:
        return rank_main(args.rank_of, args.device, args.ranks, args.tiny)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("multi_card: no CUDA device; pass --device cpu for a rehearsal")
    ranks = args.ranks or torch.cuda.device_count()
    if ranks < 2:
        raise SystemExit(f"multi_card: {ranks} card(s); it needs at least 2")
    smi = _smi()
    dev = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    t0 = time.perf_counter()
    ref = run_steps("1d", ranks, args.tiny, dev)
    ref_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out_dir = tempfile.mkdtemp(prefix="multi_card_")
    port, procs = _free_port(), []
    t0 = time.perf_counter()
    for rank in range(ranks):
        env = dict(os.environ, CIPS3D_COORDINATOR=f"127.0.0.1:{port}",
                   CIPS3D_NUM_PROCESSES=str(ranks), CIPS3D_PROCESS_ID=str(rank))
        cmd = [sys.executable, "-m", "cips3d_tpu_torch.bench.multi_card", "--device",
               args.device, "--ranks", str(ranks), "--rank-of", out_dir] + (
                   ["--tiny"] if args.tiny else [])
        procs.append(subprocess.Popen(cmd, env=env))
    try:
        rcs = [proc.wait(timeout=1500) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    if any(rcs):
        raise SystemExit(f"multi_card: a rank failed: exit codes {rcs}")
    res = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
           for r in range(ranks)]
    failures, summary = [], {"ranks": ranks, "device": smi}

    # 1-D against one process
    got = res[0]["1d"]
    lerr = max(abs(got["metrics"][0][k] - ref["metrics"][0][k]) / max(abs(ref["metrics"][0][k]),
                                                                        1e-6)
               for k in ("d_loss", "g_loss", "grad_penalty"))
    shares = [_share(a, b, lr) for a, b, lr in zip(got["first"], ref["first"], ref["lrs"])]
    med = {name: statistics.median(r["times"][2:]) for name, r in (("ranks", got), ("one", ref))}
    size = _case("1d", ranks, args.tiny)[2].img_size
    print(f"multi_card 1d: shipped r{size} aux, {ranks} ranks x b=4 (B={ref['batch']}) vs one "
          f"process "
          f"b={ref['batch']} on card 0: step 0 losses rel err {lerr:.2e} (tol {LOSS_RTOL}), "
          f"parameters beyond {PARAM_LR} lr G {shares[0]:.2e} D {shares[1]:.2e} EMA "
          f"{shares[2]:.2e} (bound {MAX_OUTSIDE}); median step (steps 2-9, host clock) "
          f"{med['ranks']:.1f} ms = {ref['batch'] * 1e3 / med['ranks']:.2f} images/s on {ranks} "
          f"ranks, {med['one']:.1f} ms = {ref['batch'] * 1e3 / med['one']:.2f} images/s in one "
          f"process (its 10 steps {ref_s:.1f} s with set-up) [{smi}]", flush=True)
    if lerr > LOSS_RTOL or max(shares) > MAX_OUTSIDE:
        failures.append("1d disagrees with one process")
    summary["1d"] = dict(losses_rel_err=lerr, param_shares=shares, ranks_ms=med["ranks"],
                         one_process_ms=med["one"], batch=ref["batch"])

    # 2-D: finite, the same everywhere, memory and time of each rank
    finite = all(all(v == v and abs(v) != float("inf") for v in m.values())
                 for r in res for m in r["2d"]["metrics"])
    same = all(len({r[k]["checksum"] for r in res}) == 1 for k in ("1d", "2d"))
    peaks = [r["2d"]["peak"] for r in res]
    ms2 = [statistics.median(r["2d"]["times"][1:]) for r in res]
    m0, m_last = res[0]["2d"]["metrics"][0], res[0]["2d"]["metrics"][-1]
    print(f"multi_card 2d: train_r512's settings at r{_case('2d', ranks, args.tiny)[2].img_size}, "
          f"ray_shards {ranks}, b=4 (one ray group): d_loss {m0['d_loss']:.4f} -> "
          f"{m_last['d_loss']:.4f}, g_loss {m0['g_loss']:.4f} -> {m_last['g_loss']:.4f} over "
          f"{len(res[0]['2d']['metrics'])} steps, finite {finite}, parameters equal on every rank "
          f"{same}; peak memory a rank "
          + ", ".join("not measured" if pk is None else f"{pk / 2 ** 30:.2f} GiB" for pk in peaks)
          + "; median step (steps 1-3, host clock) a rank "
          + ", ".join(f"{t:.1f} ms" for t in ms2)
          + f"; {ranks} ranks in {wall:.1f} s wall (start-up included) [{smi}]", flush=True)
    if not (finite and same):
        failures.append("2d not finite or ranks differ")
    summary["2d"] = dict(finite=finite, same=same, peak_bytes=peaks, step_ms=ms2)
    summary["ok"] = not failures
    print(json.dumps(summary), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
