"""The ray-tile and INR-tile kernels against another checkout's: bits and times.

    python -m cips3d_tpu_torch.tools.ray_tile_ab --dump new.pt
    (cd OTHER && PYTHONPATH=. python /path/to/ray_tile_ab.py --dump other.pt)
    python -m cips3d_tpu_torch.tools.ray_tile_ab --compare other.pt new.pt
    python -m cips3d_tpu_torch.tools.ray_tile_ab --time 12 24 48 64

``--dump`` runs #2, #2r and #3 (residual and recompute) of whichever
`cips3d_tpu_torch` is imported on seeded inputs made on the CPU: the
flagship generator's serving frame at r128 with S = 12 and 24 (density noise
0 and 0.5, exact and polynomial sine) and its training shapes at r64, b = 4,
S = 12 (noise 0 and 0.5), with f32 and bf16 products; #1 on the resident
path at the flagship's r128 decode (D = 512, 6 blocks); and the streamed
path (``path="streamed"``): #2 at NeRF depth 3, r128 x 24, #2r and #3 (both
modes) at depth 3, r64, b = 4, S = 12, #1 at D = 1024, r64; and saves every
output.  ``--compare`` prints, per output, whether the two dumps agree bit
for bit and the largest difference, and exits 1 if a call differs in any
bit, but for the streamed #3, whose outputs may part by the backward rows'
normalised error, max|a - b| / (max|b| + 1), 1e-4 in f32 and 1e-2 in bf16
(a redesigned streamed backward may sum in another order).
``--time S ..`` prints one JSON line of median CUDA-event times (ms) of
#2 at r128, b = 1 (fast_sin, no noise: the serving frame) and of #2r and
#3 in both modes at r64, b = 4 (density noise 0.5 as a tensor on the
device, as the training step passes it), at each S, with f32 and bf16
products; run it once per checkout in turns (A, B, B, A) to compare two.
It uses only the wrappers' public arguments, so it runs against an older
checkout of the package as well.  Needs a CUDA device.
"""

import argparse
import json
import statistics
import sys

import torch


def _inputs(gen, b, size, steps, noise, seed):
    from cips3d_tpu_torch.models.generator import RenderOptions, sample_zs
    from cips3d_tpu_torch.ops import ray_tile

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        zs = sample_zs(b, gen.cfg, g)
        st = gen.mapping(zs["z_nerf"], zs["z_inr"])
        pos = torch.tensor([[0.3, 0.1, 0.95]]).repeat(b, 1)
        pos = pos / pos.norm(dim=-1, keepdim=True)
        world = gen.sample_world(b, RenderOptions(img_size=size, num_steps=steps, h_stddev=0.0,
                                                  v_stddev=0.0), g, pos, -pos)
        wt = [w.detach() for w in ray_tile.flat_weights(gen.siren, st)]
    draws = ray_tile.draw_ray_randoms(b, size * size, steps, noise != 0, g, "cpu")
    d_fea = torch.randn((b, size * size, 32), generator=g)
    d_dep = torch.randn((b, size * size, 1), generator=g)
    dev = torch.device("cuda")
    cuda = lambda ts: [t.to(dev) for t in ts]
    return (cuda(wt), cuda([world.points, world.origins, world.dirs, world.z_vals[..., 0],
                            *draws]), cuda([d_fea, d_dep]))


def _inr_inputs(D, n, n_blocks, seed, in0=32):
    """Seeded decode inputs at width D on the card: (x, s, d, weights)."""
    from cips3d_tpu_torch.ops import inr_tile

    g = torch.Generator().manual_seed(seed)
    L, nr = 2 * n_blocks, n_blocks - 3
    w0 = torch.randn((in0, D), generator=g) / in0 ** 0.5
    wrest = torch.randn((L - 1, D, D), generator=g) / D ** 0.5
    s = 1.0 + 0.1 * torch.randn((1, L, D), generator=g)
    s[:, 0, in0:] = 0.0
    d = torch.stack([torch.rsqrt((s[:, i, :w.shape[0]] ** 2) @ (w ** 2) + 1e-8)
                     for i, w in enumerate([w0] + list(wrest))], 1)
    dev = torch.device("cuda")
    w = inr_tile.InrWeights(w0=w0.to(dev), wrest=wrest.to(dev),
                            wr=(torch.randn((nr, D, 3), generator=g) / D ** 0.5 * 20).to(dev),
                            br=(0.1 * torch.randn((nr, 3), generator=g)).to(dev))
    x = torch.randn((1, n, in0), generator=g).to(dev)
    return x, s.contiguous().to(dev), d.contiguous().to(dev), w


def dump(path):
    from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR
    from cips3d_tpu_torch.ops import inr_tile, ray_tile

    gen = GeneratorNerfINR(GeneratorConfig(fused_ray=True, fused_inr=True),
                           generator=torch.Generator().manual_seed(0)).eval()
    gen3 = GeneratorNerfINR(GeneratorConfig(fused_ray=True, fused_inr=True, nerf_hidden_layers=3),
                            generator=torch.Generator().manual_seed(3)).eval()
    out = {}
    for mm in (torch.float32, torch.bfloat16):
        dn = str(mm)[6:]
        for steps in (12, 24):
            for noise in (0.0, 0.5):
                wt, args, _ = _inputs(gen, 1, 128, steps, noise, 100 + steps)
                for fs in (True, False):
                    fea, dep = ray_tile.ray_tile_cuda(wt, *args, noise, fast_sin=fs, mm_dtype=mm)
                    out[f"2 r128 S={steps} noise={noise} fast_sin={fs} {dn}"] = [fea, dep]
        for noise in (0.0, 0.5):
            wt, args, (d_fea, d_dep) = _inputs(gen, 4, 64, 12, noise, 200)
            for fs in (False, True):
                tag = f"r64 b=4 S=12 noise={noise} fast_sin={fs} {dn}"
                fea, dep, res = ray_tile.ray_tile_cuda(wt, *args, noise, fast_sin=fs, mm_dtype=mm,
                                                       with_residuals=True)
                out[f"2r {tag}"] = [fea, dep, *res]
                for mode, r in (("residual", res), ("recompute", None)):
                    g, d_pts = ray_tile.ray_tile_bwd_cuda(wt, *args, noise, d_fea, d_dep,
                                                          residuals=r, fast_sin=fs, mm_dtype=mm)
                    out[f"3 {mode} {tag}"] = [*g, d_pts]
        x, s, d, w = _inr_inputs(512, 128 * 128, inr_tile.num_blocks(128), 500)
        out[f"1 r128 D=512 {dn}"] = [inr_tile.inr_tile_cuda(x, s, d, w, mm_dtype=mm)]
        # the streamed path
        wt, args, _ = _inputs(gen3, 1, 128, 24, 0.0, 600)
        out[f"2 streamed L=3 r128 S=24 fast_sin=True {dn}"] = list(ray_tile.ray_tile_cuda(
            wt, *args, 0.0, fast_sin=True, mm_dtype=mm, path="streamed"))
        wt, args, (d_fea, d_dep) = _inputs(gen3, 4, 64, 12, 0.0, 700)
        fea, dep, res = ray_tile.ray_tile_cuda(wt, *args, 0.0, mm_dtype=mm, with_residuals=True,
                                               path="streamed")
        out[f"2r streamed L=3 r64 b=4 S=12 {dn}"] = [fea, dep, *res]
        for mode, r in (("residual", res), ("recompute", None)):
            g, d_pts = ray_tile.ray_tile_bwd_cuda(wt, *args, 0.0, d_fea, d_dep, residuals=r,
                                                  mm_dtype=mm, path="streamed")
            out[f"3 {mode} streamed L=3 r64 b=4 S=12 {dn}"] = [*g, d_pts]
        x, s, d, w = _inr_inputs(1024, 64 * 64, 9, 800)
        out[f"1 streamed r64 D=1024 {dn}"] = [inr_tile.inr_tile_cuda(x, s, d, w, mm_dtype=mm,
                                                                     path="streamed")]
    torch.cuda.synchronize()
    torch.save({k: [t.cpu() for t in v] for k, v in out.items()}, path)
    print(f"ray_tile_ab: {len(out)} calls dumped to {path} on {torch.cuda.get_device_name(0)}")


def _median_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_kernels(steps):
    from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR
    from cips3d_tpu_torch.ops import ray_tile

    gen = GeneratorNerfINR(GeneratorConfig(fused_ray=True, fused_inr=True),
                           generator=torch.Generator().manual_seed(0)).eval()
    out = {}
    for S in steps:
        wt, args, _ = _inputs(gen, 1, 128, S, 0.0, 300 + S)
        for mm in (torch.float32, torch.bfloat16):
            dn = str(mm)[6:]
            out[f"ray_tile r128 S={S} {dn}"] = _median_ms(
                lambda: ray_tile.ray_tile_cuda(wt, *args, 0.0, fast_sin=True, mm_dtype=mm))
        del wt, args
        wt, args, (d_fea, d_dep) = _inputs(gen, 4, 64, S, 0.5, 400 + S)
        noise = torch.full((), 0.5, device="cuda")
        for mm in (torch.float32, torch.bfloat16):
            dn = str(mm)[6:]
            res = ray_tile.ray_tile_cuda(wt, *args, noise, mm_dtype=mm, with_residuals=True)[2]
            out[f"ray_tile_residuals r64 b=4 S={S} {dn}"] = _median_ms(
                lambda: ray_tile.ray_tile_cuda(wt, *args, noise, mm_dtype=mm,
                                               with_residuals=True))
            out[f"ray_tile_bwd_residual r64 b=4 S={S} {dn}"] = _median_ms(
                lambda: ray_tile.ray_tile_bwd_cuda(wt, *args, noise, d_fea, d_dep,
                                                   residuals=res, mm_dtype=mm))
            out[f"ray_tile_bwd_recompute r64 b=4 S={S} {dn}"] = _median_ms(
                lambda: ray_tile.ray_tile_bwd_cuda(wt, *args, noise, d_fea, d_dep,
                                                   fast_sin=True, mm_dtype=mm))
            del res
        del wt, args, d_fea, d_dep
    print(json.dumps({"device": torch.cuda.get_device_name(0), "ms": out}), flush=True)


def compare(a_path, b_path):
    a, b = torch.load(a_path), torch.load(b_path)
    if a.keys() != b.keys():
        print(f"ray_tile_ab: the dumps hold other calls: {sorted(a.keys() ^ b.keys())}")
        return 1
    differ = 0
    for k in a:
        same = all(torch.equal(x, y) for x, y in zip(a[k], b[k]))
        err = max((x.float() - y.float()).abs().max().item() for x, y in zip(a[k], b[k]))
        if "streamed" in k and k.startswith("3 "):   # within the backward rows' normalised error
            tol = 1e-4 if "float32" in k else 1e-2
            norm = max(((x.float() - y.float()).abs().max() / (y.float().abs().max() + 1)).item()
                       for x, y in zip(a[k], b[k]))
            ok = norm <= tol
            print(f"  {k}: {'bit for bit' if same else 'within tolerance' if ok else 'DIFFERS'} "
                  f"(max abs diff {err:.3e}, normalised {norm:.3e}, tol {tol:g})")
            differ += not ok
        else:
            print(f"  {k}: {'bit for bit' if same else 'DIFFERS'} (max abs diff {err:.3e})")
            differ += not same
    print(f"ray_tile_ab: {len(a)} calls, {differ} differ (in any bit; the streamed #3: past "
          f"the tolerance)")
    return 1 if differ else 0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dump", metavar="PATH")
    p.add_argument("--compare", nargs=2, metavar=("A", "B"))
    p.add_argument("--time", nargs="+", type=int, metavar="S")
    args = p.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    if not torch.cuda.is_available():
        raise SystemExit("ray_tile_ab: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.time:
        time_kernels(args.time)
    if args.dump:
        dump(args.dump)
    return 0


if __name__ == "__main__":
    sys.exit(main())
