"""Reference-parity preflight gate: counterpart of `tools/parity_gate.py`.

One command that probes for the three artifacts the FFHQ parity claim needs
and runs whatever protocol the present artifacts allow:

  1. the FFHQ dataset (StyleGAN zip, r256);
  2. the InceptionV3 FID weights (`weights-inception-2015-12-05-6726825d.pth`,
     torch-fidelity's);
  3. the released reference checkpoints (G_ema ``.pth`` of FFHQ_r256, AFHQ,
     CartoonFaces).

With the artifacts present it runs, unattended: the checkpoint's strict
load into the port's generator, the exact reverse round trip and a finite
forward on the device; the N/N FID protocol (50k reals vs 50k EMA samples
at r64, target FID 15.27 within 5 %); and, when asked, the progressive
recipe's first stage.  Whatever is absent is named with its expected path
and download URL in the closing manifest.  Exit code: 0 when every
artifact is present and every check passed, 2 when a check failed, else 1.

Usage:
  python -m cips3d_tpu_torch.tools.parity_gate                    # probe + run what's possible
  python -m cips3d_tpu_torch.tools.parity_gate --num-images 1000  # smaller FID protocol
  python -m cips3d_tpu_torch.tools.parity_gate --launch-progressive
  python -m cips3d_tpu_torch.tools.parity_gate --dry-run          # probe + manifest only
  python -m cips3d_tpu_torch.tools.parity_gate --self-test        # the full protocol on
                                   # synthesized artifacts
  ... --device cpu                 # on the CPU (default: the card)

Artifact search paths can be overridden by flags or env:
  --data / $CIPS3D_FFHQ_ZIP, --inception / $CIPS3D_INCEPTION_WEIGHTS,
  --ckpt / $CIPS3D_REFERENCE_CKPT.

The JAX gate also runs the checkpoint through the reference's own v16
torch class; that needs the reference source tree and the test stubs,
which the port does not import, so this gate says it left that check out.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import os
import subprocess
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))

# Expected artifact locations (first hit wins) -------------------------------

DATA_CANDIDATES = [
    "datasets/ffhq/downsample_ffhq_256x256.zip",
    "datasets/ffhq/ffhq_256.zip",
    "datasets/ffhq_256.zip",
]
INCEPTION_NAME = "weights-inception-2015-12-05-6726825d.pth"
INCEPTION_URL = (
    "https://github.com/toshas/torch-fidelity/releases/download/v0.2.0/" + INCEPTION_NAME
)
CKPT_CANDIDATES = [
    # the release zips unpacked as the reference's web demo config expects
    "cache_pretrained/train_ffhq_high-20220105_143314_190/resume_iter_645500/G_ema.pth",
    "cache_pretrained/pretrained/G_ema_ffhq.pth",
    "cache_pretrained/finetune_afhq-20220124_193407_473/resume_iter200000/G_ema.pth",
    "cache_pretrained/finetune_photo2cartoon-20220107_172255_454/resume_iter29050/G_ema.pth",
    "cache_pretrained/pretrained/G_ema_cartoon.pth",
]
CKPT_URLS = [
    "https://github.com/PeterouZh/CIPS-3D/releases/download/v0.0.2/train_ffhq_high-20220105_143314_190.zip",
    "https://github.com/PeterouZh/CIPS-3D/releases/download/v0.0.3/finetune_afhq-20220124_193407_473_r256.zip",
    "https://github.com/PeterouZh/CIPS-3D/releases/download/v0.0.3/finetune_photo2cartoon-20220107_172255_454_r256.zip",
]
FFHQ_TARGET_FID = 15.27  # the reference's r64 FID; the gate passes within 5 %


def _find(candidates, env_var, flag_value):
    if flag_value:
        return flag_value if os.path.exists(flag_value) else None
    env = os.environ.get(env_var)
    if env and os.path.exists(env):
        return env
    for rel in candidates:
        for base in (os.getcwd(), REPO):
            hits = sorted(glob.glob(os.path.join(base, rel)))
            if hits:
                return hits[0]
    return None


def _md5(path: str, limit_mb: int = 512) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        read = 0
        while read < limit_mb * (1 << 20):
            chunk = f.read(1 << 20)
            if not chunk:
                break
            h.update(chunk)
            read += len(chunk)
    return h.hexdigest()


def probe(args):
    from cips3d_tpu_torch.eval import inception

    data = _find(DATA_CANDIDATES, "CIPS3D_FFHQ_ZIP", args.data)
    weights = args.inception if args.inception and os.path.exists(args.inception) \
        else inception.find_weights()
    ckpts = []
    if args.ckpt:
        ckpts = [p for p in args.ckpt if os.path.exists(p)]
    else:
        env = os.environ.get("CIPS3D_REFERENCE_CKPT")
        if env and os.path.exists(env):
            ckpts = [env]
        else:
            for rel in CKPT_CANDIDATES:
                for base in (os.getcwd(), REPO):
                    p = os.path.join(base, rel)
                    if os.path.exists(p):
                        ckpts.append(p)
    return data, weights, ckpts


# Checks ---------------------------------------------------------------------


def check_data(data_path: str) -> bool:
    from cips3d_tpu_torch.data.zip_dataset import ZipImageDataset

    ds = ZipImageDataset(data_path)
    n = len(ds)
    img, _ = ds[0]
    ok = n >= 1000 and img.shape[0] == 3 and img.shape[1] == img.shape[2]
    print(f"  dataset: {n} images at {img.shape[1]}x{img.shape[2]} "
          f"({'OK' if ok else 'SUSPICIOUS — expect 70000 @ 256x256'})")
    if n < 70000:
        print(f"  note: FFHQ has 70000 images; found {n} (protocol still runs)")
    return True


def check_inception(weights_path: str, device="cuda") -> bool:
    """Load the weights into the port's InceptionV3 and check that its pool3
    features are finite and not degenerate."""
    import numpy as np

    from cips3d_tpu_torch.eval.inception import InceptionV3Features

    print(f"  md5(first 512MB) = {_md5(weights_path)}")
    extractor = InceptionV3Features(weights_path, device=device)
    rng = np.random.default_rng(0)
    # NHWC uint8: the extractor's input contract (it resizes H and W, then
    # transposes to NCHW itself)
    batch = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    feats = np.asarray(extractor(batch))
    ok = feats.shape == (4, 2048) and np.all(np.isfinite(feats)) and feats.std() > 1e-4
    print(f"  pool3 features: shape {feats.shape}, std {feats.std():.4f} "
          f"({'OK' if ok else 'FAILED'})")
    return bool(ok)


def check_checkpoint(ckpt_path: str, device="cuda") -> bool:
    """The released ``.pth`` → the JAX layout and back (exact on every
    shared tensor), then a strict load into the port's generator and a
    finite forward on ``device``."""
    import numpy as np
    import torch

    from cips3d_tpu_torch.apps.render import render_chunked
    from cips3d_tpu_torch.models.generator import RenderOptions, sample_zs
    from cips3d_tpu_torch.utils.checkpoint import flatten
    from cips3d_tpu_torch.utils.convert_torch import (
        convert_generator_state_dict,
        export_generator_state_dict,
        load_reference_generator,
        load_torch_checkpoint,
    )

    sd = load_torch_checkpoint(ckpt_path)
    params = convert_generator_state_dict(sd)
    n_params = sum(int(np.prod(np.shape(v))) for v in flatten(params).values())
    print(f"  converted: {len(sd)} tensors → pytree with {n_params:,} params")

    # the reverse round trip must give back every source tensor bit for bit
    # (but the unused LayerNorms, which the JAX layout drops)
    back = export_generator_state_dict(params)
    mismatch = [k for k in sd
                if k in back and not np.array_equal(back[k], sd[k]) and ".norm." not in k]
    if mismatch:
        print(f"  ROUND-TRIP MISMATCH on {len(mismatch)} tensors, e.g. {mismatch[:3]}")
        return False
    print(f"  reverse round-trip: exact on {len(sd) - len(set(sd) - set(back))} shared tensors")

    gen = load_reference_generator(ckpt_path, device=device)
    rng = torch.Generator(device).manual_seed(0)
    zs = sample_zs(2, gen.cfg, rng, device=device)
    with torch.no_grad():
        styles = gen.mapping(zs["z_nerf"], zs["z_inr"])
        img = render_chunked(gen, styles, RenderOptions(img_size=16, num_steps=6), rng, 256)
    finite = bool(torch.isfinite(img).all())
    print(f"  strict load + forward on {device}: images {tuple(img.shape)} "
          f"({'OK' if finite else 'NOT FINITE'})")
    print("  reference-class check left out: it runs the reference's v16 torch class, "
          "which needs the reference source tree and the test stubs; the port imports neither")
    return finite


def run_fid_protocol(data_path, weights_path, ckpt_path, args) -> bool:
    """N reals vs N EMA samples, InceptionV3 FID (the reference's protocol)."""
    import numpy as np

    from cips3d_tpu_torch.data.zip_dataset import ZipImageDataset
    from cips3d_tpu_torch.eval.fid import eval_fid
    from cips3d_tpu_torch.eval.images import gen_images, setup_evaluation
    from cips3d_tpu_torch.eval.inception import InceptionV3Features
    from cips3d_tpu_torch.models.generator import GeneratorConfig
    from cips3d_tpu_torch.utils.convert_torch import load_reference_generator

    real_dir = os.path.join(args.outdir, "fid", "real")
    fake_dir = os.path.join(args.outdir, "fid", "fake")
    gen = load_reference_generator(ckpt_path, GeneratorConfig(), device=args.device)

    n = args.num_images
    print(f"  dumping {n} reals at r{args.img_size} → {real_dir}")
    setup_evaluation(ZipImageDataset(data_path, resize_resolution=args.img_size),
                     real_dir, n, args.img_size)
    print(f"  generating {n} EMA samples → {fake_dir}")
    gen_images(gen, fake_dir, n, args.img_size, batch_size=args.batch_size,
               num_steps=args.num_steps)
    metrics = eval_fid(real_dir, fake_dir, InceptionV3Features(weights_path, device=args.device),
                       require_reference=True)
    fid = metrics["FID"]
    within = abs(fid - FFHQ_TARGET_FID) / FFHQ_TARGET_FID <= 0.05
    print(f"  FID = {fid:.3f} (target {FFHQ_TARGET_FID} ± 5% → "
          f"{'PASS' if within else 'outside band'})")
    return bool(np.isfinite(fid))


def selftest_inception(path: str) -> None:
    """A random-init InceptionV3 in torch-fidelity's layout, its BatchNorm
    statistics and affines drawn so that they are not the identity."""
    import torch

    from cips3d_tpu_torch.eval.inception import InceptionV3

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = InceptionV3()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.uniform_(-0.2, 0.2, generator=g)
                mod.running_var.uniform_(0.5, 1.5, generator=g)
                mod.weight.uniform_(0.5, 1.5, generator=g)
                mod.bias.uniform_(-0.2, 0.2, generator=g)
    torch.save(model.state_dict(), path)


def self_test(args) -> int:
    """The full gate protocol on synthesized artifacts: the blob zip stands
    in for FFHQ, a random-init InceptionV3 for the FID weights and a seeded
    flagship generator, exported through `utils/convert_torch.py`, for the
    released checkpoint.  Every check and the N/N FID protocol then run the
    code paths the real artifacts take.  The FID value means nothing
    (random Inception weights); each stage must complete and the FID be
    finite."""
    import torch

    from cips3d_tpu_torch.data.synthetic import make_blob_dataset
    from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR
    from cips3d_tpu_torch.utils.convert import jax_tree_from_state_dict
    from cips3d_tpu_torch.utils.convert_torch import (export_generator_state_dict,
                                                      save_torch_checkpoint)

    work = args.outdir
    os.makedirs(work, exist_ok=True)
    print("== parity gate SELF-TEST: synthesizing artifacts ==")

    data = os.path.join(work, "selftest_data.zip")
    if not os.path.exists(data):
        make_blob_dataset(data, num_images=args.num_images * 2, img_size=64, seed=3)
    print(f"  dataset: {data}")

    weights = os.path.join(work, "weights-inception-selftest.pth")
    if not os.path.exists(weights):
        selftest_inception(weights)
    print(f"  inception weights (random init): {weights}")

    ckpt = os.path.join(work, "G_ema_selftest.pth")
    if not os.path.exists(ckpt):
        gen = GeneratorNerfINR(GeneratorConfig(), generator=torch.Generator().manual_seed(11))
        save_torch_checkpoint(export_generator_state_dict(
            jax_tree_from_state_dict(gen.state_dict())), ckpt)
    print(f"  checkpoint (random-init export): {ckpt}")

    ok = True
    print("\n== dataset check ==")
    ok &= check_data(data)
    print("\n== InceptionV3 weights check ==")
    ok &= check_inception(weights, args.device)
    print(f"\n== checkpoint conversion + validation: {ckpt} ==")
    ok &= check_checkpoint(ckpt, args.device)
    print("\n== full FID protocol ==")
    ok &= run_fid_protocol(data, weights, ckpt, args)
    print(f"\nself-test: {'ALL STAGES PASSED' if ok else 'FAILURES ABOVE'}")
    return 0 if ok else 2


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data", help="FFHQ StyleGAN zip")
    p.add_argument("--inception", help="InceptionV3 FID weights .pth")
    p.add_argument("--ckpt", nargs="*", help="released reference G_ema .pth files")
    p.add_argument("--outdir", default="results/parity_gate")
    p.add_argument("--num-images", type=int, default=50000,
                   help="FID protocol size (reference: 50000)")
    p.add_argument("--img-size", type=int, default=64,
                   help="eval resolution (the r64 target FID is 15.27)")
    p.add_argument("--num-steps", type=int, default=12)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--dry-run", action="store_true", help="probe + manifest only")
    p.add_argument("--launch-progressive", action="store_true",
                   help="kick off the r32 stage when data is present")
    p.add_argument("--self-test", action="store_true",
                   help="run every check + the FID protocol end-to-end on "
                        "synthesized artifacts (random-init Inception + "
                        "exported random-init checkpoint + synthetic data)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu on request)")
    args = p.parse_args(argv)

    if args.self_test:
        # shrink the protocol sizes not given: the self-test proves the code
        # path, not the statistic
        if args.outdir == "results/parity_gate":
            args.outdir = "results/parity_gate_selftest"
        if args.num_images == 50000:
            args.num_images = 24
        if args.img_size == 64:
            args.img_size = 32
        if args.num_steps == 12:
            args.num_steps = 4
        if args.batch_size == 16:
            args.batch_size = 8
        return self_test(args)

    data, weights, ckpts = probe(args)
    print("== parity gate: artifact probe ==")
    print(f"  FFHQ data:        {data or 'MISSING'}")
    print(f"  Inception weights: {weights or 'MISSING'}")
    print(f"  reference ckpts:   {ckpts or 'MISSING'}")

    ok = True
    if not args.dry_run:
        if data:
            print("\n== dataset check ==")
            ok &= check_data(data)
        if weights:
            print("\n== InceptionV3 weights check ==")
            ok &= check_inception(weights, args.device)
        for c in ckpts:
            print(f"\n== checkpoint conversion + validation: {c} ==")
            ok &= check_checkpoint(c, args.device)
        if data and weights and ckpts:
            print("\n== full FID protocol ==")
            ok &= run_fid_protocol(data, weights, ckpts[0], args)
        if data and args.launch_progressive:
            print("\n== progressive recipe kickoff ==")
            cmd = [sys.executable, "-m", "cips3d_tpu_torch.train.cli", "--config",
                   "configs/ffhq.yaml", "--command", "train_r32", "--device", args.device,
                   "--opts", "data_path", data]
            print(f"  $ {' '.join(cmd)}")
            subprocess.run(cmd, check=False)

    missing = []
    if not data:
        missing.append(
            "FFHQ dataset zip — place at one of:\n      " +
            "\n      ".join(os.path.join(REPO, c) for c in DATA_CANDIDATES) +
            "\n      (StyleGAN zip of 70000 images at 256x256; build from raw "
            "FFHQ with python -m cips3d_tpu_torch.data.dataset_tool --source <dir> "
            "--dest datasets/ffhq/downsample_ffhq_256x256.zip --resolution 256)"
        )
    if not weights:
        missing.append(
            f"InceptionV3 FID weights — place at "
            f"~/.cache/torch/hub/checkpoints/{INCEPTION_NAME}\n      "
            f"(or set $CIPS3D_INCEPTION_WEIGHTS)\n      from {INCEPTION_URL}"
        )
    if not ckpts:
        missing.append(
            "released reference checkpoints — unzip under cache_pretrained/ "
            "so G_ema.pth lands at:\n      " +
            "\n      ".join(CKPT_CANDIDATES[:2]) +
            "\n      from:\n      " + "\n      ".join(CKPT_URLS)
        )

    print("\n== manifest ==")
    if missing:
        print("missing artifacts (gate re-runs unattended once present):")
        for m in missing:
            print(f"  - {m}")
    else:
        print("all artifacts present.")
    print(f"checks: {'ALL PASSED' if ok else 'FAILURES ABOVE'}")
    return 0 if (ok and not missing) else (2 if not ok else 1)


if __name__ == "__main__":
    sys.exit(main())
