"""Evaluation and demo CLI: counterpart of `cips3d_tpu/eval/cli.py`.

    python -m cips3d_tpu_torch.eval.cli MODE --ckpt results/run/ckptdir/best_fid \\
        [--config configs/ffhq.yaml --command train_r64] [--serving] [--device cuda|cpu]

Modes, as the JAX package's:
  * ``fid``: dump real images of ``--data`` and EMA fakes, then FID (+KID
    with ``--kid``); InceptionV3 when its checkpoint is found
    (`eval/inception.py::find_weights`), else refused unless
    ``--allow-surrogate`` permits ``FID_surrogate``;
  * ``gen``, ``sample``: image dumps (random and fixed pose);
  * ``multiview``: a seeds x yaws grid PNG;
  * ``trajectory``: PNG frames along a camera path and their MJPEG-AVI
    (``--depth`` adds depth frames and video);
  * ``viewer``: a self-contained HTML viewer of a pose grid.

The snapshot is read in the JAX package's layout (written by either
package).  ``--config``/``--command`` take the generator node of a YAML
command; ``--serving`` renders through the hand-written kernels (the ray
tile and the INR tile) with the polynomial sine.  The port runs on the
card unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Optional

import torch

from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR
from cips3d_tpu_torch.utils.checkpoint import load_snapshot_module
from cips3d_tpu_torch.utils.convert import load_jax_params

MODES = ("fid", "gen", "sample", "multiview", "trajectory", "viewer")


def load_generator(ckpt_dir: str, gen_cfg: GeneratorConfig, module: str = "G_ema",
                   device="cuda", dtype=torch.float32) -> GeneratorNerfINR:
    """A generator with the weights of a JAX-layout snapshot directory
    (``.../ckptdir/best_fid``), on ``device``, in eval mode."""
    gen = GeneratorNerfINR(gen_cfg, dtype=dtype)
    load_jax_params(gen, load_snapshot_module(ckpt_dir, module))
    return gen.to(device).eval()


def serving_config(gen_cfg: GeneratorConfig = GeneratorConfig(),
                   fast_sin: bool = True) -> GeneratorConfig:
    """The serving flags on ``gen_cfg``: both forward kernels (ray tile and
    INR tile), with the polynomial sine unless ``fast_sin`` is False."""
    return dataclasses.replace(gen_cfg, fused_ray=True, fused_inr=True, fast_sin=fast_sin)


def generator_config(config: Optional[str] = None, command: Optional[str] = None
                     ) -> GeneratorConfig:
    """The ``generator:`` node of ``command`` (default train_base) in the
    YAML ``config``; `GeneratorConfig()` without a config."""
    if not config:
        return GeneratorConfig()
    from cips3d_tpu_torch.config.config import resolve_command

    cfg = resolve_command(config, command or "train_base")
    return GeneratorConfig(**cfg.generator.to_dict())


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("mode", choices=MODES)
    p.add_argument("--ckpt", required=True, help="snapshot dir (e.g. .../ckptdir/best_fid)")
    p.add_argument("--module", default="G_ema")
    p.add_argument("--config", default=None, help="YAML with a `generator:` node "
                   "(to eval checkpoints of non-default architecture)")
    p.add_argument("--command", default=None, help="command node in --config")
    p.add_argument("--data", default=None, help="dataset zip (fid mode)")
    p.add_argument("--out", default="eval_out")
    p.add_argument("--img-size", type=int, default=256)
    p.add_argument("--num-steps", type=int, default=12)
    p.add_argument("--num-images", type=int, default=2048)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--kid", action="store_true")
    p.add_argument("--allow-surrogate", action="store_true",
                   help="permit the random-CNN FID_surrogate when InceptionV3 weights are "
                   "unavailable (relative tracking only)")
    p.add_argument("--psi", type=float, default=0.7)
    p.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2, 3])
    p.add_argument("--trajectory-mode", default="circle")
    p.add_argument("--num-frames", type=int, default=30)
    p.add_argument("--depth", action="store_true",
                   help="also render depth maps (trajectory video / viewer toggle)")
    p.add_argument("--serving", action="store_true",
                   help="render through the serving configuration: the ray-tile and "
                   "INR-tile kernels with the polynomial sine")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu on request)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    gen_cfg = generator_config(args.config, args.command)
    if args.serving:
        gen_cfg = serving_config(gen_cfg)
    if args.mode == "fid":   # refuse before rendering anything
        from cips3d_tpu_torch.eval.fid import default_extractor

        try:
            extractor = default_extractor(not args.allow_surrogate, args.device)
        except RuntimeError as e:
            raise SystemExit(f"fid: {e}")
    gen = load_generator(args.ckpt, gen_cfg, args.module, device=args.device)
    t0 = time.perf_counter()

    if args.mode == "fid":
        from cips3d_tpu_torch.data.zip_dataset import ZipImageDataset
        from cips3d_tpu_torch.eval.fid import eval_fid
        from cips3d_tpu_torch.eval.images import gen_images, setup_evaluation

        real_dir = os.path.join(args.out, "fid/real")
        fake_dir = os.path.join(args.out, "fid/fake")
        setup_evaluation(ZipImageDataset(args.data), real_dir, args.num_images, args.img_size)
        gen_images(gen, fake_dir, args.num_images, args.img_size, batch_size=args.batch_size,
                   num_steps=args.num_steps)
        print(eval_fid(real_dir, fake_dir, extractor, kid=args.kid))
    elif args.mode in ("gen", "sample"):
        from cips3d_tpu_torch.eval.images import gen_images, sample_images

        dump = gen_images if args.mode == "gen" else sample_images
        n = dump(gen, args.out, args.num_images, args.img_size, batch_size=args.batch_size,
                 num_steps=args.num_steps)
        print(f"wrote {n} images to {args.out}")
    elif args.mode == "multiview":
        from cips3d_tpu_torch.apps.render import render_multiview

        render_multiview(gen, args.out, seeds=args.seeds, img_size=args.img_size,
                         num_steps=args.num_steps, psi=args.psi)
        print(f"wrote {args.out}")
    elif args.mode == "trajectory":
        from cips3d_tpu_torch.apps.render import render_trajectory_video

        frames = render_trajectory_video(
            gen, args.out, seed=args.seeds[0], mode=args.trajectory_mode,
            num_frames=args.num_frames, img_size=args.img_size, num_steps=args.num_steps,
            psi=args.psi, depth=args.depth)
        print(f"wrote {len(frames)} frames to {args.out}")
    else:
        from cips3d_tpu_torch.apps.viewer import export_html_viewer

        out = args.out if args.out.endswith(".html") else os.path.join(args.out, "viewer.html")
        export_html_viewer(gen, out, seeds=args.seeds, img_size=args.img_size,
                           num_steps=args.num_steps, psi=args.psi, depth=args.depth)
        print(f"wrote {out}")
    print(f"{args.mode}: {time.perf_counter() - t0:.3f} s after loading", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
