"""Training CLI: counterpart of `cips3d_tpu/train/cli.py`.

    python -m cips3d_tpu_torch.train.cli --config configs/ffhq.yaml \
        --command train_r32 [--opts key value ...] [--debug] [--device cuda|cpu]

Resolves a YAML command node (``base:`` inheritance, dotted ``--opts``)
and runs the flagship loop (`train/loop.py`) on the card, or on the CPU
when ``--device cpu`` asks for it.  Stage outputs go to
``<outdir>/<command>``; ``finetune_dir`` takes effect only with
``load_finetune``.  ``--debug`` shrinks the run to a 2-step smoke test.
The variant pipelines (``pipeline: diffcam|pigan``) are not ported.
"""

from __future__ import annotations

import sys

from cips3d_tpu_torch.config.config import dump_config, parse_args, resolve_command
from cips3d_tpu_torch.models.generator import GeneratorConfig, RenderOptions
from cips3d_tpu_torch.train.loop import LoopConfig, train
from cips3d_tpu_torch.train.state import TrainConfig


def config_to_dataclasses(cfg):
    """Split a resolved config node into the typed configs."""
    gen_cfg = GeneratorConfig(**cfg.generator.to_dict())
    r = cfg.render.to_dict()
    hierarchical = r.pop("hierarchical_sample", True)
    opts = RenderOptions(img_size=cfg.img_size, hierarchical_sample=hierarchical, **r)
    flat = cfg.to_dict()
    train_cfg = TrainConfig(**{k: v for k, v in flat.items()
                               if k in TrainConfig.__dataclass_fields__})
    loop_cfg = LoopConfig(**{k: v for k, v in flat.items()
                             if k in LoopConfig.__dataclass_fields__})
    return gen_cfg, train_cfg, opts, loop_cfg


def train_kwargs_from_config(cfg) -> dict:
    """Resume and finetune flags: ``finetune_dir`` counts only with
    ``load_finetune``."""
    return dict(
        resume=bool(cfg.get("resume", False)),
        finetune_dir=cfg.get("finetune_dir") if cfg.get("load_finetune", False) else None,
        load_nerf_ema=bool(cfg.get("load_nerf_ema", False)),
        reset_best_fid=bool(cfg.get("reset_best_fid", False)),
    )


def main(argv=None):
    args = parse_args(argv)
    cfg = resolve_command(args.config, args.command, args.opts)
    pipeline = cfg.get("pipeline", "cips3d")
    if pipeline in ("diffcam", "pigan"):
        raise NotImplementedError(f"pipeline {pipeline!r} is not ported yet (the variants, "
                                  "ROADMAP Queue 1 item 11)")
    if pipeline != "cips3d":
        raise SystemExit(f"unknown pipeline {pipeline!r}")
    gen_cfg, train_cfg, opts, loop_cfg = config_to_dataclasses(cfg)
    if args.debug:
        loop_cfg.debug = True
    loop_cfg.device = args.device
    loop_cfg.outdir = cfg.get("outdir", args.outdir) + f"/{args.command}"
    print(f"resolved config:\n{dump_config(cfg)}", flush=True)
    train(gen_cfg, train_cfg, opts, loop_cfg, disc_kwargs=cfg.discriminator.to_dict(),
          **train_kwargs_from_config(cfg))
    return 0


if __name__ == "__main__":
    sys.exit(main())
