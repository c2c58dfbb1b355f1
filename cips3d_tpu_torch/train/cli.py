"""Training CLI: counterpart of `cips3d_tpu/train/cli.py`.

    python -m cips3d_tpu_torch.train.cli --config configs/ffhq.yaml \
        --command train_r32 [--opts key value ...] [--debug] [--device cuda|cpu]

Resolves a YAML command node (``base:`` inheritance, dotted ``--opts``)
and runs the host loop (`train/loop.py`) on the card, or on the CPU when
``--device cpu`` asks for it: the flagship, or the variant pipeline a node's
``pipeline: diffcam|pigan`` names (`train/variant_loop.py`; without
``load_nerf_ema``, which only the flagship's chain uses).  Stage outputs go
to ``<outdir>/<command>``; ``finetune_dir`` takes effect only with
``load_finetune``.  ``--debug`` shrinks the run to a 2-step smoke test.

Several processes train together when ``CIPS3D_COORDINATOR`` (host:port),
``CIPS3D_NUM_PROCESSES`` and ``CIPS3D_PROCESS_ID`` are set, one process a
card (``cuda:{process_id % device_count}``, NCCL) or on the CPU (gloo):
`parallel/mesh.py::initialize_multihost`, before anything else.
"""

from __future__ import annotations

import sys

import torch

from cips3d_tpu_torch.config.config import dump_config, parse_args, resolve_command
from cips3d_tpu_torch.models.generator import GeneratorConfig, RenderOptions
from cips3d_tpu_torch.parallel.mesh import initialize_multihost, local_device
from cips3d_tpu_torch.train.loop import LoopConfig, run_pipeline, train
from cips3d_tpu_torch.train.state import TrainConfig
from cips3d_tpu_torch.train.variant_loop import build_diffcam_pipeline, build_pigan_pipeline


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
    if not initialize_multihost(device=args.device):   # unless CIPS3D_COORDINATOR/... are set
        return run(args)
    try:
        return run(args)
    finally:
        torch.distributed.destroy_process_group()


def run(args):
    """Train the stage ``args`` names (in this process's rank, if any)."""
    cfg = resolve_command(args.config, args.command, args.opts)
    pipeline = cfg.get("pipeline", "cips3d")
    if pipeline not in ("cips3d", "diffcam", "pigan"):
        raise SystemExit(f"unknown pipeline {pipeline!r}")
    loop_cfg = LoopConfig(**{k: v for k, v in cfg.to_dict().items()
                             if k in LoopConfig.__dataclass_fields__})
    if args.debug:
        loop_cfg.debug = True
    loop_cfg.device = local_device(args.device)
    loop_cfg.outdir = cfg.get("outdir", args.outdir) + f"/{args.command}"
    print(f"resolved config:\n{dump_config(cfg)}", flush=True)
    kw = train_kwargs_from_config(cfg)
    if pipeline != "cips3d":
        build = build_diffcam_pipeline if pipeline == "diffcam" else build_pigan_pipeline
        kw.pop("load_nerf_ema")
        run_pipeline(build(cfg), loop_cfg, **kw)
        return 0
    gen_cfg, train_cfg, opts, _ = config_to_dataclasses(cfg)
    train(gen_cfg, train_cfg, opts, loop_cfg, disc_kwargs=cfg.discriminator.to_dict(), **kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
