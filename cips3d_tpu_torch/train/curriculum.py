"""Curricula and the progressive stage chain: counterpart of
`cips3d_tpu/train/curriculum.py`.

A curriculum is a dict whose integer keys are stage-start steps holding
per-stage overrides (img_size, batch_size, lrs, ...) and whose string keys
are global settings: `extract_metadata` merges the newest stage <= step
over the globals, `next_upsample_step` and `last_upsample_step` find the
resolution bumps.  `CELEBA`, `CARLA` and `CATS` are the pi-GAN curricula,
kept as data.  `run_progressive` chains the flagship's resolution stages
(`FFHQ_STAGES`) on `train/loop.py::train`, each finetuning from the previous
stage's ``best_fid`` snapshot, on the device of ``LoopConfig.device``.  In a
process group every rank runs every stage; the loop's closing barrier keeps
each rank from reading a stage's snapshot before rank 0 has written it.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, Optional

# ---------------------------------------------------------------------- #
# curriculum dicts


def extract_metadata(curriculum: Dict, current_step: int) -> Dict[str, Any]:
    """Newest integer stage <= step merged over the string-keyed globals."""
    out: Dict[str, Any] = {}
    int_keys = sorted((k for k in curriculum if isinstance(k, int)), reverse=True)
    for stage in int_keys:
        if stage <= current_step:
            out.update(curriculum[stage])
            break
    for k, v in curriculum.items():
        if not isinstance(k, int):
            out[k] = v
    return out


def next_upsample_step(curriculum: Dict, current_step: int) -> float:
    """Step of the next img_size increase."""
    current_size = extract_metadata(curriculum, current_step)["img_size"]
    for stage in sorted(k for k in curriculum if isinstance(k, int)):
        if stage > current_step and curriculum[stage].get("img_size", 2048) > current_size:
            return stage
    return float("inf")


def last_upsample_step(curriculum: Dict, current_step: int) -> int:
    """Start step of the current resolution stage."""
    current_size = extract_metadata(curriculum, current_step)["img_size"]
    for stage in sorted(k for k in curriculum if isinstance(k, int)):
        if stage <= current_step and curriculum[stage].get("img_size") == current_size:
            return stage
    return 0


#: pi-GAN curricula, kept as data.
CELEBA = {
    0: {"batch_size": 56, "num_steps": 12, "img_size": 64, "batch_split": 2,
        "gen_lr": 6e-5, "disc_lr": 2e-4},
    int(4000e3): {},
    "fov": 12, "ray_start": 0.88, "ray_end": 1.12, "fade_steps": 10000,
    "h_stddev": 0.3, "v_stddev": 0.155,
    "h_mean": math.pi * 0.5, "v_mean": math.pi * 0.5,
    "sample_dist": "gaussian", "topk_interval": 2000, "topk_v": 0.6,
    "betas": (0, 0.9), "weight_decay": 0, "r1_lambda": 0.2, "latent_dim": 256,
    "grad_clip": 10, "clamp_mode": "relu", "z_dist": "gaussian",
    "hierarchical_sample": True, "z_lambda": 0, "pos_lambda": 15,
    "last_back": False, "eval_last_back": True,
}

CARLA = {
    0: {"batch_size": 30, "num_steps": 48, "img_size": 32, "batch_split": 1,
        "gen_lr": 4e-5, "disc_lr": 4e-4},
    int(10e3): {"batch_size": 14, "num_steps": 48, "img_size": 64, "batch_split": 2,
                "gen_lr": 2e-5, "disc_lr": 2e-4},
    int(55e3): {"batch_size": 10, "num_steps": 48, "img_size": 128, "batch_split": 5,
                "gen_lr": 10e-6, "disc_lr": 10e-5},
    int(200e3): {},
    "fov": 30, "ray_start": 0.7, "ray_end": 1.3, "fade_steps": 10000,
    "h_stddev": math.pi, "v_stddev": math.pi / 4 * 85 / 90,
    "h_mean": math.pi * 0.5, "v_mean": math.pi / 4 * 85 / 90,
    "topk_interval": 1000, "topk_v": 0.5, "betas": (0, 0.9),
    "sample_dist": "spherical_uniform", "weight_decay": 0, "r1_lambda": 10,
    "latent_dim": 256, "grad_clip": 1, "clamp_mode": "relu", "z_dist": "gaussian",
    "hierarchical_sample": True, "z_lambda": 0, "pos_lambda": 0,
    "learnable_dist": False, "white_back": True,
}

CATS = {
    0: {"batch_size": 28, "num_steps": 24, "img_size": 64, "batch_split": 4,
        "gen_lr": 6e-5, "disc_lr": 2e-4},
    int(200e3): {},
    "fov": 12, "ray_start": 0.8, "ray_end": 1.2, "fade_steps": 10000,
    "h_stddev": 0.5, "v_stddev": 0.4, "h_mean": math.pi * 0.5, "v_mean": math.pi * 0.5,
    "sample_dist": "uniform", "topk_interval": 2000, "topk_v": 0.6,
    "betas": (0, 0.9), "weight_decay": 0, "r1_lambda": 0.2, "latent_dim": 256,
    "grad_clip": 10, "clamp_mode": "relu", "z_dist": "gaussian",
    "hierarchical_sample": True, "z_lambda": 0, "pos_lambda": 15, "last_back": False,
    "eval_last_back": True,
}

CURRICULUMS = {"CelebA": CELEBA, "CARLA": CARLA, "CATS": CATS}


# ---------------------------------------------------------------------- #
# CIPS-3D progressive stage chain


@dataclasses.dataclass
class Stage:
    """One progressive-resolution stage (one launch of the CLI)."""

    name: str
    img_size: int
    total_iters: int
    overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)
    gen_overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)
    disc_overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)
    load_nerf_ema: bool = False


FFHQ_STAGES = [
    Stage("r32", 32, 80000),
    Stage("r64", 64, 200000),
    Stage("r128", 128, 200000),
    Stage(
        "r256", 256, 800000,
        overrides=dict(
            gen_lr=1e-4, disc_lr=5e-4, warmup_d=True, train_aux_img=False,
            diffaug=True, nerf_noise_disable=True,
        ),
        gen_overrides=dict(freeze_nerf=True),
        disc_overrides=dict(diffaug=True),
        load_nerf_ema=True,
    ),
]


def run_progressive(gen_cfg, train_cfg, opts, loop_cfg, stages=None,
                    disc_kwargs: Optional[dict] = None, start_stage: int = 0):
    """Run ``stages`` (default `FFHQ_STAGES`) from ``start_stage`` on, each
    in ``<outdir>/<stage name>`` and finetuning from the previous stage's
    best snapshot; returns the last stage's state."""
    from cips3d_tpu_torch.train.loop import train

    stages = stages or FFHQ_STAGES
    base_outdir = loop_cfg.outdir
    prev_best: Optional[str] = None
    state = None
    for i, stage in enumerate(stages):
        if i < start_stage:
            prev_best = os.path.join(base_outdir, stage.name, "ckptdir", "best_fid")
            continue
        s_train = dataclasses.replace(train_cfg, img_size=stage.img_size,
                                      total_iters=stage.total_iters, **stage.overrides)
        s_gen = dataclasses.replace(gen_cfg, **stage.gen_overrides)
        s_loop = dataclasses.replace(loop_cfg, outdir=os.path.join(base_outdir, stage.name))
        s_disc = dict(disc_kwargs or {})
        s_disc.update(stage.disc_overrides)
        state = train(s_gen, s_train, opts, s_loop, disc_kwargs=s_disc, finetune_dir=prev_best,
                      load_nerf_ema=stage.load_nerf_ema)
        prev_best = os.path.join(s_loop.outdir, "ckptdir", "best_fid")
    return state
