"""Generator loading: counterpart of `cips3d_tpu/eval/cli.py::load_generator`
and of its ``--serving`` config."""

from __future__ import annotations

import dataclasses

import torch

from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR
from cips3d_tpu_torch.utils.checkpoint import load_snapshot_module
from cips3d_tpu_torch.utils.convert import load_jax_params


def load_generator(ckpt_dir: str, gen_cfg: GeneratorConfig, module: str = "G_ema",
                   device="cuda", dtype=torch.float32) -> GeneratorNerfINR:
    """A generator with the weights of a JAX-package snapshot directory
    (``.../ckptdir/best_fid``), on ``device``, in eval mode."""
    gen = GeneratorNerfINR(gen_cfg, dtype=dtype)
    load_jax_params(gen, load_snapshot_module(ckpt_dir, module))
    return gen.to(device).eval()


def serving_config(gen_cfg: GeneratorConfig = GeneratorConfig(),
                   fast_sin: bool = True) -> GeneratorConfig:
    """The serving flags on ``gen_cfg``: both forward kernels (ray tile and
    INR tile), with the polynomial sine unless ``fast_sin`` is False."""
    return dataclasses.replace(gen_cfg, fused_ray=True, fused_inr=True, fast_sin=fast_sin)
