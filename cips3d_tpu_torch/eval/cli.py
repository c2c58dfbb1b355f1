"""Generator loading: counterpart of `cips3d_tpu/eval/cli.py::load_generator`."""

from __future__ import annotations

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
