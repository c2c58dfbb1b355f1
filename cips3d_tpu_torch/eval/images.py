"""Image dumps for FID and sampling: counterpart of
`cips3d_tpu/eval/images.py`.

  * `setup_evaluation`: up to N real images at img_size (Lanczos as PIL
    resizes) into ``fid/real``, sharded, kept across calls;
  * `gen_images`: N samples of a (EMA) generator at psi = 1, rendered in
    pixel chunks without gradient (`apps/render.py::render_chunked`);
  * `sample_images`: fixed-pose samples (h_mean = pi/2 + 0.15, no jitter);
  * `save_image_grid`, `to_uint8`: from `utils/image_io.py`.
Images are written as PNG by the port's own encoder.  Random draws come from
a `torch.Generator` seeded per batch (the JAX package folds its key the same
way, so the two packages draw different but equally distributed samples).
"""

from __future__ import annotations

import dataclasses
import math
import os
import shutil
from typing import Optional

import torch

from cips3d_tpu_torch.utils import image_io
from cips3d_tpu_torch.utils.image_io import save_image_grid, to_uint8  # noqa: F401

__all__ = ["setup_evaluation", "gen_images", "sample_images", "save_image_grid", "to_uint8"]


def setup_evaluation(dataset, real_dir: str, num_imgs: int, img_size: int,
                     del_existing: bool = False, shard_index: int = 0,
                     num_shards: int = 1) -> int:
    """Dump real images for FID; does nothing when already populated."""
    if del_existing and os.path.isdir(real_dir) and shard_index == 0:
        shutil.rmtree(real_dir)
    os.makedirs(real_dir, exist_ok=True)
    existing = len(os.listdir(real_dir))
    if existing >= num_imgs // max(1, num_shards):
        return existing
    count = 0
    for i in range(shard_index, min(num_imgs, len(dataset)), num_shards):
        img = dataset[i][0].transpose(1, 2, 0)
        if img.shape[0] != img_size:
            img = image_io.resize_lanczos(img, img_size, img_size)
        image_io.write_png(os.path.join(real_dir, f"real_{i:06d}.png"), img)
        count += 1
    return count


@torch.no_grad()
def _render(generator, zs, opts, rng, forward_points):
    from cips3d_tpu_torch.apps.render import render_chunked

    styles = generator.mapping(zs["z_nerf"], zs["z_inr"])
    return render_chunked(generator, styles, opts, rng,
                          forward_points or opts.img_size ** 2)


def gen_images(generator, fake_dir: str, num_imgs: int, img_size: int, batch_size: int = 16,
               num_steps: int = 12, opts=None, seed: int = 0, shard_index: int = 0,
               num_shards: int = 1, forward_points: Optional[int] = 256 ** 2) -> int:
    """Sample ``num_imgs`` images of ``generator`` into ``fake_dir``; host
    k of n writes indices k, k + n, ..."""
    from cips3d_tpu_torch.models.generator import RenderOptions, sample_zs

    os.makedirs(fake_dir, exist_ok=True)
    opts = dataclasses.replace(opts or RenderOptions(), img_size=img_size, num_steps=num_steps,
                               psi=1.0)
    dev = generator.device
    written, idx = 0, shard_index
    n_local = (num_imgs - shard_index + num_shards - 1) // num_shards
    for step in range((n_local + batch_size - 1) // batch_size):
        rng = torch.Generator(dev).manual_seed(seed * 1000003 + shard_index * 100003 + step)
        zs = sample_zs(batch_size, generator.cfg, rng, device=dev)
        imgs = _render(generator, zs, opts, rng, forward_points).float().cpu().numpy()
        for img in imgs:
            if written >= n_local:
                break
            image_io.write_png(os.path.join(fake_dir, f"fake_{idx:06d}.png"), to_uint8(img))
            idx += num_shards
            written += 1
    return written


def sample_images(generator, out_dir: str, num_imgs: int, img_size: int, batch_size: int = 16,
                  num_steps: int = 12, seed: int = 0) -> int:
    """Fixed-pose samples: h_mean = pi/2 + 0.15, zero stddev."""
    from cips3d_tpu_torch.models.generator import RenderOptions, sample_zs

    os.makedirs(out_dir, exist_ok=True)
    opts = RenderOptions(img_size=img_size, num_steps=num_steps, h_stddev=0.0, v_stddev=0.0,
                         h_mean=math.pi * 0.5 + 0.15, psi=1.0)
    dev = generator.device
    written = 0
    for step in range((num_imgs + batch_size - 1) // batch_size):
        rng = torch.Generator(dev).manual_seed(seed * 1000003 + step)
        zs = sample_zs(batch_size, generator.cfg, rng, device=dev)
        imgs = _render(generator, zs, opts, rng, None).float().cpu().numpy()
        for img in imgs:
            if written >= num_imgs:
                break
            image_io.write_png(os.path.join(out_dir, f"{written:06d}.png"), to_uint8(img))
            written += 1
    return written
