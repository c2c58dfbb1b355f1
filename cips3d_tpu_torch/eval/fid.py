"""FID evaluation: feature statistics, the Fréchet distance and KID:
counterpart of `cips3d_tpu/eval/fid.py`.

The metric arithmetic is numpy, as in the JAX package.  The features come
from `default_extractor`: torch-fidelity's InceptionV3 (`eval/inception.py`)
when `find_weights()` finds its checkpoint, else the JAX package's
surrogate written in torch: the same numpy-seeded random filters and
projection over 64 x 64 images (resized as `jax.image.resize(...,
"bilinear")` resizes, antialiased when it shrinks), so both packages score
the same images alike; its metric is labelled ``FID_surrogate``, never FID,
and a reference-comparable FID is refused without the checkpoint.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Iterable, Optional, Tuple

import numpy as np

from cips3d_tpu_torch.utils import image_io


def activation_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of a (n, d) feature matrix."""
    features = np.asarray(features, np.float64)
    return features.mean(axis=0), np.cov(features, rowvar=False)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """|mu1-mu2|^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)), with sqrt(S1 S2) through
    the symmetric PSD product sqrt(S1) S2 sqrt(S1)."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    sigma1 = np.asarray(sigma1, np.float64)
    sigma2 = np.asarray(sigma2, np.float64)
    diff = mu1 - mu2
    w1, v1 = np.linalg.eigh(sigma1)
    s1_half = (v1 * np.sqrt(np.clip(w1, 0, None))) @ v1.T
    m = s1_half @ sigma2 @ s1_half
    tr_sqrt = np.sum(np.sqrt(np.clip(np.linalg.eigvalsh((m + m.T) / 2), 0, None)))
    if not np.isfinite(tr_sqrt):
        offset = np.eye(sigma1.shape[0]) * eps
        return frechet_distance(mu1, sigma1 + offset, mu2, sigma2 + offset, eps)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * tr_sqrt)


def kid_mmd(feat1: np.ndarray, feat2: np.ndarray, subset_size: int = 1000,
            n_subsets: int = 100, seed: int = 0) -> float:
    """Kernel Inception Distance: the unbiased polynomial-kernel MMD^2 over
    random subsets."""
    rng = np.random.default_rng(seed)
    f1, f2 = np.asarray(feat1, np.float64), np.asarray(feat2, np.float64)
    d = f1.shape[1]
    m = min(subset_size, len(f1), len(f2))
    vals = []
    for _ in range(n_subsets):
        x = f1[rng.choice(len(f1), m, replace=False)]
        y = f2[rng.choice(len(f2), m, replace=False)]
        kxx = (x @ x.T / d + 1) ** 3
        kyy = (y @ y.T / d + 1) ** 3
        kxy = (x @ y.T / d + 1) ** 3
        np.fill_diagonal(kxx, 0)
        np.fill_diagonal(kyy, 0)
        vals.append(kxx.sum() / (m * (m - 1)) + kyy.sum() / (m * (m - 1)) - 2 * kxy.mean())
    return float(np.mean(vals))


def iter_image_dir(path: str, batch_size: int = 64) -> Iterable[np.ndarray]:
    """(b, H, W, 3) uint8 batches of a directory's PNGs, in name order."""
    files = sorted(os.path.join(path, f) for f in os.listdir(path) if f.lower().endswith(".png"))
    batch = []
    for f in files:
        batch.append(image_io.to_rgb(image_io.read_png(f)))
        if len(batch) == batch_size:
            yield np.stack(batch)
            batch = []
    if batch:
        yield np.stack(batch)


def extract_dir_features(path: str, extractor: Callable, batch_size: int = 64) -> np.ndarray:
    feats = [np.asarray(extractor(b)) for b in iter_image_dir(path, batch_size)]
    if not feats:
        raise ValueError(f"no images in {path}")
    return np.concatenate(feats, axis=0)


def eval_fid(real_dir: str, fake_dir: str, extractor: Optional[Callable] = None,
             kid: bool = False, batch_size: int = 64, require_reference: bool = False,
             device="cuda") -> dict:
    """FID (and optionally KID) between two directories of PNGs, named
    after the extractor (``FID`` for InceptionV3, ``FID_surrogate`` for the
    surrogate); without ``extractor``, `default_extractor` on ``device``."""
    if extractor is None:
        extractor = default_extractor(device=device)
    name = getattr(extractor, "metric_name", "FID")
    if require_reference and name != "FID":
        raise RuntimeError(NO_REFERENCE)
    real = extract_dir_features(real_dir, extractor, batch_size)
    fake = extract_dir_features(fake_dir, extractor, batch_size)
    out = {name: frechet_distance(*activation_statistics(real), *activation_statistics(fake))}
    if kid:
        out[name.replace("FID", "KID")] = kid_mmd(real, fake)
    return out


NO_REFERENCE = ("reference-comparable FID requested but InceptionV3 weights are unavailable "
                "(set $CIPS3D_INCEPTION_WEIGHTS); refusing to report a surrogate metric as FID")


def default_extractor(require_reference: bool = False, device="cuda") -> Callable:
    """InceptionV3 pool3 features on ``device`` when `inception.find_weights()`
    finds the checkpoint; otherwise the surrogate (relative tracking only),
    or with ``require_reference`` a RuntimeError."""
    from cips3d_tpu_torch.eval import inception

    weights = inception.find_weights()
    if weights is not None:
        return inception.InceptionV3Features(weights, device=device)
    if require_reference:
        raise RuntimeError(NO_REFERENCE)
    return surrogate_extractor()


def _same_pad(n: int, k: int = 3, stride: int = 2) -> Tuple[int, int]:
    """XLA's 'SAME' padding of one axis: (before, after)."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


@functools.lru_cache(maxsize=4)
def surrogate_extractor(dim: int = 256, seed: int = 0) -> Callable:
    """Random-CNN texture statistics (relative tracking only): 64 x 64
    images through 4 fixed random 3x3 stride-2 convs ('SAME' padding, leaky
    ReLU 0.2), the per-channel mean and std at every scale, projected to
    ``dim`` features.  The filters and the projection come from
    ``np.random.default_rng(seed)`` in the JAX package's order.  Runs on
    the CPU in f32."""
    import torch
    import torch.nn.functional as F

    from cips3d_tpu_torch.models.discriminator import resize_bilinear

    rng = np.random.default_rng(seed)
    widths = (32, 64, 128, 256)
    filters, cin = [], 3
    for w in widths:
        f = rng.standard_normal((3, 3, cin, w)).astype(np.float32) * np.sqrt(2.0 / (9 * cin))
        filters.append(torch.from_numpy(np.ascontiguousarray(  # HWIO -> OIHW
            f.astype(np.float32).transpose(3, 2, 0, 1))))
        cin = w
    raw_dim = 2 * sum(widths)
    proj = torch.from_numpy((rng.standard_normal((raw_dim, dim)).astype(np.float32)
                             / np.sqrt(raw_dim)).astype(np.float32))

    @torch.no_grad()
    def extract(batch_u8: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(batch_u8.astype(np.float32) / 255.0).permute(0, 3, 1, 2)
        h = resize_bilinear(x, 64)
        stats = []
        for f in filters:
            h = F.conv2d(F.pad(h, _same_pad(h.shape[3]) + _same_pad(h.shape[2])), f, stride=2)
            h = F.leaky_relu(h, 0.2)
            stats.append(h.mean((2, 3)))
            stats.append(h.std((2, 3), unbiased=False))
        return (torch.cat(stats, -1) @ proj).numpy()

    extract.metric_name = "FID_surrogate"
    return extract
