"""Pixel-axis gather/scatter for partial-gradient rendering: counterpart of
`cips3d_tpu/core/points.py` (`gather_points`, `scatter_points`).

Gradients flow through a random subset of pixels; the rest are rendered
without gradient and scattered back into the full image (`grad_points`).
"""

from __future__ import annotations

import torch


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather along the pixel axis (dim 1) of (b, n, c) or (b, n, s, c);
    ``idx`` (k,) is shared across the batch."""
    return points.index_select(1, idx)


def scatter_points(idx_grad: torch.Tensor, points_grad: torch.Tensor,
                   idx_no_grad: torch.Tensor, points_no_grad: torch.Tensor,
                   num_points: int) -> torch.Tensor:
    """Merge the two pixel subsets back into a dense (b, num_points, c)
    tensor; differentiable with respect to ``points_grad``."""
    b, _, c = points_grad.shape
    out = points_grad.new_zeros((b, num_points, c))
    out = out.index_copy(1, idx_grad, points_grad)
    return out.index_copy(1, idx_no_grad, points_no_grad)
