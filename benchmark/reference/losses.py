"""GAN losses: counterpart of `cips3d_tpu/train/losses.py`.

Non-saturating logistic losses and the R1 penalty, which takes the gradient
of D with respect to the real images with ``create_graph=True`` so that the
D step differentiates the penalty again (a gradient of a gradient).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def d_logistic_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    """softplus(D(fake)) + softplus(-D(real)), per sample."""
    return F.softplus(fake_logits) + F.softplus(-real_logits)


def g_nonsaturating_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    """softplus(-D(G(z))), per sample."""
    return F.softplus(-fake_logits)


def r1_penalty(d_fn, real_imgs: torch.Tensor, r1_lambda: float, d_reg_every: int = 1):
    """Per-sample R1 penalty 0.5 * r1_lambda * d_reg_every * |dD/dx|^2.

    d_fn: images -> logits.  Returns (penalty (b, 1), real logits (b, 1)),
    both differentiable with respect to D's parameters."""
    x = real_imgs.detach().requires_grad_(True)
    logits = d_fn(x)
    (grad,) = torch.autograd.grad(logits.sum(), x, create_graph=True)
    grad_sq = grad.float().pow(2).sum((1, 2, 3))
    return 0.5 * r1_lambda * d_reg_every * grad_sq[:, None] + 0.0 * logits, logits
