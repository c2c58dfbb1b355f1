"""Training state and optimizers: counterpart of `cips3d_tpu/train/state.py`.

Adam with betas (0, 0.999) and eps 1e-8, G lr 2e-4, D lr 2e-3; the
gradient is clipped to a global norm of 10 before Adam, and a non-finite
norm zeroes it (the step then only decays Adam's moments); generator EMA
with decay 0.999 from step 1000.  `torch.optim.Adam` computes optax's Adam
update (tests/test_torch_train.py holds the two against each other).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters of the adversarial loop (same fields and defaults as
    the JAX package)."""

    img_size: int = 32
    batch_size: int = 4
    batch_split: int = 1
    gen_lr: float = 2e-4
    disc_lr: float = 2e-3
    beta1: float = 0.0
    beta2: float = 0.999
    r1_lambda: float = 10.0
    d_reg_every: int = 1
    grad_clip: float = 10.0
    train_aux_img: bool = True
    update_aux_every: int = 1
    grad_points: Any = 256       # sqrt of the pixel cap of the G phase; None disables
    forward_points: Any = 256    # sqrt of the inference chunk size; None disables
    diffaug: bool = False
    warmup_d: bool = False
    fade_steps: int = 10000
    nerf_noise_disable: bool = False
    ema_decay: float = 0.999
    ema_start_itr: int = 1000
    total_iters: int = 200000
    z_dist: str = "gaussian"
    # D-phase fake generation through the ray-tile kernel: None = on iff the
    # generator uses fast_sin (the JAX package's auto-pick)
    fused_dphase: Any = None
    # D-phase INR decode through the INR-tile kernel (forward only)
    fused_dphase_inr: bool = True


@dataclasses.dataclass
class TrainState:
    """What one step reads and updates: G, D and the EMA copy of G (their
    parameters), the two optimizers and the step counter."""

    step: int
    generator: nn.Module
    discriminator: nn.Module
    ema: nn.Module
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer


def make_optimizers(cfg: TrainConfig, generator: nn.Module,
                    discriminator: nn.Module) -> Tuple[torch.optim.Adam, torch.optim.Adam]:
    g_opt = torch.optim.Adam(generator.parameters(), lr=cfg.gen_lr,
                             betas=(cfg.beta1, cfg.beta2), eps=1e-8)
    d_opt = torch.optim.Adam(discriminator.parameters(), lr=cfg.disc_lr,
                             betas=(cfg.beta1, cfg.beta2), eps=1e-8)
    return g_opt, d_opt


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum(g.float().pow(2).sum() for g in grads))


def clip_and_guard(grads: Sequence[torch.Tensor], max_norm: float):
    """torch-style clip_grad_norm_ (coef = min(1, max / (norm + 1e-6))) with
    a NaN guard: a non-finite norm gives zeros, by select (nan * 0 is nan).
    Returns (clipped grads, norm, finite)."""
    norm = global_norm(grads)
    finite = torch.isfinite(norm)
    coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    clipped: List[torch.Tensor] = [torch.where(finite, g * coef, torch.zeros_like(g))
                                   for g in grads]
    return clipped, norm, finite


def apply_grads(opt: torch.optim.Optimizer, params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor]) -> None:
    """One optimizer step with the given gradients."""
    for p, g in zip(params, grads):
        p.grad = g.to(p.dtype)
    opt.step()
    opt.zero_grad(set_to_none=True)
