"""The plain adversarial training step of CIPS-3D: the discriminator phase
(fakes from G without gradient, D on the real batch with R1, D on the
fakes, the logistic loss), then the generator phase (fresh latents, G with
gradient, D on its fakes, the non-saturating loss), each phase's gradient
clipped to a global norm and applied by Adam, then the generator's EMA.

Written from the published recipe (StyleGAN2's losses and R1, DiffAug on
D's inputs, the aux discriminator on the NeRF's aux images, the fade-in of
D's half-resolution head) in float32 autograd, with Adam's update written
out.  Every random draw comes from one `torch.Generator`, in this order a
step: the D phase's latents, its forward's draws, D's DiffAug draws of the
real batch and of the fakes; the G phase's latents, its forward's draws,
D's DiffAug draws of its fakes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch

from . import losses
from .discriminator import DiscriminatorMultiScaleAux, draw_disc_diffaug
from .generator import Generator, RenderOptions, draw_ray_randoms, sample_zs, uses_noise
from .rays import draw_camera


@dataclasses.dataclass(frozen=True)
class StepSettings:
    img_size: int
    batch_size: int
    gen_lr: float
    disc_lr: float
    beta1: float
    beta2: float
    r1_lambda: float
    d_reg_every: int
    grad_clip: float
    aux_reg: bool
    warmup_d: bool
    fade_steps: int
    nerf_noise_disable: bool
    ema_decay: float
    ema_start_itr: int
    grad_points: int = 0   # the G phase's gradient pixels; 0: all of them


def _f32(x: float) -> float:
    return float(np.float32(x))


def alpha(step: int, s: StepSettings) -> torch.Tensor:
    """D's fade-in: min(1, step / fade_steps) under warmup_d, else 1."""
    if not s.warmup_d:
        return torch.ones(())
    return torch.clamp(torch.tensor(step, dtype=torch.float64) * _f32(1.0 / s.fade_steps),
                       max=1.0).float()


def nerf_noise(step: int, s: StepSettings) -> torch.Tensor:
    """The density noise: max(0, 1 - step / 5000), 0 when disabled."""
    if s.nerf_noise_disable:
        return torch.zeros(())
    return torch.clamp((1.0 - torch.tensor(step, dtype=torch.float64) * _f32(1.0 / 5000.0))
                       .float(), min=0.0)


class Adam:
    """Adam as its paper writes it, with the bias corrections folded into
    the step size and the denominator."""

    def __init__(self, params: List[torch.Tensor], lr: float, beta1: float, beta2: float,
                 eps: float = 1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, beta1, beta2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr / bc1 * m / (v.sqrt() / math.sqrt(bc2) + self.eps))


def clip(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """Scale to a global norm of at most ``max_norm``; zeros if it is not finite."""
    norm = torch.sqrt(sum(g.pow(2).sum() for g in grads))
    if not torch.isfinite(norm):
        return [torch.zeros_like(g) for g in grads]
    coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return [g * coef for g in grads]


def _grads(loss, params):
    gs = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for g, p in zip(gs, params)]


class Trainer:
    """G, D, G's EMA and the two Adams, stepped one step at a time."""

    def __init__(self, G: Generator, D: DiscriminatorMultiScaleAux, s: StepSettings,
                 opts: RenderOptions):
        self.G, self.D, self.s = G, D, s
        self.opts = dataclasses.replace(opts, img_size=s.img_size)
        self.ema = [p.detach().clone() for p in G.parameters()]
        self.g_opt = Adam(list(G.parameters()), s.gen_lr, s.beta1, s.beta2)
        self.d_opt = Adam(list(D.parameters()), s.disc_lr, s.beta1, s.beta2)
        self.t = 0

    def _phase_draws(self, b: int, rng, dev, opts: RenderOptions, real: bool) -> dict:
        """One phase's draws up front, in the order of a data-parallel step
        that draws the global batch on every rank: latents, depth jitter,
        camera, ray draws, D's DiffAug draws of the fakes, of the reals."""
        s = self.s
        n, steps = s.img_size ** 2, opts.num_steps
        zs = sample_zs(b, self.G.cfg, rng, dev)
        perturb = torch.rand((b, n, steps, 1), generator=rng, device=dev)
        camera = draw_camera(b, opts.sample_dist, rng, dev)
        rays = draw_ray_randoms(b, n, steps, uses_noise(opts.nerf_noise), rng, dev,
                                hierarchical=opts.hierarchical_sample)
        rows = b * (2 if s.aux_reg else 1)

        def disc():
            if not self.D.main_disc.diffaug:
                return None
            return draw_disc_diffaug(rows, s.img_size, s.aux_reg, rng, dev)

        return {"zs": zs, "forward": {"perturb": perturb, "camera": camera, "rays": rays},
                "diffaug": disc(), "diffaug_real": disc() if real else None}

    def step(self, real_u8: torch.Tensor, rng: torch.Generator,
             draws_up_front: bool = False) -> Dict[str, float]:
        """One step on ``real_u8``.  The draws come from ``rng`` as the step
        needs them, or with ``draws_up_front`` all of a phase first (the
        data-parallel program's order)."""
        s, G, D = self.s, self.G, self.D
        dev = real_u8.device
        real = real_u8.contiguous().float() / 127.5 - 1.0
        a = alpha(self.t, s).to(dev)
        opts = dataclasses.replace(self.opts, nerf_noise=nerf_noise(self.t, s).to(dev))
        b = real.shape[0]
        grad_points = s.grad_points ** 2 if s.grad_points else None

        def d_apply(x, da):
            return D(x, a, use_aux_disc=s.aux_reg, fade_in=s.warmup_d, diffaug=da)

        # D phase
        if draws_up_front:
            pd = self._phase_draws(b, rng, dev, opts, real=True)
            pg = self._phase_draws(b, rng, dev, opts, real=False)
            with torch.no_grad():
                fake = G(pd["zs"], opts, None, return_aux_img=s.aux_reg, draws=pd["forward"])
            if s.aux_reg:
                real = torch.cat([real, real], 0)
            da_real, da_fake = pd["diffaug_real"], pd["diffaug"]
        else:
            zs = sample_zs(b, G.cfg, rng, dev)
            with torch.no_grad():
                fake = G(zs, opts, rng, return_aux_img=s.aux_reg)
            if s.aux_reg:
                real = torch.cat([real, real], 0)
            da_real = (draw_disc_diffaug(real.shape[0], s.img_size, s.aux_reg, rng, dev)
                       if D.main_disc.diffaug else None)
            da_fake = (draw_disc_diffaug(fake.shape[0], s.img_size, s.aux_reg, rng, dev)
                       if D.main_disc.diffaug else None)
        if s.r1_lambda > 0:
            penalty, real_logits = losses.r1_penalty(lambda x: d_apply(x, da_real), real,
                                                     s.r1_lambda, s.d_reg_every)
        else:
            real_logits, penalty = d_apply(real, da_real), torch.zeros(())
        fake_logits = d_apply(fake.float(), da_fake)
        d_loss = (losses.d_logistic_loss(real_logits, fake_logits) + penalty).mean()
        d_grads = clip(_grads(d_loss, list(D.parameters())), s.grad_clip)
        self.d_opt.step(d_grads)

        # G phase
        if draws_up_front:
            fake = G(pg["zs"], opts, None, return_aux_img=s.aux_reg, draws=pg["forward"])
            da = pg["diffaug"]
        else:
            zs = sample_zs(b, G.cfg, rng, dev)
            fake = G(zs, opts, rng, return_aux_img=s.aux_reg, grad_points=grad_points)
            da = (draw_disc_diffaug(fake.shape[0], s.img_size, s.aux_reg, rng, dev)
                  if D.main_disc.diffaug else None)
        logits = D(fake.float(), a, use_aux_disc=s.aux_reg, fade_in=s.warmup_d, diffaug=da)
        g_loss = losses.g_nonsaturating_loss(logits).mean()
        g_grads = clip(_grads(g_loss, list(G.parameters())), s.grad_clip)
        self.g_opt.step(g_grads)

        # EMA from ema_start_itr on
        if self.t >= s.ema_start_itr:
            with torch.no_grad():
                for e, p in zip(self.ema, G.parameters()):
                    e.mul_(s.ema_decay).add_(p, alpha=1 - s.ema_decay)
        self.t += 1
        return {"d_loss": d_loss.item(), "g_loss": g_loss.item(),
                "grad_penalty": penalty.mean().item()}
