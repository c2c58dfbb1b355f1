"""Training step of the pi-GAN baseline: counterpart of
`cips3d_tpu/train/pigan_step.py`.

  * top-k GAN: the G loss keeps the ceil(max(0.99^(step / interval),
    topk_v) * n) largest logits; ``frac`` and ``k`` are float32 tensors, as
    the JAX step traces them, so ``k`` cannot differ where ``frac * n``
    lies near an integer;
  * identity penalty: the encoder D predicts the latent and the pose; their
    MSE against the true z (``z_lambda``) and pitch/yaw (``pos_lambda``)
    joins both losses.
R1 applies to D's logit alone.  Every random number of a step can be passed
in as one `PiGANStepDraws`; without it the step draws from a
`torch.Generator`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from cips3d_tpu_torch.core.ema import ema_copy, ema_update
from cips3d_tpu_torch.models.generator import RenderOptions
from cips3d_tpu_torch.models.pigan import PiGANDraws
from cips3d_tpu_torch.train import losses
from cips3d_tpu_torch.train.schedules import alpha_schedule, nerf_noise_schedule
from cips3d_tpu_torch.train.state import (TrainConfig, TrainState, apply_grads, clip_and_guard,
                                          make_optimizers)
from cips3d_tpu_torch.train.step import _grads


def topk_logit_loss(logits: torch.Tensor, step, topk_interval: int,
                    topk_v: float) -> torch.Tensor:
    """mean of softplus(-logit) over the top k = ceil(max(0.99^(step /
    interval), topk_v) * n) logits (n, 1), in float32."""
    n = logits.shape[0]
    f32 = dict(dtype=torch.float32, device=logits.device)
    ratio = torch.as_tensor(step, dtype=torch.int32, device=logits.device) / topk_interval
    frac = torch.maximum(torch.pow(torch.tensor(0.99, **f32), ratio), torch.tensor(topk_v, **f32))
    k = torch.ceil(frac * n)
    sorted_desc = torch.sort(logits, dim=0, descending=True).values
    mask = (torch.arange(n, device=logits.device)[:, None] < k).to(logits.dtype)
    return (F.softplus(-sorted_desc) * mask).sum() / torch.clamp(k, min=1.0)


def identity_penalty(pred_latent, pred_position, z, positions, z_lambda: float,
                     pos_lambda: float):
    """z_lambda * MSE(latent, z) + pos_lambda * MSE(position, pitch_yaw)."""
    pen = 0.0
    if z_lambda > 0 and pred_latent is not None:
        pen = pen + z_lambda * ((pred_latent - z) ** 2).mean()
    if pos_lambda > 0 and pred_position is not None:
        pen = pen + pos_lambda * ((pred_position - positions) ** 2).mean()
    return pen


@dataclasses.dataclass(frozen=True)
class PiGANTrainConfig(TrainConfig):
    """The curriculum keys of the pi-GAN loop."""

    topk_interval: int = 2000
    topk_v: float = 0.6
    z_lambda: float = 0.0
    pos_lambda: float = 15.0


class PiGANPhaseDraws(NamedTuple):
    z: torch.Tensor         # (b, z_dim) latents
    forward: PiGANDraws     # the generator's draws


class PiGANStepDraws(NamedTuple):
    d: PiGANPhaseDraws
    g: PiGANPhaseDraws


def make_pigan_train_step(generator, discriminator, cfg: PiGANTrainConfig, opts: RenderOptions):
    """One D + G + EMA step of `ImplicitGenerator3d` against
    `ProgressiveDiscriminator`: ``step(state, real_imgs, draws=None,
    rng=None) -> (state, metrics)``, updating the state in place."""

    def render_opts(step):
        return dataclasses.replace(opts, img_size=cfg.img_size,
                                   nerf_noise=nerf_noise_schedule(step, cfg.nerf_noise_disable))

    def latents(b, pd, rng, dev):
        if pd:
            return pd.z
        return torch.randn((b, generator.z_dim), generator=rng, device=dev)

    def step_fn(state: TrainState, real_imgs: torch.Tensor,
                draws: Optional[PiGANStepDraws] = None, rng: Optional[torch.Generator] = None):
        if real_imgs.dtype == torch.uint8:
            real_imgs = real_imgs.float() / 127.5 - 1.0
        step = state.step
        alpha = alpha_schedule(step, cfg.warmup_d, cfg.fade_steps)
        ropts = render_opts(step)
        b, dev = real_imgs.shape[0], real_imgs.device
        G, D = generator, discriminator

        # ---------------- D phase ----------------
        pd = draws.d if draws else None
        z = latents(b, pd, rng, dev)
        with torch.no_grad():
            fake, fake_pos = G(z, ropts, rng, draws=pd.forward if pd else None)
        if cfg.r1_lambda > 0:
            penalty, real_logits = losses.r1_penalty(lambda x: D(x, alpha)[0], real_imgs,
                                                     cfg.r1_lambda, cfg.d_reg_every)
        else:
            real_logits = D(real_imgs, alpha)[0]
            penalty = torch.zeros_like(real_logits)
        fake_logits, pred_latent, pred_position = D(fake, alpha)
        d_id = identity_penalty(pred_latent, pred_position, z, fake_pos, cfg.z_lambda,
                                cfg.pos_lambda)
        d_loss = (F.softplus(fake_logits).mean() + F.softplus(-real_logits).mean()
                  + penalty.mean() + d_id)
        d_params = list(D.parameters())
        d_grads, d_norm, d_finite = clip_and_guard(_grads(d_loss, d_params), cfg.grad_clip)
        apply_grads(state.d_opt, d_params, d_grads)

        # ---------------- G phase ----------------
        pg = draws.g if draws else None
        z = latents(b, pg, rng, dev)
        fake, fake_pos = G(z, ropts, rng, draws=pg.forward if pg else None)
        fake_logits, pred_latent, pred_position = D(fake.float(), alpha)
        gan = (topk_logit_loss(fake_logits, step, cfg.topk_interval, cfg.topk_v)
               if cfg.topk_v > 0 else F.softplus(-fake_logits).mean())
        g_loss = gan + identity_penalty(pred_latent, pred_position, z, fake_pos, cfg.z_lambda,
                                        cfg.pos_lambda)
        g_params = list(G.parameters())
        g_grads, g_norm, g_finite = clip_and_guard(_grads(g_loss, g_params), cfg.grad_clip)
        apply_grads(state.g_opt, g_params, g_grads)

        ema_update(state.ema, G, step, cfg.ema_decay, cfg.ema_start_itr)
        state.step = step + 1
        with torch.no_grad():
            metrics = {"d_loss": d_loss, "grad_penalty": penalty.mean(),
                       "identity_penalty": torch.as_tensor(d_id), "g_loss": g_loss,
                       "d_total_norm": d_norm, "g_total_norm": g_norm,
                       "d_finite": d_finite.float(), "g_finite": g_finite.float()}
        return state, {k: float(v.detach()) for k, v in metrics.items()}

    return step_fn


def init_pigan_state(generator, discriminator, cfg: PiGANTrainConfig) -> TrainState:
    """The state at step 0: the modules as built, an EMA copy of G, fresh
    Adam states."""
    g_opt, d_opt = make_optimizers(cfg, generator, discriminator)
    return TrainState(step=0, generator=generator, discriminator=discriminator,
                      ema=ema_copy(generator), g_opt=g_opt, d_opt=d_opt)
