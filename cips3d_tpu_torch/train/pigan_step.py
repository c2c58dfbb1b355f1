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
`torch.Generator`.  With a `parallel.mesh.Mesh` (1-D) the step is one
rank's, as the flagship's (`train/step.py`); the top-k loss takes its k
largest of every rank's logits (`gather_rows`), as the JAX step takes them
of the global batch.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from cips3d_tpu_torch.core.ema import ema_copy, ema_update
from cips3d_tpu_torch.models.generator import RenderOptions
from cips3d_tpu_torch.models.pigan import PiGANDraws, draw_pigan
from cips3d_tpu_torch.parallel.mesh import Mesh, all_reduce_mean_flat, gather_rows, shard_batch
from cips3d_tpu_torch.train import losses
from cips3d_tpu_torch.train.schedules import alpha_schedule, nerf_noise_schedule
from cips3d_tpu_torch.train.state import (TrainConfig, TrainState, advance_step, apply_grads,
                                          clip_and_guard, make_optimizers)
from cips3d_tpu_torch.train.step import _grads, check_mesh, reduce_metrics


@functools.lru_cache(maxsize=None)
def _const(value: float, device: torch.device) -> torch.Tensor:
    """A float32 scalar on ``device``, made once (the first step, before any
    capture) rather than copied from the host every step."""
    return torch.full((), value, dtype=torch.float32, device=device)


def topk_logit_loss(logits: torch.Tensor, step, topk_interval: int,
                    topk_v: float) -> torch.Tensor:
    """mean of softplus(-logit) over the top k = ceil(max(0.99^(step /
    interval), topk_v) * n) logits (n, 1), in float32."""
    n = logits.shape[0]
    ratio = torch.as_tensor(step, device=logits.device).to(torch.int32) / topk_interval
    frac = torch.maximum(torch.pow(_const(0.99, logits.device), ratio),
                         _const(topk_v, logits.device))
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


def draw_pigan_step(z_dim: int, opts: RenderOptions, batch: int,
                    rng: Optional[torch.Generator], device) -> PiGANStepDraws:
    """Every draw of one step at ``batch`` rows (``opts`` at the step's
    size and density noise)."""
    def phase():
        return PiGANPhaseDraws(torch.randn((batch, z_dim), generator=rng, device=device),
                               draw_pigan(batch, opts, rng, device))

    return PiGANStepDraws(phase(), phase())


def make_pigan_train_step(generator, discriminator, cfg: PiGANTrainConfig, opts: RenderOptions,
                          mesh: Optional[Mesh] = None):
    """One D + G + EMA step of `ImplicitGenerator3d` against
    `ProgressiveDiscriminator`: ``step(state, real_imgs, draws=None,
    rng=None) -> (state, metrics)``, updating the state in place (the
    metrics 0-d float32 tensors on the device, the counter and the schedules too, as
    in `train/step.py`).  With
    ``mesh`` the step is one rank's and ``draws`` those of the global
    batch."""
    check_mesh(mesh, discriminator)

    def render_opts(step):
        return dataclasses.replace(opts, img_size=cfg.img_size,
                                   nerf_noise=nerf_noise_schedule(step, cfg.nerf_noise_disable))

    def latents(b, pd, rng, dev):
        if pd:
            return pd.z
        return torch.randn((b, generator.z_dim), generator=rng, device=dev)

    def step_fn(state: TrainState, real_imgs: torch.Tensor,
                draws: Optional[PiGANStepDraws] = None, rng: Optional[torch.Generator] = None):
        # the default (NCHW) layout whatever the batch's strides: a stack of HWC images
        # is channels-last, which the convolutions would round otherwise
        real_imgs = real_imgs.contiguous()
        if real_imgs.dtype == torch.uint8:
            real_imgs = real_imgs.float() / 127.5 - 1.0
        step = state.step_t
        alpha = alpha_schedule(step, cfg.warmup_d, cfg.fade_steps)
        ropts = render_opts(step)
        b, dev = real_imgs.shape[0], real_imgs.device
        G, D = generator, discriminator
        if mesh is not None:
            if draws is None:
                draws = draw_pigan_step(G.z_dim, ropts, b * mesh.world, rng, dev)
            draws = shard_batch(draws, mesh.rank * b, (mesh.rank + 1) * b, b * mesh.world)

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
        d_grads = _grads(d_loss, d_params)
        if mesh is not None:
            d_grads = all_reduce_mean_flat(d_grads, mesh)
        d_grads, d_norm, d_finite = clip_and_guard(d_grads, cfg.grad_clip)
        apply_grads(state.d_opt, d_params, d_grads)

        # ---------------- G phase ----------------
        pg = draws.g if draws else None
        z = latents(b, pg, rng, dev)
        fake, fake_pos = G(z, ropts, rng, draws=pg.forward if pg else None)
        fake_logits, pred_latent, pred_position = D(fake.float(), alpha)
        if cfg.topk_v > 0:
            all_logits = fake_logits if mesh is None else gather_rows(fake_logits, mesh)
            gan = topk_logit_loss(all_logits, step, cfg.topk_interval, cfg.topk_v)
        else:
            gan = F.softplus(-fake_logits).mean()
        g_loss = gan + identity_penalty(pred_latent, pred_position, z, fake_pos, cfg.z_lambda,
                                        cfg.pos_lambda)
        g_params = list(G.parameters())
        g_grads = _grads(g_loss, g_params)
        if mesh is not None:
            g_grads = all_reduce_mean_flat(g_grads, mesh)
        g_grads, g_norm, g_finite = clip_and_guard(g_grads, cfg.grad_clip)
        apply_grads(state.g_opt, g_params, g_grads)

        ema_update(state.ema, G, step, cfg.ema_decay, cfg.ema_start_itr)
        advance_step(state)
        with torch.no_grad():
            metrics = {"d_loss": d_loss, "grad_penalty": penalty.mean(),
                       "identity_penalty": d_id if torch.is_tensor(d_id)
                       else torch.zeros((), device=dev), "g_loss": g_loss}
            if mesh is not None:
                metrics = reduce_metrics(metrics, mesh)
            metrics.update({"d_total_norm": d_norm, "g_total_norm": g_norm,
                            "d_finite": d_finite.float(), "g_finite": g_finite.float()})
        return state, {k: v.detach().float() for k, v in metrics.items()}

    return step_fn


def init_pigan_state(generator, discriminator, cfg: PiGANTrainConfig) -> TrainState:
    """The state at step 0: the modules as built, an EMA copy of G, fresh
    Adam states."""
    g_opt, d_opt = make_optimizers(cfg, generator, discriminator)
    return TrainState(step=0, generator=generator, discriminator=discriminator,
                      ema=ema_copy(generator), g_opt=g_opt, d_opt=d_opt)
