"""One adversarial training step: counterpart of `cips3d_tpu/train/step.py`.

  D phase: z -> G forward without gradient (the D-phase generator: the
  ray-tile and INR-tile forward kernels, per the JAX package's auto-pick)
  -> D(real) with R1 -> D(fake) -> logistic loss -> clip + NaN guard ->
  Adam.  With aux regularization the fake batch is [inr | aux] and the real
  batch is doubled, split half/half between the main and the aux D.

  G phase: fresh z -> G forward with gradient (the ray-tile kernel with
  residuals and the residual-mode backward kernel under
  ``fused_ray_vjp='pallas_residual'``, the forward and the recompute-mode
  backward under 'pallas'; the INR decode through `CIPSNet`) -> D(fake)
  -> softplus(-logits) -> clip + NaN guard -> Adam -> EMA.

With DiffAug on in the discriminator, D augments the real batch (the R1
gradient goes through the augmentation) and the fakes of the D phase with
draws of their own, and the fakes of the G phase with a third set, where
the JAX step splits k_da1, k_da2 and k_da.  Under ``fused_ray: false`` the
G phase is autograd through the unfused NeRF stage (`core/volume.py`).

``batch_split`` is a Python loop over microbatches whose gradients and
metrics are averaged.  Every random number of a step can be passed in as
one `StepDraws`; without it the step draws from a `torch.Generator`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from cips3d_tpu_torch.core.ema import ema_copy, ema_update
from cips3d_tpu_torch.models.discriminator import draw_disc_diffaug
from cips3d_tpu_torch.models.generator import (ForwardDraws, GeneratorNerfINR, RenderOptions,
                                               sample_zs)
from cips3d_tpu_torch.train import losses
from cips3d_tpu_torch.train.schedules import alpha_schedule, nerf_noise_schedule
from cips3d_tpu_torch.train.state import (TrainConfig, TrainState, apply_grads, clip_and_guard,
                                          make_optimizers)


class PhaseDraws(NamedTuple):
    """The draws of one microbatch of one phase.  ``diffaug`` is the (main,
    aux) DiffAug draws of D on the fakes, ``diffaug_real`` those on the
    real batch (D phase only); both unused unless D has DiffAug on."""

    zs: Dict[str, torch.Tensor]   # {"z_nerf": (b, z_dim_nerf), "z_inr": (b, z_dim_inr)}
    forward: ForwardDraws         # the generator forward's draws
    diffaug: Optional[tuple] = None
    diffaug_real: Optional[tuple] = None


class StepDraws(NamedTuple):
    """Every random draw of one step: one `PhaseDraws` per microbatch."""

    d: Sequence[PhaseDraws]
    g: Sequence[PhaseDraws]


def _grads(loss: torch.Tensor, params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """d loss / d params; zeros for parameters the loss does not reach."""
    gs = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for g, p in zip(gs, params)]


def make_train_step(generator: GeneratorNerfINR, discriminator, cfg: TrainConfig,
                    opts: RenderOptions, aux_reg: bool, d_regularize: bool = True):
    """The step for one (aux_reg, d_regularize) variant:
    ``step(state, real_imgs, draws=None, rng=None) -> (state, metrics)``.
    The state's modules and optimizers are updated in place."""
    num_points = cfg.img_size ** 2
    grad_points = cfg.grad_points ** 2 if cfg.grad_points else None
    if grad_points is not None and grad_points >= num_points:
        grad_points = None
    # the D-phase generator's kernels (auto-pick of the JAX package): the
    # ray-tile forward under fast_sin or when asked; the INR-tile forward
    fused_dphase = generator.cfg.fast_sin if cfg.fused_dphase is None else cfg.fused_dphase
    overrides = {}
    if fused_dphase and generator.cfg.nerf_hidden_layers >= 1:
        overrides["fused_ray"] = True
    elif cfg.fused_dphase and generator.cfg.nerf_hidden_layers < 1:
        # only the auto-pick may fall back; an explicit request must not
        raise ValueError("fused_dphase=True requires nerf_hidden_layers >= 1 (the ray-tile "
                         "kernel has no depth-0 form); unset it (auto) or use the plain D phase")
    if cfg.fused_dphase_inr and generator.cfg.inr_pre_rgb_dim == 3:
        overrides["fused_inr"] = True
    d_cfg = dataclasses.replace(generator.cfg, **overrides)

    def render_opts(step):
        return dataclasses.replace(opts, img_size=cfg.img_size,
                                   nerf_noise=nerf_noise_schedule(step, cfg.nerf_noise_disable))

    def diffaug_draws(D, x, given, rng):
        """D's DiffAug draws for batch ``x``: the given ones, else drawn
        from ``rng`` when D augments, else None."""
        if given is not None or not D.main_disc.diffaug:
            return given
        return draw_disc_diffaug(x.shape[0], x.shape[-1], aux_reg, rng, x.device)

    def d_microbatch(state, real, ropts, alpha, pd, rng):
        G, D = state.generator, state.discriminator
        zs = pd.zs if pd else sample_zs(real.shape[0], G.cfg, rng, cfg.z_dist, real.device)
        with torch.no_grad():
            fake, _ = G(zs, ropts, rng, return_aux_img=aux_reg,
                        draws=pd.forward if pd else None, cfg=d_cfg)
        if aux_reg:
            real = torch.cat([real, real], 0)
        da_real = diffaug_draws(D, real, pd.diffaug_real if pd else None, rng)
        da_fake = diffaug_draws(D, fake, pd.diffaug if pd else None, rng)

        def d_apply(x, da):
            return D(x, alpha, use_aux_disc=aux_reg, fade_in=cfg.warmup_d, diffaug=da)

        if d_regularize and cfg.r1_lambda > 0:
            penalty, real_logits = losses.r1_penalty(lambda x: d_apply(x, da_real), real,
                                                     cfg.r1_lambda, cfg.d_reg_every)
        else:
            real_logits = d_apply(real, da_real)
            penalty = torch.zeros_like(real_logits)
        fake_logits = d_apply(fake.float(), da_fake)
        loss = (losses.d_logistic_loss(real_logits, fake_logits) + penalty).mean()
        grads = _grads(loss, list(D.parameters()))
        with torch.no_grad():
            metrics = {
                "d_loss": loss,
                "d_logits_real": real_logits.mean(),
                "d_logits_fake": fake_logits.mean(),
                "d_logits_norm": torch.sqrt((torch.cat([real_logits, fake_logits]) ** 2).mean()),
                "grad_penalty": penalty.mean(),
            }
        return grads, metrics

    def g_microbatch(state, zs, ropts, alpha, pd, rng):
        G, D = state.generator, state.discriminator
        fake, _ = G(zs, ropts, rng, return_aux_img=aux_reg, grad_points=grad_points,
                    draws=pd.forward if pd else None)
        da = diffaug_draws(D, fake, pd.diffaug if pd else None, rng)
        logits = D(fake.float(), alpha, use_aux_disc=aux_reg, fade_in=cfg.warmup_d, diffaug=da)
        loss = losses.g_nonsaturating_loss(logits).mean()
        grads = _grads(loss, list(G.parameters()))
        return grads, {"g_loss": loss.detach(), "g_logits_fake": logits.detach().mean()}

    def accumulate(parts):
        """Average the (grads, metrics) of the microbatches."""
        grads, metrics = parts[0]
        for g_i, m_i in parts[1:]:
            grads = [a + b for a, b in zip(grads, g_i)]
            metrics = {k: metrics[k] + m_i[k] for k in metrics}
        if len(parts) > 1:
            inv = 1.0 / len(parts)
            grads = [g * inv for g in grads]
            metrics = {k: v * inv for k, v in metrics.items()}
        return grads, metrics

    def step_fn(state: TrainState, real_imgs: torch.Tensor,
                draws: Optional[StepDraws] = None, rng: Optional[torch.Generator] = None):
        if real_imgs.dtype == torch.uint8:
            real_imgs = real_imgs.float() / 127.5 - 1.0
        step = state.step
        alpha = alpha_schedule(step, cfg.warmup_d, cfg.fade_steps)
        ropts = render_opts(step)
        n_split = cfg.batch_split
        G, D = state.generator, state.discriminator

        # ---------------- D phase ----------------
        reals = real_imgs.chunk(n_split, 0)
        d_grads, d_metrics = accumulate([
            d_microbatch(state, real, ropts, alpha, draws.d[i] if draws else None, rng)
            for i, real in enumerate(reals)])
        d_grads, d_norm, d_finite = clip_and_guard(d_grads, cfg.grad_clip)
        d_params = list(D.parameters())
        apply_grads(state.d_opt, d_params, d_grads)

        # ---------------- G phase ----------------
        if draws:
            zs_parts = [pd.zs for pd in draws.g]
        else:
            zs = sample_zs(real_imgs.shape[0], G.cfg, rng, cfg.z_dist, real_imgs.device)
            zs_parts = [dict(zip(zs, parts)) for parts in
                        zip(*(v.chunk(n_split, 0) for v in zs.values()))]
        g_grads, g_metrics = accumulate([
            g_microbatch(state, zs_i, ropts, alpha, draws.g[i] if draws else None, rng)
            for i, zs_i in enumerate(zs_parts)])
        g_grads, g_norm, g_finite = clip_and_guard(g_grads, cfg.grad_clip)
        apply_grads(state.g_opt, list(G.parameters()), g_grads)

        # ---------------- EMA ----------------
        ema_update(state.ema, G, step, cfg.ema_decay, cfg.ema_start_itr)
        state.step = step + 1

        with torch.no_grad():
            metrics = dict(d_metrics)
            metrics.update(g_metrics)
            metrics.update({
                "d_total_norm": d_norm,
                "g_total_norm": g_norm,
                "d_w_norm": torch.sqrt(sum((p.float() ** 2).sum() for p in d_params)),
                "d_finite": d_finite.float(),
                "g_finite": g_finite.float(),
            })
            metrics = {k: float(v) for k, v in metrics.items()}
        metrics["alpha"] = float(alpha)
        metrics["nerf_noise"] = ropts.nerf_noise
        return state, metrics

    return step_fn


def init_train_state(generator: GeneratorNerfINR, discriminator, cfg: TrainConfig) -> TrainState:
    """The state at step 0: the modules as initialized (seeded at
    construction, or loaded), an EMA copy of G, fresh Adam states."""
    g_opt, d_opt = make_optimizers(cfg, generator, discriminator)
    return TrainState(step=0, generator=generator, discriminator=discriminator,
                      ema=ema_copy(generator), g_opt=g_opt, d_opt=d_opt)
