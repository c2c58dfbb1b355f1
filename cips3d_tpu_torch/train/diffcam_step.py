"""Training step of the differentiable-camera pipeline: counterpart of
`cips3d_tpu/train/diffcam_step.py`.

The flagship's adversarial step (R1, the aux branch, DiffAug, EMA) on
`GeneratorDiffcam.forward_rays`, whose rays come from a learnable
`CamParams` at a random pose.  The G phase's loss reaches the camera; G's
and the camera's gradients are clipped and guarded apart, then three Adams
(G, D, camera) step, then the EMA.  ``g_finite`` reports G and the camera
together.  The step regularises D every step (R1 scaled by
``d_reg_every``), as the JAX step does.  Every random number of a step can
be passed in as one `DiffcamStepDraws`; without it the step draws from a
`torch.Generator`.  With a `parallel.mesh.Mesh` (1-D, as the JAX variant
loop) the step is one rank's, as the flagship's (`train/step.py`): global
draws, the rank's rows, and one all-reduce of D's gradients, one of G's and
the camera's together, one of the metrics.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import torch

from cips3d_tpu_torch.core.ema import ema_copy, ema_update
from cips3d_tpu_torch.core.rays import draw_camera
from cips3d_tpu_torch.models.camera import CamParams
from cips3d_tpu_torch.models.discriminator import draw_disc_diffaug
from cips3d_tpu_torch.models.generator import sample_zs
from cips3d_tpu_torch.models.generator_diffcam import (DiffcamDraws, GeneratorDiffcam,
                                                       NerfKwargs, draw_diffcam)
from cips3d_tpu_torch.parallel.mesh import Mesh, all_reduce_mean_flat, shard_batch
from cips3d_tpu_torch.train import losses
from cips3d_tpu_torch.train.schedules import alpha_schedule, nerf_noise_schedule
from cips3d_tpu_torch.train.state import (TrainConfig, TrainState, advance_step, apply_grads,
                                          clip_and_guard, make_adam, make_optimizers)
from cips3d_tpu_torch.train.step import _grads, check_mesh, reduce_metrics


@dataclasses.dataclass(frozen=True)
class DiffcamTrainConfig(TrainConfig):
    cam_lr: float = 1e-4


@dataclasses.dataclass
class DiffcamTrainState(TrainState):
    """The flagship's state plus the camera and its Adam (None when the
    camera has nothing to learn)."""

    camera: Optional[CamParams] = None
    cam_opt: Optional[torch.optim.Optimizer] = None


class DiffcamPhaseDraws(NamedTuple):
    """The draws of one phase: latents, the camera's pose draws (gaussian
    mode), the generator's draws, and D's DiffAug draws on the fakes
    (``diffaug``) and, in the D phase, on the reals (``diffaug_real``)."""

    zs: Dict[str, torch.Tensor]
    camera: tuple
    forward: DiffcamDraws
    diffaug: Optional[tuple] = None
    diffaug_real: Optional[tuple] = None


class DiffcamStepDraws(NamedTuple):
    d: DiffcamPhaseDraws
    g: DiffcamPhaseDraws


def draw_diffcam_step(gen_cfg, diffaug: bool, cfg: DiffcamTrainConfig, nk: NerfKwargs,
                      aux_reg: bool, batch: int, rng: Optional[torch.Generator],
                      device) -> DiffcamStepDraws:
    """Every draw of one step at ``batch`` rows (D's DiffAug draws when
    ``diffaug``)."""
    def disc():
        if not diffaug:
            return None
        return draw_disc_diffaug(batch * (2 if aux_reg else 1), cfg.img_size, aux_reg, rng, device)

    def phase(real):
        return DiffcamPhaseDraws(sample_zs(batch, gen_cfg, rng, cfg.z_dist, device),
                                 draw_camera(batch, "gaussian", rng, device),
                                 draw_diffcam(batch, cfg.img_size ** 2, nk, rng, device),
                                 disc(), disc() if real else None)

    return DiffcamStepDraws(phase(True), phase(False))


def make_diffcam_train_step(generator: GeneratorDiffcam, discriminator, camera: CamParams,
                            cfg: DiffcamTrainConfig, nerf_kwargs: NerfKwargs,
                            aux_reg: bool = False, mesh: Optional[Mesh] = None):
    """``step(state, real_imgs, draws=None, rng=None) -> (state, metrics)``
    (the metrics 0-d float32 tensors on the device; the counter and the schedules
    there too, as in `train/step.py`);
    the state's modules and optimizers are updated in place.  With ``mesh``
    the step is one rank's and ``draws`` those of the global batch."""
    H = W = cfg.img_size
    check_mesh(mesh, discriminator)

    def gen_fake(zs, nk, pd, rng):
        b = zs["z_nerf"].shape[0]
        rays_o, rays_d, _ = camera.get_rays_random_pose(
            b, H, W, generator=rng, draws=pd.camera if pd else None)
        imgs, ret = generator.forward_rays(zs, rays_o, rays_d, nk, rng,
                                           draws=pd.forward if pd else None,
                                           return_aux_img=aux_reg)
        return torch.cat([imgs, ret["aux_img"]], 0) if aux_reg else imgs

    def diffaug_draws(x, given, rng):
        if given is not None or not discriminator.main_disc.diffaug:
            return given
        return draw_disc_diffaug(x.shape[0], x.shape[-1], aux_reg, rng, x.device)

    def d_apply(x, alpha, da):
        return discriminator(x, alpha, use_aux_disc=aux_reg, fade_in=cfg.warmup_d, diffaug=da)

    def step_fn(state: DiffcamTrainState, real_imgs: torch.Tensor,
                draws: Optional[DiffcamStepDraws] = None, rng: Optional[torch.Generator] = None):
        # the default (NCHW) layout whatever the batch's strides: a stack of HWC images
        # is channels-last, which the convolutions would round otherwise
        real_imgs = real_imgs.contiguous()
        if real_imgs.dtype == torch.uint8:
            real_imgs = real_imgs.float() / 127.5 - 1.0
        step = state.step_t
        alpha = alpha_schedule(step, cfg.warmup_d, cfg.fade_steps)
        nk = dataclasses.replace(nerf_kwargs,
                                 raw_noise_std=nerf_noise_schedule(step, cfg.nerf_noise_disable))
        b, dev = real_imgs.shape[0], real_imgs.device
        G, D = generator, discriminator
        if mesh is not None:
            if draws is None:
                draws = draw_diffcam_step(G.cfg, D.main_disc.diffaug, cfg, nk, aux_reg,
                                          b * mesh.world, rng, dev)
            draws = shard_batch(draws, mesh.rank * b, (mesh.rank + 1) * b, b * mesh.world)

        # ---------------- D phase ----------------
        pd = draws.d if draws else None
        zs = pd.zs if pd else sample_zs(b, G.cfg, rng, cfg.z_dist, dev)
        with torch.no_grad():
            fake = gen_fake(zs, nk, pd, rng)
        real = torch.cat([real_imgs, real_imgs], 0) if aux_reg else real_imgs
        da_real = diffaug_draws(real, pd.diffaug_real if pd else None, rng)
        da_fake = diffaug_draws(fake, pd.diffaug if pd else None, rng)
        if cfg.r1_lambda > 0:
            penalty, real_logits = losses.r1_penalty(lambda x: d_apply(x, alpha, da_real), real,
                                                     cfg.r1_lambda, cfg.d_reg_every)
        else:
            real_logits = d_apply(real, alpha, da_real)
            penalty = torch.zeros_like(real_logits)
        fake_logits = d_apply(fake.float(), alpha, da_fake)
        d_loss = (losses.d_logistic_loss(real_logits, fake_logits) + penalty).mean()
        d_params = list(D.parameters())
        d_grads = _grads(d_loss, d_params)
        if mesh is not None:
            d_grads = all_reduce_mean_flat(d_grads, mesh)
        d_grads, d_norm, d_finite = clip_and_guard(d_grads, cfg.grad_clip)
        apply_grads(state.d_opt, d_params, d_grads)

        # ---------------- G phase: G and the camera ----------------
        pg = draws.g if draws else None
        zs = pg.zs if pg else sample_zs(b, G.cfg, rng, cfg.z_dist, dev)
        fake = gen_fake(zs, nk, pg, rng)
        da = diffaug_draws(fake, pg.diffaug if pg else None, rng)
        g_loss = losses.g_nonsaturating_loss(d_apply(fake.float(), alpha, da)).mean()
        g_params, cam_params = list(G.parameters()), list(camera.parameters())
        grads = _grads(g_loss, g_params + cam_params)
        if mesh is not None:
            grads = all_reduce_mean_flat(grads, mesh)
        g_grads, g_norm, g_finite = clip_and_guard(grads[:len(g_params)], cfg.grad_clip)
        apply_grads(state.g_opt, g_params, g_grads)
        if cam_params:
            cam_grads, cam_norm, cam_finite = clip_and_guard(grads[len(g_params):],
                                                             cfg.grad_clip)
            apply_grads(state.cam_opt, cam_params, cam_grads)
        else:
            cam_norm = torch.zeros((), device=dev)
            cam_finite = torch.ones((), dtype=torch.bool, device=dev)

        ema_update(state.ema, G, step, cfg.ema_decay, cfg.ema_start_itr)
        advance_step(state)
        with torch.no_grad():
            metrics = {"d_loss": d_loss, "grad_penalty": penalty.mean(), "g_loss": g_loss}
            if mesh is not None:
                metrics = reduce_metrics(metrics, mesh)
            metrics.update({"d_total_norm": d_norm, "g_total_norm": g_norm,
                            "cam_total_norm": cam_norm, "d_finite": d_finite.float(),
                            "g_finite": (g_finite & cam_finite).float()})
        return state, {k: v.detach().float() for k, v in metrics.items()}

    return step_fn


def init_diffcam_state(generator: GeneratorDiffcam, discriminator, camera: CamParams,
                       cfg: DiffcamTrainConfig) -> DiffcamTrainState:
    """The state at step 0: the modules as built, an EMA copy of G, fresh
    Adam states (the camera's with ``cam_lr``)."""
    g_opt, d_opt = make_optimizers(cfg, generator, discriminator)
    cam_params = list(camera.parameters())
    cam_opt = make_adam(cam_params, cfg.cam_lr, cfg) if cam_params else None
    return DiffcamTrainState(step=0, generator=generator, discriminator=discriminator,
                             ema=ema_copy(generator), g_opt=g_opt, d_opt=d_opt, camera=camera,
                             cam_opt=cam_opt)
