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

With tracing on (`utils/trace.py`) the step marks its phases: ``step.d_gen``
(the D phase's generator forward without gradient), ``step.d`` (D on the
reals with R1 and on the fakes, and its backward), ``step.g`` (the G
phase's forward and backward) and ``step.update`` (each phase's clip and
Adam, the EMA and the counter: two stretches a step).  The all-reduces of
a mesh and the metrics lie outside them.

The step reads its counter from the device (``state.step_t``): the density
noise, D's fade-in and the EMA gate are computed there, as the JAX step
traces them, and it returns its metrics as 0-d tensors on the device
without reading them back.  So one call can be recorded into a CUDA graph
and replayed step after step (`train/chunk.py`); the host loop reads the
metrics.

``batch_split`` is a Python loop over microbatches whose gradients and
metrics are averaged.  Every random number of a step can be passed in as
one `StepDraws`; without it the step draws from a `torch.Generator`.

With a `parallel.mesh.Mesh` (one process per card) ``real_imgs`` is the
rank's B / world rows and ``draws`` are those of the global batch B (without
them every rank draws them, `draw_step`, from its identically seeded
generator); the rank keeps its rows (`rank_draws`), as the JAX step draws
from one key and shards.  Each phase's gradients are averaged over the ranks
in one flat all-reduce before `clip_and_guard`, and the metrics in one more
(``d_logits_norm`` as its mean square, rooted after).  With ``ray_shards`` R
> 1 a group of R ranks renders one set of B * R / world latents, each rank
1/R of the pixels (`GeneratorNerfINR.forward`), and D sees the rank's 1/R of
the group's images.  `parallel/mesh.py` says why the averaged gradient is
the JAX step's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from cips3d_tpu_torch.core.ema import ema_copy, ema_update
from cips3d_tpu_torch.core.rays import draw_camera
from cips3d_tpu_torch.models.discriminator import draw_disc_diffaug
from cips3d_tpu_torch.models.generator import (ForwardDraws, GeneratorNerfINR, RenderOptions,
                                               sample_zs)
from cips3d_tpu_torch.ops.ray_tile import draw_ray_randoms, uses_noise
from cips3d_tpu_torch.parallel.mesh import Mesh, all_reduce_mean_flat, shard_batch
from cips3d_tpu_torch.train import losses
from cips3d_tpu_torch.train.schedules import alpha_schedule, nerf_noise_schedule
from cips3d_tpu_torch.train.state import (TrainConfig, TrainState, advance_step, apply_grads,
                                          clip_and_guard, make_optimizers)
from cips3d_tpu_torch.utils import trace


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


def draw_step(gen_cfg, diffaug: bool, cfg: TrainConfig, opts: RenderOptions, aux_reg: bool,
              grad_points: Optional[int], batch: int, rng: Optional[torch.Generator],
              device) -> StepDraws:
    """Every draw of one step at ``batch`` rows, ``cfg.batch_split``
    microbatches a phase (``opts`` with the step's density noise; D's
    DiffAug draws when ``diffaug``)."""
    mb, n, steps = batch // cfg.batch_split, cfg.img_size ** 2, opts.num_steps
    noise = uses_noise(opts.nerf_noise)

    def rays(m):
        return draw_ray_randoms(mb, m, steps, noise, rng, device,
                                hierarchical=opts.hierarchical_sample)

    def forward(gp):
        perturb = torch.rand((mb, n, steps, 1), generator=rng, device=device)
        camera = draw_camera(mb, opts.sample_dist, rng, device)
        if gp is None:
            return ForwardDraws(perturb, camera, rays(n))
        perm = torch.randperm(n, generator=rng, device=device)
        return ForwardDraws(perturb, camera, rays(gp), perm, rays(n - gp))

    def disc():
        if not diffaug:
            return None
        return draw_disc_diffaug(mb * (2 if aux_reg else 1), cfg.img_size, aux_reg, rng, device)

    def phase(gp, real):
        zs = sample_zs(mb, gen_cfg, rng, cfg.z_dist, device)
        return PhaseDraws(zs, forward(gp), disc(), disc() if real else None)

    return StepDraws([phase(None, True) for _ in range(cfg.batch_split)],
                     [phase(grad_points, False) for _ in range(cfg.batch_split)])


def rank_draws(draws: StepDraws, mesh: Mesh, n_real: int, n_split: int) -> StepDraws:
    """The rank's microbatches of a step's global draws, for its ``n_real``
    real rows in ``n_split`` microbatches.  Its ray group renders global G
    rows [g * n_real * R, (g + 1) * n_real * R) (``zs`` and ``forward``),
    the rank's D sees its 1/R of them (DiffAug of the fakes) and its real
    rows [rank * n_real, (rank + 1) * n_real) (DiffAug of the reals); each
    microbatch of those lies within one global microbatch."""
    mb_g = draws.d[0].zs["z_nerf"].shape[0]
    if mb_g * len(draws.d) != n_real * mesh.world:
        raise ValueError(f"draws of {mb_g * len(draws.d)} rows for {mesh.world} ranks of "
                         f"{n_real} rows")
    n_g = n_real * mesh.ray_shards
    m_d, m_g = n_real // n_split, n_g // n_split

    def rows(phases, field, lo, n):
        i = lo // mb_g
        return shard_batch(getattr(phases[i], field), lo - i * mb_g, lo - i * mb_g + n, mb_g)

    d, g = [], []
    for j in range(n_split):
        g_lo = mesh.group_index * n_g + j * m_g
        f_lo = g_lo + mesh.ray_index * m_d
        r_lo = mesh.rank * n_real + j * m_d
        d.append(PhaseDraws(rows(draws.d, "zs", g_lo, m_g), rows(draws.d, "forward", g_lo, m_g),
                            rows(draws.d, "diffaug", f_lo, m_d),
                            rows(draws.d, "diffaug_real", r_lo, m_d)))
        g.append(PhaseDraws(rows(draws.g, "zs", g_lo, m_g), rows(draws.g, "forward", g_lo, m_g),
                            rows(draws.g, "diffaug", f_lo, m_d)))
    return StepDraws(d, g)


def check_mesh(mesh: Optional[Mesh], discriminator) -> None:
    """Refuse a minibatch standard deviation on several ranks: its groups
    would be per rank, where the JAX step groups over the global batch."""
    if mesh is not None and mesh.world > 1 and any(
            getattr(m, "stddev_group", 0) > 0 for m in discriminator.modules()):
        raise ValueError("stddev_group > 0 groups samples across the batch, which the ranks "
                         "split; set discriminator.stddev_group 0 to train on several ranks")


def make_train_step(generator: GeneratorNerfINR, discriminator, cfg: TrainConfig,
                    opts: RenderOptions, aux_reg: bool, d_regularize: bool = True,
                    mesh: Optional[Mesh] = None):
    """The step for one (aux_reg, d_regularize) variant:
    ``step(state, real_imgs, draws=None, rng=None) -> (state, metrics)``,
    the metrics 0-d float32 tensors on the device.  The state's modules, optimizers
    and counter are updated in place.  With ``mesh`` the step is one rank's
    (the module docstring)."""
    num_points = cfg.img_size ** 2
    grad_points = cfg.grad_points ** 2 if cfg.grad_points else None
    if grad_points is not None and grad_points >= num_points:
        grad_points = None
    rays_sharded = mesh is not None and mesh.ray_shards > 1
    check_mesh(mesh, discriminator)
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

    def d_rows(x, n):
        """The rank's D rows of its group's fakes ([inr | aux] with aux): the
        ray index's n of each half (all of them without ray shards)."""
        if not rays_sharded:
            return x
        b, lo = x.shape[0] // (2 if aux_reg else 1), mesh.ray_index * n
        return torch.cat([x[lo:lo + n], x[b + lo:b + lo + n]]) if aux_reg else x[lo:lo + n]

    def d_microbatch(state, real, ropts, alpha, pd, rng):
        G = state.generator
        with trace.phase("step.d_gen"):
            zs = pd.zs if pd else sample_zs(real.shape[0], G.cfg, rng, cfg.z_dist, real.device)
            with torch.no_grad():
                fake, _ = G(zs, ropts, rng, return_aux_img=aux_reg,
                            draws=pd.forward if pd else None, cfg=d_cfg, mesh=mesh)
            fake = d_rows(fake, real.shape[0])
        with trace.phase("step.d"):
            return d_loss_grads(state, real, fake, alpha, pd, rng)

    def d_loss_grads(state, real, fake, alpha, pd, rng):
        D = state.discriminator
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
            sq = (torch.cat([real_logits, fake_logits]) ** 2).mean()
            metrics = {
                "d_loss": loss,
                "d_logits_real": real_logits.mean(),
                "d_logits_fake": fake_logits.mean(),
                # under a mesh the mean square, reduced over the ranks before its root
                "d_logits_norm": sq if mesh is not None else torch.sqrt(sq),
                "grad_penalty": penalty.mean(),
            }
        return grads, metrics

    def g_microbatch(state, zs, ropts, alpha, pd, rng):
        G, D = state.generator, state.discriminator
        fake, _ = G(zs, ropts, rng, return_aux_img=aux_reg, grad_points=grad_points,
                    draws=pd.forward if pd else None, mesh=mesh)
        fake = d_rows(fake, zs["z_nerf"].shape[0] // (mesh.ray_shards if mesh else 1))
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
        # the default (NCHW) layout whatever the batch's strides: a stack of HWC images
        # is channels-last, which the convolutions would round otherwise
        real_imgs = real_imgs.contiguous()
        if real_imgs.dtype == torch.uint8:
            real_imgs = real_imgs.float() / 127.5 - 1.0
        step = state.step_t
        alpha = alpha_schedule(step, cfg.warmup_d, cfg.fade_steps)
        ropts = render_opts(step)
        n_split = cfg.batch_split
        G, D = state.generator, state.discriminator
        if mesh is not None:
            n_real = real_imgs.shape[0]
            if draws is None:
                draws = draw_step(G.cfg, D.main_disc.diffaug, cfg, ropts, aux_reg, grad_points,
                                  n_real * mesh.world, rng, real_imgs.device)
            draws = rank_draws(draws, mesh, n_real, n_split)

        # ---------------- D phase ----------------
        reals = real_imgs.chunk(n_split, 0)
        d_grads, d_metrics = accumulate([
            d_microbatch(state, real, ropts, alpha, draws.d[i] if draws else None, rng)
            for i, real in enumerate(reals)])
        if mesh is not None:
            d_grads = all_reduce_mean_flat(d_grads, mesh)
        with trace.phase("step.update"):
            d_grads, d_norm, d_finite = clip_and_guard(d_grads, cfg.grad_clip)
            d_params = list(D.parameters())
            apply_grads(state.d_opt, d_params, d_grads)

        # ---------------- G phase ----------------
        with trace.phase("step.g"):
            if draws:
                zs_parts = [pd.zs for pd in draws.g]
            else:
                zs = sample_zs(real_imgs.shape[0], G.cfg, rng, cfg.z_dist, real_imgs.device)
                zs_parts = [dict(zip(zs, parts)) for parts in
                            zip(*(v.chunk(n_split, 0) for v in zs.values()))]
            g_grads, g_metrics = accumulate([
                g_microbatch(state, zs_i, ropts, alpha, draws.g[i] if draws else None, rng)
                for i, zs_i in enumerate(zs_parts)])
        if mesh is not None:
            g_grads = all_reduce_mean_flat(g_grads, mesh)
        with trace.phase("step.update"):
            g_grads, g_norm, g_finite = clip_and_guard(g_grads, cfg.grad_clip)
            apply_grads(state.g_opt, list(G.parameters()), g_grads)
            # ---------------- EMA ----------------
            ema_update(state.ema, G, step, cfg.ema_decay, cfg.ema_start_itr)
            advance_step(state)

        with torch.no_grad():
            metrics = dict(d_metrics)
            metrics.update(g_metrics)
            if mesh is not None:
                metrics = reduce_metrics(metrics, mesh)
                metrics["d_logits_norm"] = torch.sqrt(metrics["d_logits_norm"])
            metrics.update({
                "d_total_norm": d_norm,
                "g_total_norm": g_norm,
                "d_w_norm": torch.sqrt(sum((p.float() ** 2).sum() for p in d_params)),
                "d_finite": d_finite.float(),
                "g_finite": g_finite.float(),
                "alpha": alpha,
                "nerf_noise": ropts.nerf_noise,
            })
        return state, {k: v.detach().float() for k, v in metrics.items()}

    return step_fn


def reduce_metrics(metrics: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The mean over the ranks of each scalar metric, in one all-reduce."""
    names = list(metrics)
    (vals,) = all_reduce_mean_flat([torch.stack([metrics[k].float() for k in names])], mesh)
    return dict(zip(names, vals))


def init_train_state(generator: GeneratorNerfINR, discriminator, cfg: TrainConfig) -> TrainState:
    """The state at step 0: the modules as initialized (seeded at
    construction, or loaded), an EMA copy of G, fresh Adam states."""
    g_opt, d_opt = make_optimizers(cfg, generator, discriminator)
    return TrainState(step=0, generator=generator, discriminator=discriminator,
                      ema=ema_copy(generator), g_opt=g_opt, d_opt=d_opt)
