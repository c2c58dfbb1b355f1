"""GAN inversion: optimise style vectors to reconstruct a target image.
Counterpart of `cips3d_tpu/apps/inversion.py` (the Projector of
`exp/cips3d/models/st_web.py:66-283`, `exp/pigan/scripts/inverse_render.py`).

From the mean style (w-avg) plus a little noise, Adam optimises the style
vectors (w-space) under a fixed frontal camera to minimise a multi-scale L2
(full, 1/2 and 1/4 size) plus, optionally, a perceptual term: the trained
discriminator's own per-scale activations (`make_disc_percept_fn`) stand in
for VGG16, whose weights are absent.

A step is one program (`Projector`), a CUDA graph on the card.  The
gradient reaches the styles through the NeRF stage and the INR decode.
With ``fused_ray`` the stage runs the ray tile under autograd (on the card
kernel #2r forward and #3 backward with ``fused_ray_vjp='pallas_residual'``);
the INR-tile kernel has no backward, so ``fused_inr`` (the serving flags)
raises, as in the JAX package.  The random draws (the mean-style latents,
the start noise and each step's ray-tile uniforms) are `InversionDraws`.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from cips3d_tpu_torch.models.discriminator import resize_bilinear
from cips3d_tpu_torch.models.generator import GeneratorNerfINR, RenderOptions, sample_zs
from cips3d_tpu_torch.ops.ray_tile import RayDraws, draw_ray_randoms
from cips3d_tpu_torch.utils import graphs


def make_disc_percept_fn(discriminator) -> Callable:
    """Discriminator-feature perceptual extractor for ``percept_fn``: each
    scale's `features` activations unit-normalised over channels and
    weighted 1/sqrt(numel), concatenated into one (b, K) vector."""

    def percept(img: torch.Tensor) -> torch.Tensor:
        parts = []
        for f in discriminator.features(img):
            f = f / torch.sqrt(torch.sum(f * f, dim=1, keepdim=True) + 1e-8)
            flat = f.reshape(f.shape[0], -1)
            parts.append(flat / math.sqrt(flat.shape[-1]))
        return torch.cat(parts, -1)

    return percept


def multiscale_l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean squared error at full, 1/2 and 1/4 size; the downsampling is
    `jax.image.resize(..., "bilinear")`'s (antialiased: the triangle kernel
    widened by the scale)."""
    loss = torch.mean((a - b) ** 2)
    for s in (2, 4):
        loss = loss + torch.mean((resize_bilinear(a, a.shape[2] // s)
                                  - resize_bilinear(b, b.shape[2] // s)) ** 2)
    return loss


class InversionDraws(NamedTuple):
    """Every random draw of one `project_image` run."""

    avg_zs: Dict[str, torch.Tensor]   # latents whose mean style is the start
    noise: Dict[str, torch.Tensor]    # standard normals, one per style, shaped like it
    rays: Sequence[RayDraws]          # ray-tile draws of each optimisation step


def draw_inversion(model: GeneratorNerfINR, num_steps_opt: int, img_size: int, num_steps: int,
                   avg_samples: int = 2000, seed: int = 0) -> InversionDraws:
    """`InversionDraws` from a `torch.Generator` seeded with ``seed``."""
    dev = model.device
    g = torch.Generator(dev).manual_seed(int(seed))
    avg_zs = sample_zs(avg_samples, model.cfg, g, device=dev)
    with torch.no_grad():
        dims = {k: v.shape for k, v in model.mapping(avg_zs["z_nerf"][:1],
                                                     avg_zs["z_inr"][:1]).items()}
    noise = {k: torch.randn(shape, generator=g, device=dev) for k, shape in dims.items()}
    rays = [draw_ray_randoms(1, img_size ** 2, num_steps, False, g, dev)
            for _ in range(num_steps_opt)]
    return InversionDraws(avg_zs, noise, rays)


class Projector:
    """One `project_image` run, a step at a time (`st_web.py:66-283`
    Projector).

    A step (the forward, ``multiscale_l2`` plus the optional perceptual
    term, the gradient into the styles, Adam) is one program, as the JAX
    package jits ``opt_step``: on the card a CUDA graph captured at the
    first step (after a warm-up that is undone) and replayed each step, the
    step's `RayDraws` copied into its buffers before the replay; on the CPU
    the same step runs op by op.  Adam is capturable on the card, as the
    training step builds it (`train/state.py::make_adam`), on both routes.
    ``dispatch="eager"`` runs the step op by op on the card too.  The loss
    is copied into a device buffer every ``log_every`` steps and read once,
    by `result`."""

    def __init__(self, model: GeneratorNerfINR, target, num_steps_opt: int = 200,
                 lr: float = 0.05, img_size: int = 64, num_steps: int = 12,
                 avg_samples: int = 2000, noise_scale: float = 0.05,
                 percept_fn: Optional[Callable] = None, seed: int = 0, log_every: int = 50,
                 draws: Optional[InversionDraws] = None, dispatch: str = "program"):
        from cips3d_tpu_torch.train.state import init_opt_state

        captured = not graphs.eager(dispatch)
        dev = model.device
        if draws is None:
            draws = draw_inversion(model, num_steps_opt, img_size, num_steps, avg_samples, seed)
        self.model, self.draws, self.img_size, self.log_every = model, draws, img_size, log_every
        self.percept_fn = percept_fn
        with torch.no_grad():
            start = model.mapping(draws.avg_zs["z_nerf"], draws.avg_zs["z_inr"])
        self.styles = {k: (v.mean(0, keepdim=True) + noise_scale * draws.noise[k]).detach()
                       .requires_grad_(True) for k, v in start.items()}
        self.params = list(self.styles.values())
        self.opts = RenderOptions(img_size=img_size, num_steps=num_steps, h_stddev=0.0,
                                  v_stddev=0.0, h_mean=math.pi * 0.5, v_mean=math.pi * 0.5,
                                  sample_dist="mean")
        # the frontal camera without depth jitter: the same rays every step
        self.world = model.sample_world(1, self.opts, perturb_uniform=torch.full(
            (1, img_size ** 2, num_steps, 1), 0.5, device=dev))
        self.target = torch.as_tensor(np.asarray(target, np.float32), device=dev)[None]
        self.target_feat = None
        if percept_fn is not None:
            with torch.no_grad():
                self.target_feat = percept_fn(self.target)
        self.opt = torch.optim.Adam(self.params, lr=lr, capturable=dev.type == "cuda")
        self.losses = torch.zeros(num_steps_opt // log_every, device=dev)
        self.img, self.done = None, 0
        self.program = None
        if captured:
            init_opt_state(self.opt)   # no step allocates Adam's state inside the capture
            adam = [t for st in self.opt.state.values() for t in st.values()]
            self.program = graphs.Program(
                lambda x, rng: self._step(x), draws.rays[0], dev,
                f"inversion step r{img_size} x{num_steps}", state=self.params + adam,
                copy_out=False)

    def _step(self, rays: RayDraws):
        img_flat, _ = self.model.points_forward(self.styles, self.world, self.opts, draws=rays)
        img = img_flat.transpose(1, 2).reshape(1, 3, self.img_size, self.img_size)
        loss = multiscale_l2(img, self.target)
        if self.percept_fn is not None:
            loss = loss + torch.mean((self.percept_fn(img) - self.target_feat) ** 2)
        for p, g in zip(self.params, torch.autograd.grad(loss, self.params)):
            p.grad = g
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        return img.detach(), loss.detach()

    def step(self) -> None:
        """The next optimisation step, on its draws."""
        i = self.done
        rays = self.draws.rays[i]
        self.img, loss = self._step(rays) if self.program is None else self.program(rays)
        self.done += 1
        if self.done % self.log_every == 0:
            self.losses[self.done // self.log_every - 1].copy_(loss)

    def result(self) -> Tuple[Dict[str, torch.Tensor], np.ndarray, List[float]]:
        """(the styles, the last step's render (3, H, W) before its update,
        the loss every ``log_every`` steps, each taken before that step's
        update)."""
        final = self.img[0].detach().float().cpu().numpy()
        history = self.losses[:self.done // self.log_every].tolist()
        return {k: v.detach() for k, v in self.styles.items()}, final, history

    def close(self) -> None:
        if self.program is not None:
            self.program.close()


def project_image(model: GeneratorNerfINR, target, num_steps_opt: int = 200, lr: float = 0.05,
                  img_size: int = 64, num_steps: int = 12, avg_samples: int = 2000,
                  noise_scale: float = 0.05, percept_fn: Optional[Callable] = None,
                  seed: int = 0, log_every: int = 50,
                  draws: Optional[InversionDraws] = None, dispatch: str = "program"
                  ) -> Tuple[Dict[str, torch.Tensor], np.ndarray, List[float]]:
    """Optimise w-space styles to reconstruct ``target`` ((3, H, W) in
    [-1, 1]) under the frontal camera (`st_web.py:66-283`
    Projector.project_image): ``num_steps_opt`` steps of a `Projector`.
    Returns (the styles, the last step's render (3, H, W) before its update,
    the loss every ``log_every`` steps, each taken before that step's
    update)."""
    proj = Projector(model, target, num_steps_opt, lr, img_size, num_steps, avg_samples,
                     noise_scale, percept_fn, seed, log_every, draws, dispatch)
    try:
        for _ in range(num_steps_opt):
            proj.step()
        return proj.result()
    finally:
        proj.close()
