"""The two variant pipelines on the port's one host loop: counterpart of
`cips3d_tpu/train/variant_loop.py`.

`DiffcamPipeline` (`GeneratorDiffcam`, a learnable `CamParams` with a third
Adam, `cam_param` in every snapshot tree and ``cam_opt`` in the resume
tree) and `PiGANPipeline` (`ImplicitGenerator3d` against the encoder
`ProgressiveDiscriminator`, top-k GAN and identity penalty) bind the
`Pipeline` interface of `train/loop.py`, whose `run_pipeline` runs the
whole host protocol: the sealed-outdir guard, text logs, ``best_fid/``,
backups and ``resume/``, the ``*_crupted`` dumps, the surrogate FID and the
monitors.  Their steps regularise D every step, as the JAX steps do (the
loop's lazy-R1 flag is not read); pi-GAN has no aux branch.  So they chunk
steps (``dispatch_chunk``, `train/chunk.py`) whenever aux runs every step or
never, the JAX variant loop's rule (`constant_schedule`).  In a process
group they are data-parallel only (1-D), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch

from cips3d_tpu_torch.eval.images import save_image_grid, to_uint8
from cips3d_tpu_torch.models.camera import CamParams
from cips3d_tpu_torch.models.discriminator import DiscriminatorMultiScaleAux
from cips3d_tpu_torch.models.generator import GeneratorConfig, RenderOptions, sample_zs
from cips3d_tpu_torch.models.generator_diffcam import GeneratorDiffcam, NerfKwargs
from cips3d_tpu_torch.models.pigan import ImplicitGenerator3d, ProgressiveDiscriminator
from cips3d_tpu_torch.train.diffcam_step import (DiffcamTrainConfig, init_diffcam_state,
                                                 make_diffcam_train_step)
from cips3d_tpu_torch.train.loop import (Pipeline, _load_modules, _load_opt_state, _modules,
                                         _opt_states)
from cips3d_tpu_torch.train.pigan_step import (PiGANTrainConfig, init_pigan_state,
                                               make_pigan_train_step)
from cips3d_tpu_torch.utils import convert, image_io


def _dump_fakes(render, fake_dir: str, num_imgs: int, batch_size: int, device,
                shard_index: int = 0, num_shards: int = 1) -> None:
    """``render(b, rng)`` → images (b, 3, h, w) in [-1, 1], written as
    ``fake_{i:06d}.png``; shard k of n writes i = k, k + n, ..., its batch j
    drawn from a generator seeded k * 100003 + j (as `eval.images.gen_images`)."""
    os.makedirs(fake_dir, exist_ok=True)
    n_local = (num_imgs - shard_index + num_shards - 1) // num_shards
    written = 0
    for step in range((n_local + batch_size - 1) // batch_size):
        rng = torch.Generator(device).manual_seed(shard_index * 100003 + step)
        with torch.no_grad():
            imgs = render(batch_size, rng).float().cpu().numpy()
        for img in imgs[:n_local - written]:
            idx = shard_index + written * num_shards
            image_io.write_png(os.path.join(fake_dir, f"fake_{idx:06d}.png"), to_uint8(img))
            written += 1


def _grid(imgs: torch.Tensor, path: str) -> None:
    save_image_grid(imgs.float().cpu().numpy(), path, max(1, int(math.sqrt(imgs.shape[0]))))


class _VariantPipeline(Pipeline):
    def constant_schedule(self) -> bool:
        """Their steps regularise every step: only the aux schedule counts."""
        cfg = self.train_cfg
        return (cfg.train_aux_img and cfg.update_aux_every == 1) or not cfg.train_aux_img


class DiffcamPipeline(_VariantPipeline):
    """`GeneratorDiffcam`, `DiscriminatorMultiScaleAux` and a learnable
    `CamParams` with a third Adam."""

    module_names = ("cam_param", "generator", "G_ema", "discriminator")
    opt_names = ("g_opt", "d_opt", "cam_opt")

    def __init__(self, gen_cfg: GeneratorConfig, disc_kwargs: dict, cam_kwargs: dict,
                 train_cfg: DiffcamTrainConfig, nerf_kwargs: NerfKwargs):
        self.gen_cfg, self.disc_kwargs, self.cam_kwargs = gen_cfg, disc_kwargs, cam_kwargs
        self.train_cfg, self.nerf_kwargs = train_cfg, nerf_kwargs
        self.fixed_zs = None

    def init_state(self, loop_cfg):
        dev, seed = torch.device(loop_cfg.device), int(loop_cfg.seed)
        gen = GeneratorDiffcam(self.gen_cfg, generator=torch.Generator().manual_seed(seed))
        disc = DiscriminatorMultiScaleAux(**self.disc_kwargs,
                                          generator=torch.Generator().manual_seed(seed + 1))
        self.fixed_zs = sample_zs(4 if loop_cfg.debug else loop_cfg.fixed_z_bs, self.gen_cfg,
                                  torch.Generator(dev).manual_seed(seed + 2), device=dev)
        return init_diffcam_state(gen.to(dev), disc.to(dev), CamParams(**self.cam_kwargs).to(dev),
                                  self.train_cfg)

    def make_step(self, state, aux_reg, d_regularize, mesh=None):
        return make_diffcam_train_step(state.generator, state.discriminator, state.camera,
                                       self.train_cfg, self.nerf_kwargs, aux_reg=aux_reg,
                                       mesh=mesh)

    def module_list(self, state):
        return [state.camera, *super().module_list(state)]

    def modules(self, state):
        return dict(cam_param=convert.cam_tree_from_state_dict(state.camera.state_dict()),
                    **_modules(state))

    def opt_states(self, state):
        out = _opt_states(state)
        if state.cam_opt is not None:
            out["cam_opt"] = convert.optax_adam_state(state.cam_opt, state.camera,
                                                      convert.cam_tree_from_state_dict)
        return out

    def load_modules(self, state, loaded):
        _load_modules(state, loaded)
        state.camera.load_state_dict(convert.to_torch(convert.cam_state_dict(
            loaded["cam_param"])), strict=True)

    def load_opt(self, state, name, tree):
        if name == "cam_opt":
            if state.cam_opt is not None:
                convert.load_optax_adam_state(state.cam_opt, state.camera, tree,
                                              convert.cam_state_dict)
        else:
            _load_opt_state(state, name, tree)

    def render(self, gen, camera, zs, rng, h_mean=math.pi * 0.5, h_stddev=0.3,
               v_stddev=0.155):
        """Images of ``gen`` at a random pose around ``h_mean``, without
        density noise."""
        size = self.train_cfg.img_size
        rays_o, rays_d, _ = camera.get_rays_random_pose(
            zs["z_nerf"].shape[0], size, size, h_stddev=h_stddev, v_stddev=v_stddev,
            h_mean=h_mean, generator=rng)
        nk = dataclasses.replace(self.nerf_kwargs, raw_noise_std=0.0)
        return gen.forward_rays(zs, rays_o, rays_d, nk, rng)[0]

    def gen_eval_images(self, state, fake_dir, num_imgs, loop_cfg, shard_index=0, num_shards=1):
        dev = state.camera.fx_raw.device
        _dump_fakes(lambda b, rng: self.render(state.ema, state.camera,
                                               sample_zs(b, self.gen_cfg, rng, device=dev), rng),
                    fake_dir, num_imgs, loop_cfg.eval_batch_size, dev, shard_index, num_shards)

    @torch.no_grad()
    def save_monitors(self, state, out_dir):
        os.makedirs(out_dir, exist_ok=True)
        dev = state.camera.fx_raw.device
        for name, gen, h_mean in (("0Gz", state.generator, math.pi * 0.5),
                                  ("0Gz_ema", state.ema, math.pi * 0.5),
                                  ("0Gz_tilted_ema", state.ema, math.pi * 0.5 + 0.5)):
            rng = torch.Generator(dev).manual_seed(0)
            _grid(self.render(gen, state.camera, self.fixed_zs, rng, h_mean, 0.0, 0.0),
                  f"{out_dir}/{name}.jpg")


class PiGANPipeline(_VariantPipeline):
    """`ImplicitGenerator3d` and `ProgressiveDiscriminator` with the top-k
    GAN and identity-penalty step."""

    def __init__(self, gen_kwargs: dict, disc_kwargs: dict, train_cfg: PiGANTrainConfig,
                 opts: RenderOptions):
        self.gen_kwargs, self.disc_kwargs = gen_kwargs, disc_kwargs
        self.train_cfg, self.opts = train_cfg, opts
        self.fixed_z = None

    def init_state(self, loop_cfg):
        dev, seed = torch.device(loop_cfg.device), int(loop_cfg.seed)
        gen = ImplicitGenerator3d(**self.gen_kwargs, generator=torch.Generator().manual_seed(seed))
        disc = ProgressiveDiscriminator(**self.disc_kwargs,
                                        generator=torch.Generator().manual_seed(seed + 1))
        self.fixed_z = torch.randn((4 if loop_cfg.debug else loop_cfg.fixed_z_bs, gen.z_dim),
                                   generator=torch.Generator(dev).manual_seed(seed + 2),
                                   device=dev)
        return init_pigan_state(gen.to(dev), disc.to(dev), self.train_cfg)

    def make_step(self, state, aux_reg, d_regularize, mesh=None):
        return make_pigan_train_step(state.generator, state.discriminator, self.train_cfg,
                                     self.opts, mesh=mesh)

    def modules(self, state):
        return {"generator": convert.pigan_tree_from_state_dict(state.generator.state_dict()),
                "G_ema": convert.pigan_tree_from_state_dict(state.ema.state_dict()),
                "discriminator": convert.pigan_d_tree_from_state_dict(
                    state.discriminator.state_dict())}

    def opt_states(self, state):
        return {"g_opt": convert.optax_adam_state(state.g_opt, state.generator,
                                                  convert.pigan_tree_from_state_dict),
                "d_opt": convert.optax_adam_state(state.d_opt, state.discriminator,
                                                  convert.pigan_d_tree_from_state_dict)}

    def load_modules(self, state, loaded):
        for module, name in ((state.generator, "generator"), (state.ema, "G_ema")):
            module.load_state_dict(convert.to_torch(convert.pigan_state_dict(loaded[name])),
                                   strict=True)
        convert.load_partial(state.discriminator,
                             convert.pigan_d_state_dict(loaded["discriminator"]))

    def load_opt(self, state, name, tree):
        opt, module, fn = ((state.g_opt, state.generator, convert.pigan_state_dict)
                           if name == "g_opt" else
                           (state.d_opt, state.discriminator, convert.pigan_d_state_dict))
        convert.load_optax_adam_state(opt, module, tree, fn)

    def eval_opts(self, **over) -> RenderOptions:
        return dataclasses.replace(self.opts, img_size=self.train_cfg.img_size, nerf_noise=0.0,
                                   **over)

    def gen_eval_images(self, state, fake_dir, num_imgs, loop_cfg, shard_index=0, num_shards=1):
        dev, opts = state.ema.device, self.eval_opts()
        _dump_fakes(lambda b, rng: state.ema(torch.randn((b, state.ema.z_dim), generator=rng,
                                                         device=dev), opts, rng)[0],
                    fake_dir, num_imgs, loop_cfg.eval_batch_size, dev, shard_index, num_shards)

    @torch.no_grad()
    def save_monitors(self, state, out_dir):
        os.makedirs(out_dir, exist_ok=True)
        base = self.eval_opts(h_stddev=0.0, v_stddev=0.0)
        tilted = dataclasses.replace(base, h_mean=math.pi * 0.5 + 0.5)
        for name, gen, opts in (("0Gz", state.generator, base), ("0Gz_ema", state.ema, base),
                                ("0Gz_tilted_ema", state.ema, tilted)):
            rng = torch.Generator(gen.device).manual_seed(0)
            _grid(gen(self.fixed_z, opts, rng)[0], f"{out_dir}/{name}.jpg")


# ---------------------------------------------------------------------------
# config node → pipeline (train/cli.py)

def _fields(cls, node: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in node.items() if k in names}


def build_diffcam_pipeline(cfg) -> DiffcamPipeline:
    """A resolved command node → `DiffcamPipeline`; the camera's H0/W0
    default to the stage's img_size."""
    cam_kwargs = dict(cfg.get("cam", {}))
    cam_kwargs.setdefault("H0", cfg.img_size)
    cam_kwargs.setdefault("W0", cfg.img_size)
    return DiffcamPipeline(GeneratorConfig(**cfg.generator.to_dict()),
                           cfg.discriminator.to_dict(), cam_kwargs,
                           DiffcamTrainConfig(**_fields(DiffcamTrainConfig, cfg.to_dict())),
                           NerfKwargs(**_fields(NerfKwargs, dict(cfg.get("nerf_kwargs", {})))))


def build_pigan_pipeline(cfg) -> PiGANPipeline:
    """A resolved command node → `PiGANPipeline` (the curriculum keys as
    node fields)."""
    r = cfg.render.to_dict()
    hierarchical = r.pop("hierarchical_sample", True)
    return PiGANPipeline(cfg.generator.to_dict(), cfg.discriminator.to_dict(),
                         PiGANTrainConfig(**_fields(PiGANTrainConfig, cfg.to_dict())),
                         RenderOptions(img_size=cfg.img_size, hierarchical_sample=hierarchical,
                                       **r))
