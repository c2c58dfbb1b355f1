"""Host training loop on one GPU: counterpart of
`cips3d_tpu/train/loop.py::train` and `cips3d_tpu/train/variant_loop.py`.

One loop (`run_pipeline`) serves every model stack through a small
`Pipeline` interface: state init, the step for an ``(aux_reg,
d_regularize)`` pair, the module and optimizer trees of a snapshot, the
eval images and the monitors.  The flagship binds it here
(`FlagshipPipeline`, through `train`); diffcam and pi-GAN in
`train/variant_loop.py`.  The loop:

  * builds the state from seeded inits, or resumes / finetunes from
    snapshots in the JAX package's layout;
  * per step: the step variant the schedule asks for (aux every
    ``update_aux_every`` steps, lazy R1 every ``d_reg_every``); the loop
    steps one at a time (the JAX loop's ``dispatch_chunk``, a device
    program of several steps for its remote TPU, has no counterpart: a
    config's value is not read);
  * every ``log_every`` steps (each step under ``debug``): the metrics to
    the text logs and one printed line;
  * eval after step 1, every ``eval_every`` steps and, under
    ``debug``, after each step: reals and EMA fakes to ``fid/``, the
    surrogate FID, ``best_fid/``, a numbered backup, ``resume/`` (with
    every Adam state), and fixed-z monitor grids; monitors that fail three
    evals in a row stop the run;
  * a step whose gradients were not finite (the step zeroes them) dumps a
    ``D_crupted`` or ``G_crupted`` snapshot;
  * ``profile_steps`` traces that many steps with `torch.profiler` into
    ``<outdir>/profile``.
The 2-D (data x rays) mesh (``ray_shards > 1``) and ``debug_shapes`` are not
ported and raise.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from cips3d_tpu_torch.data.zip_dataset import DataLoader, ZipImageDataset
from cips3d_tpu_torch.eval.fid import eval_fid
from cips3d_tpu_torch.eval.images import gen_images, save_image_grid, setup_evaluation
from cips3d_tpu_torch.models.discriminator import DiscriminatorMultiScaleAux
from cips3d_tpu_torch.models.generator import (GeneratorConfig, GeneratorNerfINR, RenderOptions,
                                               sample_zs)
from cips3d_tpu_torch.train.state import TrainConfig, TrainState
from cips3d_tpu_torch.train.step import init_train_state, make_train_step
from cips3d_tpu_torch.utils import convert
from cips3d_tpu_torch.utils.checkpoint import CheckpointManager
from cips3d_tpu_torch.utils.textlogger import TextLogger


@dataclasses.dataclass
class LoopConfig:
    """Host-loop settings (the JAX package's fields, plus ``device``)."""

    outdir: str = "results/run"
    data_path: str = ""
    seed: int = 1234
    log_every: int = 10
    eval_every: int = 500
    num_images_real_eval: int = 2048
    num_images_gen_eval: int = 2048
    eval_batch_size: int = 16
    fixed_z_bs: int = 16
    del_fid_real_images: bool = True
    num_workers: int = 4
    xflip: bool = True
    cache_decoded: bool = False
    max_to_keep: int = 3
    debug: bool = False
    debug_shapes: bool = False
    profile_steps: int = 0
    archive_eval_images: bool = False
    ray_shards: int = 1
    device: str = "cuda"


def _modules(state: TrainState) -> dict:
    """G, its EMA and D as JAX-layout trees."""
    return {"generator": convert.jax_tree_from_state_dict(state.generator.state_dict()),
            "G_ema": convert.jax_tree_from_state_dict(state.ema.state_dict()),
            "discriminator": convert.jax_d_tree_from_state_dict(state.discriminator.state_dict())}


def _opt_states(state: TrainState) -> dict:
    return {"g_opt": convert.optax_adam_state(state.g_opt, state.generator,
                                              convert.jax_tree_from_state_dict),
            "d_opt": convert.optax_adam_state(state.d_opt, state.discriminator,
                                              convert.jax_d_tree_from_state_dict)}


def _load_modules(state: TrainState, loaded: dict) -> None:
    def load(module, sd):
        module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)

    load(state.generator, convert.state_dict_from_jax(loaded["generator"]))
    load(state.ema, convert.state_dict_from_jax(loaded["G_ema"]))
    load(state.discriminator, convert.discriminator_state_dict(loaded["discriminator"]))


def _load_opt_state(state: TrainState, name: str, tree: dict) -> None:
    """``g_opt`` or ``d_opt`` from its optax tree into the state's Adam."""
    opt, module, fn = ((state.g_opt, state.generator, convert.state_dict_from_jax)
                       if name == "g_opt" else
                       (state.d_opt, state.discriminator, convert.discriminator_state_dict))
    convert.load_optax_adam_state(opt, module, tree, fn)


def _refuse_sealed_outdir(outdir: str) -> None:
    """Refuse to write into a sealed campaign tree: a ``CAMPAIGN_SEALED``
    marker in ``outdir`` or any ancestor makes it write-protected."""
    d = os.path.abspath(outdir)
    while True:
        marker = os.path.join(d, "CAMPAIGN_SEALED")
        if os.path.exists(marker):
            raise RuntimeError(f"outdir {outdir!r} is inside a sealed campaign tree ({marker} "
                               "exists); choose a fresh outdir")
        parent = os.path.dirname(d)
        if parent == d:
            return
        d = parent


def save_monitor_images(generator, ema, fixed_zs, opts: RenderOptions, out_dir: str) -> None:
    """Fixed-z grids (each with the aux images below): G and EMA at the mean
    pose, tilted, and the EMA's mirror-symmetry probe (yaw 1.44 vs 1.70).
    Rendered in sub-batches of at most 8 * 256^2 pixels."""
    os.makedirs(out_dir, exist_ok=True)
    base = dataclasses.replace(opts, h_stddev=0.0, v_stddev=0.0)
    mb_cap = max(1, (8 * 256 ** 2) // (opts.img_size ** 2))

    @torch.no_grad()
    def render(model, o, z=fixed_zs):
        n = z["z_nerf"].shape[0]
        mb = min(n, mb_cap)
        outs = []
        for i in range(0, n, mb):
            sub = {k: v[i:i + mb] for k, v in z.items()}
            rng = torch.Generator(model.device).manual_seed(0)
            imgs, _ = model(sub, o, rng, return_aux_img=True)
            outs.append(imgs.float().cpu().numpy())
        return np.concatenate(outs)

    bs = fixed_zs["z_nerf"].shape[0]
    nrow = max(1, int(math.sqrt(bs)))
    tilted = dataclasses.replace(base, h_mean=math.pi * 0.5 + 0.5)
    for name, model, o in (("0Gz", generator, base), ("0Gz_ema", ema, base),
                           ("0Gz_tilted", generator, tilted), ("0Gz_tilted_ema", ema, tilted)):
        save_image_grid(render(model, o), f"{out_dir}/{name}.jpg", nrow)
    sub = {k: v[:min(8, bs)] for k, v in fixed_zs.items()}
    f1 = render(ema, dataclasses.replace(base, h_mean=1.44), sub)
    f2 = render(ema, dataclasses.replace(base, h_mean=1.70), sub)
    save_image_grid(np.concatenate([f1, f2]), f"{out_dir}/0G_flip_ema.jpg", len(sub["z_nerf"]))


def _copy_nerf_from_ema(state: TrainState) -> None:
    """``load_nerf_ema``: G's siren, NeRF mapping and aux head from the EMA."""
    with torch.no_grad():
        for mod in ("siren", "mapping_network_nerf", "aux_to_rbg"):
            for p, e in zip(getattr(state.generator, mod).parameters(),
                            getattr(state.ema, mod).parameters()):
                p.copy_(e)


class Pipeline:
    """What a model stack gives the host loop.  ``train_cfg`` is a
    `TrainConfig` (or a subclass): the loop reads its schedule fields."""

    train_cfg: TrainConfig
    module_names: tuple = ("generator", "G_ema", "discriminator")
    opt_names: tuple = ("g_opt", "d_opt")

    def init_state(self, loop_cfg: "LoopConfig"):
        """The state at step 0 on ``loop_cfg.device``, modules from seeds
        derived from ``loop_cfg.seed``."""
        raise NotImplementedError

    def make_step(self, state, aux_reg: bool, d_regularize: bool) -> Callable:
        """The step of ``state``'s modules: ``step(state, real, rng=rng) ->
        (state, metrics)``."""
        raise NotImplementedError

    def modules(self, state) -> Dict[str, dict]:
        """name → JAX-layout tree of every module a snapshot holds."""
        raise NotImplementedError

    def opt_states(self, state) -> Dict[str, dict]:
        """name → optax-layout Adam state (the resume tree only)."""
        raise NotImplementedError

    def load_modules(self, state, loaded: Dict[str, dict]) -> None:
        raise NotImplementedError

    def load_opt(self, state, name: str, tree: dict) -> None:
        raise NotImplementedError

    def after_load(self, state) -> None:
        """Called once the weights are in place (resumed, finetuned or fresh)."""

    def gen_eval_images(self, state, fake_dir: str, num_imgs: int,
                        loop_cfg: "LoopConfig") -> None:
        raise NotImplementedError

    def save_monitors(self, state, out_dir: str) -> None:
        raise NotImplementedError


class FlagshipPipeline(Pipeline):
    """`GeneratorNerfINR` and `DiscriminatorMultiScaleAux` with the step of
    `train/step.py`."""

    def __init__(self, gen_cfg: GeneratorConfig, train_cfg: TrainConfig, opts: RenderOptions,
                 disc_kwargs: Optional[dict] = None, load_nerf_ema: bool = False):
        self.gen_cfg, self.train_cfg, self.opts = gen_cfg, train_cfg, opts
        self.disc_kwargs, self.load_nerf_ema = disc_kwargs or {}, load_nerf_ema
        self.fixed_zs = None

    def init_state(self, loop_cfg):
        dev, seed = torch.device(loop_cfg.device), int(loop_cfg.seed)
        generator = GeneratorNerfINR(self.gen_cfg,
                                     generator=torch.Generator().manual_seed(seed)).to(dev)
        discriminator = DiscriminatorMultiScaleAux(
            **self.disc_kwargs, generator=torch.Generator().manual_seed(seed + 1)).to(dev)
        self.fixed_zs = sample_zs(4 if loop_cfg.debug else loop_cfg.fixed_z_bs, self.gen_cfg,
                                  torch.Generator(dev).manual_seed(seed + 2), device=dev)
        return init_train_state(generator, discriminator, self.train_cfg)

    def make_step(self, state, aux_reg, d_regularize):
        return make_train_step(state.generator, state.discriminator, self.train_cfg, self.opts,
                               aux_reg=aux_reg, d_regularize=d_regularize)

    def modules(self, state):
        return _modules(state)

    def opt_states(self, state):
        return _opt_states(state)

    def load_modules(self, state, loaded):
        _load_modules(state, loaded)

    def load_opt(self, state, name, tree):
        _load_opt_state(state, name, tree)

    def after_load(self, state):
        if self.load_nerf_ema:
            _copy_nerf_from_ema(state)

    def gen_eval_images(self, state, fake_dir, num_imgs, loop_cfg):
        cfg = self.train_cfg
        gen_images(state.ema, fake_dir, num_imgs, cfg.img_size,
                   batch_size=loop_cfg.eval_batch_size, num_steps=self.opts.num_steps,
                   opts=self.opts,
                   forward_points=cfg.forward_points ** 2 if cfg.forward_points else None)

    def save_monitors(self, state, out_dir):
        save_monitor_images(state.generator, state.ema, self.fixed_zs,
                            dataclasses.replace(self.opts, img_size=self.train_cfg.img_size),
                            out_dir)


def train(gen_cfg: GeneratorConfig, train_cfg: TrainConfig, opts: RenderOptions,
          loop_cfg: LoopConfig, disc_kwargs: Optional[dict] = None, resume: bool = False,
          finetune_dir: Optional[str] = None, load_nerf_ema: bool = False,
          reset_best_fid: bool = False) -> TrainState:
    """Run the flagship's adversarial loop; returns the final TrainState."""
    return run_pipeline(FlagshipPipeline(gen_cfg, train_cfg, opts, disc_kwargs, load_nerf_ema),
                        loop_cfg, resume=resume, finetune_dir=finetune_dir,
                        reset_best_fid=reset_best_fid)


def run_pipeline(pipeline: Pipeline, loop_cfg: LoopConfig, resume: bool = False,
                 finetune_dir: Optional[str] = None, reset_best_fid: bool = False):
    """The host loop over ``pipeline``; returns the final state."""
    if int(loop_cfg.ray_shards) > 1:
        raise NotImplementedError("ray_shards > 1 (the 2-D data x rays mesh) is not ported")
    if loop_cfg.debug_shapes:
        raise NotImplementedError("debug_shapes is not ported")
    train_cfg = pipeline.train_cfg
    outdir = loop_cfg.outdir
    _refuse_sealed_outdir(outdir)
    os.makedirs(outdir, exist_ok=True)
    dev = torch.device(loop_cfg.device)
    textlogger = TextLogger(os.path.join(outdir, "textdir"))
    ckpt_mgr = CheckpointManager(os.path.join(outdir, "ckptdir"), loop_cfg.max_to_keep)

    seed = int(loop_cfg.seed)
    state = pipeline.init_state(loop_cfg)

    start_state = {"step": 0, "best_fid": float("inf"), "cur_fid": float("inf")}
    if resume and ckpt_mgr.has_snapshot("resume"):
        pipeline.load_modules(state, ckpt_mgr.load_snapshot("resume", pipeline.module_names))
        rdir = os.path.join(ckpt_mgr.ckpt_dir, "resume")
        for nm in pipeline.opt_names:
            if os.path.exists(os.path.join(rdir, f"{nm}.npz")):   # older trees: fresh moments
                pipeline.load_opt(state, nm, ckpt_mgr.load_snapshot("resume", (nm,))[nm])
        start_state.update(ckpt_mgr.load_state("resume"))
        state.step = int(start_state["step"])
    elif finetune_dir:
        print(f"loading finetune weights from {finetune_dir}", flush=True)
        mgr2 = CheckpointManager(os.path.dirname(finetune_dir))
        pipeline.load_modules(state, mgr2.load_snapshot(os.path.basename(finetune_dir),
                                                        pipeline.module_names))
    pipeline.after_load(state)
    if reset_best_fid:
        start_state["best_fid"] = float("inf")

    start = int(start_state["step"])
    # a resumed run draws afresh instead of replaying the draws of its first steps
    rng = torch.Generator(dev).manual_seed(seed + start)
    dataset = ZipImageDataset(loop_cfg.data_path, resize_resolution=train_cfg.img_size,
                              xflip=loop_cfg.xflip, cache_decoded=loop_cfg.cache_decoded)
    loader = DataLoader(dataset, batch_size=train_cfg.batch_size, seed=seed + start,
                        num_workers=loop_cfg.num_workers)

    step_fns = {}

    def get_step_fn(aux_reg: bool, d_regularize: bool):
        k = (aux_reg, d_regularize)
        if k not in step_fns:
            step_fns[k] = pipeline.make_step(state, aux_reg, d_regularize)
        return step_fns[k]

    def dump_crupted(name):
        ckpt_mgr.save_snapshot(name, pipeline.modules(state), state=dict(start_state),
                               info_msg=f"non-finite gradients at step {start_state['step']}")

    total = 2 if loop_cfg.debug else train_cfg.total_iters
    profile_start = start + 2 if total - start > loop_cfg.profile_steps + 2 else start
    profiler = None
    t_last = time.time()
    step = start
    try:
        while step < total:
            real = torch.from_numpy(next(loader)[0]).to(dev)
            if loop_cfg.profile_steps and step == profile_start:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                                 if dev.type == "cuda" else [])
                profiler = profile(activities=acts)
                profiler.__enter__()
            aux_reg = train_cfg.train_aux_img and step % train_cfg.update_aux_every == 0
            d_reg = step % train_cfg.d_reg_every == 0
            state, m = get_step_fn(aux_reg, d_reg)(state, real, rng=rng)
            if profiler is not None and step >= profile_start + loop_cfg.profile_steps - 1:
                profiler.__exit__(None, None, None)
                os.makedirs(os.path.join(outdir, "profile"), exist_ok=True)
                profiler.export_chrome_trace(os.path.join(outdir, "profile", "trace.json"))
                profiler = None
                print(f"profiler trace written to {outdir}/profile", flush=True)
            step += 1
            start_state["step"] = step
            now = time.time()
            imgs_per_sec = train_cfg.batch_size / max(now - t_last, 1e-9)
            t_last = now
            if not m["d_finite"] > 0:
                dump_crupted("D_crupted")
            if not m["g_finite"] > 0:
                dump_crupted("G_crupted")
            if step % loop_cfg.log_every == 0 or loop_cfg.debug:
                summary = {name: {name: v} for name, v in m.items()}
                summary["lr"] = {"G_lr": train_cfg.gen_lr, "D_lr": train_cfg.disc_lr}
                summary["speed"] = {"imgs_per_sec": imgs_per_sec}
                textlogger.log_dict(summary, prefix="train", step=step)
                print(f"step {step}: d_loss={m['d_loss']:.4f} g_loss={m['g_loss']:.4f} "
                      f"gp={m['grad_penalty']:.4f} {imgs_per_sec:.1f} img/s", flush=True)
            if step == 1 or step % loop_cfg.eval_every == 0 or loop_cfg.debug:
                _run_eval_and_checkpoint(pipeline, state, loop_cfg, dataset, ckpt_mgr,
                                         textlogger, start_state)
                t_last = time.time()   # keep eval time out of the next speed sample
        if profiler is not None:
            profiler.__exit__(None, None, None)
        # a last eval and checkpoint when total_iters is not a multiple of eval_every
        if total > start and total % loop_cfg.eval_every != 0 and not loop_cfg.debug:
            start_state["step"] = total
            _run_eval_and_checkpoint(pipeline, state, loop_cfg, dataset, ckpt_mgr, textlogger,
                                     start_state)
    finally:
        loader.close()
        textlogger.close()
    return state


def _run_eval_and_checkpoint(pipeline, state, loop_cfg, dataset, ckpt_mgr, textlogger,
                             host_state):
    img_size = pipeline.train_cfg.img_size
    n_eval = 16 if loop_cfg.debug else loop_cfg.num_images_real_eval
    n_gen = 16 if loop_cfg.debug else loop_cfg.num_images_gen_eval
    real_dir = os.path.join(loop_cfg.outdir, "fid/real")
    fake_dir = os.path.join(loop_cfg.outdir, "fid/fake")
    setup_evaluation(ZipImageDataset(dataset.path, resize_resolution=None, xflip=False),
                     real_dir, n_eval, img_size, del_existing=loop_cfg.del_fid_real_images)
    loop_cfg.del_fid_real_images = False
    pipeline.gen_eval_images(state, fake_dir, n_gen, loop_cfg)
    metric_dict = eval_fid(real_dir, fake_dir, device=loop_cfg.device)
    fid_name = next(k for k in metric_dict if k.startswith("FID"))
    fid_val = metric_dict[fid_name]
    step = host_state["step"]
    textlogger.log_dict({fid_name: {fid_name: fid_val}}, prefix="eval", step=step)
    host_state["cur_fid"] = fid_val
    print(f"step {step}: {fid_name}={fid_val:.3f}", flush=True)
    if loop_cfg.archive_eval_images:
        import shutil

        shutil.copytree(fake_dir, os.path.join(loop_cfg.outdir, "fid", f"fake_step{step:06d}"),
                        dirs_exist_ok=True)
    modules = pipeline.modules(state)
    info = f"step: {step}\ncur_fid: {host_state['cur_fid']}\nbest_fid: {host_state['best_fid']}"
    if host_state["best_fid"] > fid_val:
        host_state["best_fid"] = fid_val
        ckpt_mgr.save_snapshot("best_fid", modules, dict(host_state), info)
    ckpt_mgr.save_backup(modules, dict(host_state), info)
    # only the resume tree carries the optimizer states
    ckpt_mgr.save_snapshot("resume", dict(modules, **pipeline.opt_states(state)),
                           dict(host_state), info)
    try:
        pipeline.save_monitors(state, os.path.join(ckpt_mgr.ckpt_dir, "resume"))
        host_state["monitor_failures"] = 0
    except Exception as e:   # monitors must not kill training, but a run of failures does
        n_fail = int(host_state.get("monitor_failures", 0)) + 1
        host_state["monitor_failures"] = n_fail
        import traceback

        marker = os.path.join(ckpt_mgr.ckpt_dir, "MONITOR_FAILURES.log")
        with open(marker, "a") as f:
            f.write(f"step {step} (consecutive #{n_fail}):\n{traceback.format_exc()}\n")
        print(f"monitor images FAILED at step {step} (consecutive #{n_fail}, details in "
              f"{marker}): {e}", flush=True)
        if n_fail >= 3:
            raise RuntimeError(f"monitor images failed {n_fail} evals in a row; see {marker}") \
                from e
