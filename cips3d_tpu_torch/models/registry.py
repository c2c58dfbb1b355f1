"""Model registry entries: counterpart of `cips3d_tpu/models/registry.py`
for the flagship generator (plain and freeze-NeRF), the diffcam generator,
the three discriminators and the pi-GAN generator and discriminator, under
the JAX package's names with the port's package prefix.  Import this module
before resolving configs through `config.build_model`.
"""

from __future__ import annotations

import dataclasses

from cips3d_tpu_torch.config.config import register
from cips3d_tpu_torch.models.discriminator import (Discriminator, DiscriminatorMultiScale,
                                                   DiscriminatorMultiScaleAux)
from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR
from cips3d_tpu_torch.models.generator_diffcam import GeneratorDiffcam
from cips3d_tpu_torch.models.pigan import ImplicitGenerator3d, ProgressiveDiscriminator


def _gen_cfg(kwargs) -> GeneratorConfig:
    fields = {f.name for f in dataclasses.fields(GeneratorConfig)}
    return GeneratorConfig(**{k: v for k, v in kwargs.items() if k in fields})


@register("cips3d_tpu_torch.models.GeneratorNerfINR")
def build_generator(**kwargs):
    extra = {k: kwargs.pop(k) for k in ("dtype", "generator") if k in kwargs}
    return GeneratorNerfINR(_gen_cfg(kwargs), **extra)


@register("cips3d_tpu_torch.models.GeneratorNerfINR_freeze_NeRF")
def build_generator_freeze(**kwargs):
    kwargs["freeze_nerf"] = True
    return build_generator(**kwargs)


@register("cips3d_tpu_torch.models.GeneratorDiffcam")
def build_generator_diffcam(**kwargs):
    extra = {k: kwargs.pop(k) for k in ("dtype", "generator") if k in kwargs}
    return GeneratorDiffcam(_gen_cfg(kwargs), **extra)


@register("cips3d_tpu_torch.models.Discriminator")
def build_discriminator_fixed(**kwargs):
    return Discriminator(**kwargs)


@register("cips3d_tpu_torch.models.DiscriminatorMultiScale")
def build_discriminator_ms(**kwargs):
    return DiscriminatorMultiScale(**kwargs)


@register("cips3d_tpu_torch.models.DiscriminatorMultiScaleAux")
def build_discriminator(**kwargs):
    return DiscriminatorMultiScaleAux(**kwargs)


@register("cips3d_tpu_torch.models.pigan.ImplicitGenerator3d")
def build_pigan_generator(**kwargs):
    return ImplicitGenerator3d(**kwargs)


@register("cips3d_tpu_torch.models.pigan.ProgressiveDiscriminator")
def build_pigan_discriminator(**kwargs):
    return ProgressiveDiscriminator(**kwargs)
