"""Weight initializers with the distributions of `cips3d_tpu/models/init.py`.

Each initializer takes an ``(in, out)`` shape, the JAX package's kernel
layout, so fan-in conventions read the same as there, and an explicit
`torch.Generator`.  The layers transpose kernels into torch's ``(out, in)``.

  * torch `nn.Linear` default: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) on weight
    and bias;
  * `frequency_init(freq)`: U(-sqrt(6/fan_in)/freq, sqrt(6/fan_in)/freq);
  * kaiming-leaky: N(0, sqrt(2/(1+0.2^2))/sqrt(fan_in));
  * SinStyleMod weight: kaiming-leaky with the *out* dim as fan;
  * `normal_kernel(std)`: N(0, std), the raw weights of equalized-lr layers.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

LEAKY_GAIN = math.sqrt(2.0 / (1.0 + 0.2 ** 2))

Init = Callable[[Sequence[int], Optional[torch.Generator]], torch.Tensor]


def _uniform(shape, bound: float, generator) -> torch.Tensor:
    return (torch.rand(tuple(shape), generator=generator) * 2.0 - 1.0) * bound


def torch_linear_kernel(shape, generator=None) -> torch.Tensor:
    """torch nn.Linear default weight init on an (in, out) kernel."""
    return _uniform(shape, 1.0 / math.sqrt(shape[0]), generator)


def torch_linear_bias(fan_in: int) -> Init:
    """torch nn.Linear default bias init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""

    def init(shape, generator=None):
        return _uniform(shape, 1.0 / math.sqrt(fan_in), generator)

    return init


def frequency_kernel(freq: float) -> Init:
    """`frequency_init(freq)` on an (in, out) kernel."""

    def init(shape, generator=None):
        return _uniform(shape, math.sqrt(6.0 / shape[0]) / freq, generator)

    return init


def kaiming_leaky_kernel(shape, generator=None) -> torch.Tensor:
    """kaiming_normal(a=0.2, fan_in) on an (in, out) kernel."""
    std = LEAKY_GAIN / math.sqrt(shape[0])
    return torch.randn(tuple(shape), generator=generator) * std


def kaiming_leaky_fanout_kernel(shape, generator=None) -> torch.Tensor:
    """kaiming_normal(a=0.2) reading the *out* dim as fan (the SinStyleMod
    weight, where torch's fan-in convention reads ``size(1)``)."""
    std = LEAKY_GAIN / math.sqrt(shape[1])
    return torch.randn(tuple(shape), generator=generator) * std


def scaled_kernel(base_init: Init, scale: float) -> Init:
    """Post-init scale (the reference's ``weight.data.mul_(s)``)."""

    def init(shape, generator=None):
        return base_init(shape, generator) * scale

    return init


def normal_kernel(std: float = 1.0) -> Init:
    """randn * std: the StyleGAN2 equalized-lr raw weights."""

    def init(shape, generator=None):
        return torch.randn(tuple(shape), generator=generator) * std

    return init
