"""Shared layers: counterparts of `cips3d_tpu/models/layers.py`.

Parameters are float32 in the reference's state-dict layout (torch
``(out, in)`` Linear weights, ``(1, in, out)`` SinStyleMod weights, OIHW
conv weights); ``dtype`` selects the compute precision as in the JAX
layers.  Every layer takes an explicit `torch.Generator` for its
initialization.  The equalized-lr layers of the discriminator (NCHW) store
raw N(0, 1) weights and scale them at run time.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cips3d_tpu_torch.models import init as winit
from cips3d_tpu_torch.ops.fused_act import fused_leaky_relu


class TorchLinear(nn.Module):
    """Linear layer with a pluggable init; defaults reproduce nn.Linear's."""

    def __init__(self, in_dim: int, out_dim: int, kernel_init: Optional[winit.Init] = None,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kinit = kernel_init or winit.torch_linear_kernel
        self.weight = nn.Parameter(kinit((in_dim, out_dim), generator).T.contiguous())
        self.bias = nn.Parameter(winit.torch_linear_bias(in_dim)((out_dim,), generator))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return x.to(dt) @ self.weight.to(dt).T + self.bias.to(dt)


class PixelNorm(nn.Module):
    """x * rsqrt(mean(x^2) + 1e-8)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-8)


def uniform_box_warp(coords: torch.Tensor, sidelength: float = 0.24) -> torch.Tensor:
    """Scale xyz into the SIREN's input box."""
    return coords * (2.0 / sidelength)


class FiLMSineLayer(nn.Module):
    """``sin(gain * Wx + bias)`` with gain = gain_fc(style)*15 + 30 and
    bias = bias_fc(style); linear weight frequency_init(25), style FC
    weights scaled by 0.25 after init."""

    GAIN_SCALE = 15.0
    GAIN_BIAS = 30.0

    def __init__(self, in_dim: int, out_dim: int, style_dim: int, fast_sin: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        style_init = winit.scaled_kernel(winit.torch_linear_kernel, 0.25)
        self.linear = TorchLinear(in_dim, out_dim, kernel_init=winit.frequency_kernel(25.0),
                                  generator=generator, dtype=dtype)
        self.gain_fc = TorchLinear(style_dim, out_dim, kernel_init=style_init,
                                   generator=generator, dtype=dtype)
        self.bias_fc = TorchLinear(style_dim, out_dim, kernel_init=style_init,
                                   generator=generator, dtype=dtype)
        self.fast_sin = fast_sin

    def films(self, style: torch.Tensor):
        """Per-sample (gain, bias) vectors, each (b, out)."""
        return self.gain_fc(style) * self.GAIN_SCALE + self.GAIN_BIAS, self.bias_fc(style)

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        gain, bias = self.films(style)
        if x.dim() == 3:
            gain, bias = gain[:, None, :], bias[:, None, :]
        arg = gain * self.linear(x) + bias
        if self.fast_sin:
            from cips3d_tpu_torch.ops.fast_sin import fast_sin

            return fast_sin(arg)
        return torch.sin(arg)


class SinStyleMod(nn.Module):
    """Style-modulated FC: ``((x * s) @ W) * rsqrt((s^2) @ (W^2) + eps)``
    with ``s = modulation(style) + 1``; the per-sample weight is never
    materialized."""

    EPS = 1e-8

    def __init__(self, in_channel: int, out_channel: int, style_dim: int,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        w = winit.kaiming_leaky_fanout_kernel((in_channel, out_channel), generator)
        self.weight = nn.Parameter(w[None])
        self.modulation = TorchLinear(style_dim, in_channel, kernel_init=winit.kaiming_leaky_kernel,
                                      generator=generator, dtype=dtype)
        # The reference registers a LayerNorm that its forward never uses;
        # kept so the state dict loads strictly in both directions.
        self.norm = nn.LayerNorm(in_channel)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        squeeze = x.dim() == 2
        if squeeze:
            x = x[:, None, :]
        s = self.modulation(style) + 1.0
        w = self.weight[0].to(self.dtype)
        out = (x.to(self.dtype) * s[:, None, :]) @ w
        demod = torch.rsqrt((s.float() ** 2) @ (w.float() ** 2) + self.EPS)
        out = out * demod[:, None, :].to(self.dtype)
        return out[:, 0] if squeeze else out


class ToRGB(nn.Module):
    """Per-block RGB head with skip accumulation; frequency_init(100)."""

    def __init__(self, in_dim: int, dim_rgb: int = 3,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.linear = TorchLinear(in_dim, dim_rgb, kernel_init=winit.frequency_kernel(100.0),
                                  generator=generator, dtype=dtype)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = self.linear(x)
        return out if skip is None else out + skip


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class EqualLinear(nn.Module):
    """Equalized-lr linear: weight (out, in) ~ N(0, 1/lr_mul), scaled by
    lr_mul/sqrt(in) at run time; bias starts at ``bias_init_value`` and is
    scaled by lr_mul; ``activation`` applies the fused bias + leaky ReLU."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True,
                 bias_init_value: float = 0.0, lr_mul: float = 1.0,
                 scale: Optional[float] = None, norm_weight: bool = False,
                 activation: bool = False, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.randn((out_dim, in_dim), generator=generator) / lr_mul)
        self.bias = (nn.Parameter(torch.full((out_dim,), float(bias_init_value)))
                     if use_bias else None)
        self.scale = scale if scale is not None else lr_mul / math.sqrt(in_dim)
        self.lr_mul = lr_mul
        self.norm_weight = norm_weight
        self.activation = activation
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if self.norm_weight:
            w = w * torch.rsqrt((w * w).sum(1, keepdim=True) + 1e-8)
        y = x.to(self.dtype) @ (w * self.scale).to(self.dtype).T
        bias = None if self.bias is None else (self.bias * self.lr_mul).to(self.dtype)
        if self.activation:
            return fused_leaky_relu(y, bias)
        return y if bias is None else y + bias


class EqualConv2d(nn.Module):
    """Equalized-lr conv: OIHW weight ~ N(0, 1) scaled by 1/sqrt(in k^2)."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.randn((out_channel, in_channel, k, k),
                                               generator=generator))
        self.bias = nn.Parameter(torch.zeros(out_channel)) if use_bias else None
        self.scale = 1.0 / math.sqrt(in_channel * k * k)
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), (self.weight * self.scale).to(self.dtype), bias,
                        stride=self.stride, padding=self.padding)


class EqualConvTranspose2d(nn.Module):
    """Equalized-lr transposed conv (IOHW weight), as
    `F.conv_transpose2d(x, w * scale, stride, padding)`."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.randn((in_channel, out_channel, k, k),
                                               generator=generator))
        self.bias = nn.Parameter(torch.zeros(out_channel)) if use_bias else None
        self.scale = 1.0 / math.sqrt(in_channel * k * k)
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv_transpose2d(x.to(self.dtype), (self.weight * self.scale).to(self.dtype),
                                  bias, stride=self.stride, padding=self.padding)


def minibatch_stddev(x: torch.Tensor, group_size: int = 4, num_features: int = 1) -> torch.Tensor:
    """Append the minibatch-stddev channel: (N, C, H, W) -> (N, C+1, H, W),
    over groups of ``min(N, group_size)`` (biased variance, +1e-8)."""
    n, c, h, w = x.shape
    g = min(n, group_size)
    grouped = x.reshape(g, -1, num_features, c // num_features, h, w)
    var = grouped.float().var(0, unbiased=False)
    std = torch.sqrt(var + 1e-8).mean((2, 3, 4))            # (m, feat)
    std = std[:, :, None, None].repeat(g, 1, h, w)          # (n, feat, h, w)
    return torch.cat([x, std.to(x.dtype)], 1)
