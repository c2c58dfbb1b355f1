"""StyleGAN2 multi-scale discriminator (+ auxiliary discriminator):
counterpart of `cips3d_tpu/models/discriminator.py`, NCHW only.

  * `ConvLayer`: optional blur + stride-2 conv (down) or transposed conv +
    blur (up), fused bias + leaky ReLU;
  * `ResBlock`: conv -> conv(down) + 1x1 skip, / sqrt(2);
    ``first_downsample`` moves the stride to the first conv;
  * `Discriminator`: the fixed-size StyleGAN2 D with minibatch stddev;
  * `DiscriminatorMultiScale`: per-resolution input convs, progressive
    alpha blending with the half-resolution head (``fade_in``), optional
    minibatch stddev, space_linear + out_linear head;
  * `DiscriminatorMultiScaleAux`: main + aux D; with ``use_aux_disc`` the
    batch is split half/half between them;

Every per-resolution input head and block exists from construction, as the
JAX package's ``init_all`` materializes them, so one set of parameters
spans the whole progressive schedule.  Plain PyTorch throughout: the JAX
package computes the discriminator with XLA convolutions, outside any
Pallas kernel.  With ``diffaug`` a D augments its input (`ops/diffaug.py`)
whenever a call brings its draws: a (main, aux) pair of `DiffAugDraws`,
as the JAX package splits one key into k1 for the main D and k2 for the
aux D.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .layers import (EqualConv2d, EqualConvTranspose2d, EqualLinear,
                                            minibatch_stddev)
from .diffaug import DiffAugDraws, diff_augment, draw_diffaug
from .fused_act import fused_leaky_relu, scaled_leaky_relu
from .upfirdn2d import (blur_pad_down, blur_pad_up, make_kernel, on_device,
                                           upfirdn2d)

BLUR_KERNEL = (1, 3, 3, 1)


def stylegan2_channels(channel_multiplier: int = 2) -> Dict[int, int]:
    """The channel table of the main D."""
    return {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * channel_multiplier,
            128: 128 * channel_multiplier, 256: 64 * channel_multiplier,
            512: 32 * channel_multiplier, 1024: 16 * channel_multiplier}


def aux_channels(channel_multiplier: int = 2) -> Dict[int, int]:
    """The narrower table of the aux D."""
    return {4: 128 * channel_multiplier, 8: 128 * channel_multiplier,
            16: 128 * channel_multiplier, 32: 128 * channel_multiplier,
            64: 128 * channel_multiplier, 128: 128 * channel_multiplier,
            256: 64 * channel_multiplier, 512: 32 * channel_multiplier,
            1024: 16 * channel_multiplier}


@functools.lru_cache(maxsize=None)
def _resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) weights of `jax.image.resize(..., method="bilinear")` on one
    axis: the triangle kernel, widened by the scale when downsampling
    (antialias), each output's weights normalised to sum 1."""
    inv_scale = np.float32(in_size / out_size)
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (np.arange(out_size, dtype=np.float32) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x).astype(np.float32)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    w = np.where(((sample >= -0.5) & (sample <= in_size - 0.5))[None, :], w, 0)
    return np.ascontiguousarray(w.T.astype(np.float32))


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """NCHW bilinear resize of H and W to ``size``, as `jax.image.resize`
    (its matrices made on the device once per shape, `upfirdn2d.on_device`)."""
    my, mx = (on_device(("resize", n, size), lambda n=n: _resize_matrix(n, size), x.dtype,
                        x.device) for n in x.shape[2:])
    return torch.einsum("oh,nchw,pw->ncop", my, x, mx)


class ConvLayer(nn.Module):
    """Conv with optional blur-down / up-blur and fused activation."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int,
                 downsample: bool = False, upsample: bool = False, use_bias: bool = True,
                 activate: bool = True, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        conv_bias = use_bias and not activate
        if downsample:
            self.conv = EqualConv2d(in_channel, out_channel, kernel_size, stride=2, padding=0,
                                    use_bias=conv_bias, generator=generator, dtype=dtype)
        elif upsample:
            self.conv = EqualConvTranspose2d(in_channel, out_channel, kernel_size, stride=2,
                                             padding=0, use_bias=conv_bias, generator=generator,
                                             dtype=dtype)
        else:
            self.conv = EqualConv2d(in_channel, out_channel, kernel_size, stride=1,
                                    padding=(kernel_size - 1) // 2, use_bias=conv_bias,
                                    generator=generator, dtype=dtype)
        self.bias = nn.Parameter(torch.zeros(out_channel)) if activate and use_bias else None
        self.kernel = make_kernel(BLUR_KERNEL)
        self.kernel_size, self.downsample, self.upsample = kernel_size, downsample, upsample
        self.activate = activate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample:
            x = upfirdn2d(x, self.kernel, pad=blur_pad_down(BLUR_KERNEL, self.kernel_size))
            x = self.conv(x)
        elif self.upsample:
            x = self.conv(x)
            x = upfirdn2d(x, self.kernel * 4.0, pad=blur_pad_up(BLUR_KERNEL, self.kernel_size))
        else:
            x = self.conv(x)
        if self.activate:
            if self.bias is not None:
                return fused_leaky_relu(x, self.bias.to(x.dtype))
            return scaled_leaky_relu(x)
        return x


class ResBlock(nn.Module):
    """Residual down block: (conv1, conv2 with the stride, or conv1 with it
    under ``first_downsample``) + 1x1 strided skip, / sqrt(2)."""

    def __init__(self, in_channel: int, out_channel: int, first_downsample: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        g = dict(generator=generator, dtype=dtype)
        self.conv1 = ConvLayer(in_channel, in_channel, 3, downsample=first_downsample, **g)
        self.conv2 = ConvLayer(in_channel, out_channel, 3, downsample=not first_downsample, **g)
        self.skip = ConvLayer(in_channel, out_channel, 1, downsample=True, activate=False,
                              use_bias=False, **g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (self.conv2(self.conv1(x)) + self.skip(x)) / math.sqrt(2)


def _table(channels_override, default):
    if channels_override:
        return {int(k): v for k, v in channels_override.items()}
    return default


class Discriminator(nn.Module):
    """Fixed-size StyleGAN2 D."""

    def __init__(self, size: int, channel_multiplier: int = 2, n_first_layers: int = 0,
                 stddev_group: int = 4, channels_override: Optional[Dict[int, int]] = None,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ch = _table(channels_override, stylegan2_channels(channel_multiplier))
        g = dict(generator=generator, dtype=dtype)
        self.conv_in = ConvLayer(3, ch[size], 1, **g)
        self.first = nn.ModuleList(ConvLayer(ch[size], ch[size], 3, **g)
                                   for _ in range(n_first_layers))
        log_size = int(math.log2(size))
        self.res = nn.ModuleDict({
            str(2 ** i): ResBlock(ch[2 ** i], ch[2 ** (i - 1)], **g)
            for i in range(log_size, 2, -1)})
        self.final_conv = ConvLayer(ch[4] + 1, ch[4], 3, **g)
        self.final_linear_0 = EqualLinear(ch[4] * 16, ch[4], activation=True, **g)
        self.final_linear_1 = EqualLinear(ch[4], 1, **g)
        self.stddev_group = stddev_group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv_in(x)
        for layer in self.first:
            out = layer(out)
        for block in self.res.values():
            out = block(out)
        out = self.final_conv(minibatch_stddev(out, self.stddev_group))
        return self.final_linear_1(self.final_linear_0(out.reshape(out.shape[0], -1)))


class DiscriminatorMultiScale(nn.Module):
    """Multi-resolution D with progressive alpha blending: the input's size
    picks its input head and the blocks it runs through."""

    def __init__(self, diffaug: bool = False, max_size: int = 1024, channel_multiplier: int = 2,
                 first_downsample: bool = False, stddev_group: int = 0,
                 use_aux_channels: bool = False,
                 channels_override: Optional[Dict[int, int]] = None,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.diffaug = diffaug
        ch = _table(channels_override,
                    aux_channels(2) if use_aux_channels else stylegan2_channels(channel_multiplier))
        g = dict(generator=generator, dtype=dtype)
        self.conv_in = nn.ModuleDict({str(res): ConvLayer(3, ch[res], 1, **g) for res in ch})
        log_size = int(math.log2(max_size))
        self.blocks = nn.ModuleDict({
            str(2 ** i): ResBlock(ch[2 ** i], ch[2 ** (i - 1)], first_downsample, **g)
            for i in range(log_size, 2, -1)})
        final_in = ch[4]
        self.final_conv = ConvLayer(final_in + (1 if stddev_group > 0 else 0), final_in, 3, **g)
        self.space_linear = EqualLinear(final_in * 16, final_in, activation=True, **g)
        self.out_linear = EqualLinear(final_in, 1, **g)
        self.stddev_group = stddev_group

    def forward(self, x: torch.Tensor, alpha=1.0, fade_in: bool = True,
                diffaug: Optional[DiffAugDraws] = None) -> torch.Tensor:
        """Logits (b, 1).  ``alpha`` (a number, or a 0-d tensor on the device:
        the step's fade-in schedule) blends in the half-resolution head under
        ``fade_in``."""
        if self.diffaug and diffaug is not None:
            x = diff_augment(x, diffaug)
        size = x.shape[-1]
        log_size = int(math.log2(size))
        out = self.blocks[str(size)](self.conv_in[str(size)](x))
        if fade_in and size > 4:   # blend with the half-resolution input head
            half = size // 2
            down_out = self.conv_in[str(half)](resize_bilinear(x, half))
            out = alpha * out + (1.0 - alpha) * down_out
        for i in range(log_size - 1, 2, -1):
            out = self.blocks[str(2 ** i)](out)
        if self.stddev_group > 0:
            out = minibatch_stddev(out, self.stddev_group)
        out = self.final_conv(out)
        out = self.out_linear(self.space_linear(out.reshape(out.shape[0], -1)))
        return out



class DiscriminatorMultiScaleAux(nn.Module):
    """Main + auxiliary discriminator."""

    def __init__(self, diffaug: bool = False, max_size: int = 1024, channel_multiplier: int = 2,
                 first_downsample: bool = False, stddev_group: int = 0,
                 channels_override: Optional[Dict[int, int]] = None,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        common = dict(diffaug=diffaug, max_size=max_size, stddev_group=stddev_group,
                      channels_override=channels_override, generator=generator, dtype=dtype)
        self.main_disc = DiscriminatorMultiScale(channel_multiplier=channel_multiplier,
                                                 first_downsample=first_downsample, **common)
        self.aux_disc = DiscriminatorMultiScale(first_downsample=True, use_aux_channels=True,
                                                **common)

    def forward(self, x: torch.Tensor, alpha=1.0, use_aux_disc: bool = False,
                fade_in: bool = True, diffaug=None) -> torch.Tensor:
        """With ``use_aux_disc`` the first half of the batch goes to the main
        D and the second half (the NeRF aux images) to the aux D.
        ``diffaug``: (main, aux) draws (see `draw_disc_diffaug`), or None."""
        d1, d2 = diffaug if diffaug is not None else (None, None)
        if use_aux_disc:
            b = x.shape[0] // 2
            return torch.cat([self.main_disc(x[:b], alpha, fade_in, d1),
                              self.aux_disc(x[b:], alpha, fade_in, d2)], 0)
        return self.main_disc(x, alpha, fade_in, d1)



def draw_disc_diffaug(n: int, size: int, use_aux_disc: bool,
                      generator: Optional[torch.Generator] = None, device=None):
    """The (main, aux) DiffAug draws of one `DiscriminatorMultiScaleAux`
    call on n images of size x size (aux None without ``use_aux_disc``)."""
    if use_aux_disc:
        return (draw_diffaug(n // 2, size, size, generator, device),
                draw_diffaug(n - n // 2, size, size, generator, device))
    return draw_diffaug(n, size, size, generator, device), None
