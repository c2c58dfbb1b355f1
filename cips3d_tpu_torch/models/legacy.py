"""Legacy and auxiliary model components: counterparts of
`cips3d_tpu/models/legacy.py` (the reference's dev variants).

  * `CLN`: conditional LayerNorm, normalize (no affine, population
    variance, eps 1e-5) then ``x * (gain_fc(style) + 1) + bias_fc(style)``;
  * `CLNLayer`: Linear → CLN → LeakyReLU;
  * `INRNetwork`: a FiLM-sine stack and a tanh RGB head;
  * `INRNetworkSkip`: dual FiLM stages on the `SKIP_CHANNELS` schedule with
    ToRGB skip accumulation;
  * `PosEmbedding`: NeRF's sinusoidal embedding;
  * `FCNet`: a LeakyReLU MLP with a tanh RGB head;
  * `ModulatedFCConv`: the StyleGAN2 equalized-lr modulated FC;
  * `INRNetworkSkipProg`, `INRNetworkSkipCLN`, `LinearSkipProg`: the
    progressive decoders with an early exit at ``img_size``;
  * `CLNBlock`: two CLN stages with an optional residual skip;
  * `ModSinLayer`: the RMS-normalized style layer and its sine variant.

The JAX modules infer their input widths; these take them (``in_dim``,
``style_dim``) explicitly.  Every submodule carries the JAX submodule's
name, so `utils/convert.py::tree_state_dict` loads a JAX tree strictly.
Every layer takes an explicit `torch.Generator` for its initialization.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cips3d_tpu_torch.models import init as winit
from cips3d_tpu_torch.models.layers import EqualLinear, FiLMSineLayer, TorchLinear


def _stop(img_size: int) -> str:
    """The resolution key after which a progressive decoder exits."""
    return str(2 ** int(math.log2(img_size)))


class CLN(nn.Module):
    """Conditional LayerNorm."""

    def __init__(self, in_dim: int, style_dim: int, eps: float = 1e-5,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.gain_fc = TorchLinear(style_dim, in_dim, generator=generator, dtype=dtype)
        self.bias_fc = TorchLinear(style_dim, in_dim, generator=generator, dtype=dtype)
        self.eps = eps

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        gain = self.gain_fc(style) + 1.0
        bias = self.bias_fc(style)
        if x.dim() == 3:
            gain, bias = gain[:, None, :], bias[:, None, :]
        mean = x.mean(-1, keepdim=True)
        var = x.var(-1, unbiased=False, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * gain + bias


class CLNLayer(nn.Module):
    """Linear → CLN → LeakyReLU."""

    def __init__(self, in_dim: int, out_dim: int, style_dim: int,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.linear = TorchLinear(in_dim, out_dim, generator=generator, dtype=dtype)
        self.cln = CLN(out_dim, style_dim, generator=generator, dtype=dtype)

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.cln(self.linear(x), style), 0.2)


class INRNetwork(nn.Module):
    """FiLM-sine MLP decoder; style keys ``{prefix}_w{i}``."""

    def __init__(self, in_dim: int, hidden_dim: int, hidden_layers: int, style_dim: int,
                 rgb_dim: int = 3, name_prefix: str = "inr",
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i in range(hidden_layers):
            self.add_module(f"film_{i}", FiLMSineLayer(in_dim if i == 0 else hidden_dim,
                                                       hidden_dim, style_dim,
                                                       generator=generator, dtype=dtype))
        self.to_rgb = TorchLinear(hidden_dim if hidden_layers else in_dim, rgb_dim,
                                  generator=generator, dtype=dtype)
        self.hidden_layers = hidden_layers
        self.name_prefix = name_prefix

    def forward(self, x: torch.Tensor, style_dict: Mapping[str, torch.Tensor]) -> torch.Tensor:
        for i in range(self.hidden_layers):
            x = getattr(self, f"film_{i}")(x, style_dict[f"{self.name_prefix}_w{i}"])
        return torch.tanh(self.to_rgb(x))


#: channel schedule of INRNetwork_Skip
SKIP_CHANNELS = (512, 512, 512, 512, 512, 128, 64, 32, 16)


class INRNetworkSkip(nn.Module):
    """Dual-FiLM stages and ToRGB skip accumulation; style keys
    ``{prefix}_w{i}_0`` / ``{prefix}_w{i}_1``."""

    def __init__(self, in_dim: int, hidden_layers: int, style_dim: int, dim_scale: float = 1.0,
                 rgb_dim: int = 3, name_prefix: str = "inr",
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        prev = in_dim
        for i in range(hidden_layers):
            ch = int(SKIP_CHANNELS[i] * dim_scale)
            self.add_module(f"film_{i}_0", FiLMSineLayer(prev, ch, style_dim,
                                                         generator=generator, dtype=dtype))
            self.add_module(f"film_{i}_1", FiLMSineLayer(ch, ch, style_dim,
                                                         generator=generator, dtype=dtype))
            self.add_module(f"to_rgb_{i}", TorchLinear(
                ch, rgb_dim, kernel_init=winit.frequency_kernel(100.0), generator=generator,
                dtype=dtype))
            prev = ch
        self.hidden_layers = hidden_layers
        self.name_prefix = name_prefix

    def forward(self, x: torch.Tensor, style_dict: Mapping[str, torch.Tensor]) -> torch.Tensor:
        p, rgb = self.name_prefix, None
        for i in range(self.hidden_layers):
            x = getattr(self, f"film_{i}_0")(x, style_dict[f"{p}_w{i}_0"])
            x = getattr(self, f"film_{i}_1")(x, style_dict[f"{p}_w{i}_1"])
            out = getattr(self, f"to_rgb_{i}")(x)
            rgb = out if rgb is None else rgb + out
        return torch.tanh(rgb)


class PosEmbedding(nn.Module):
    """x → (x, sin(f_0 x), cos(f_0 x), ...), f_k = 2^k on a log scale."""

    def __init__(self, max_logscale: int = 9, n_freqs: int = 10, logscale: bool = True,
                 multi_pi: bool = False):
        super().__init__()
        if logscale:
            freqs = 2.0 ** np.linspace(0, max_logscale, n_freqs, dtype=np.float32)
        else:
            freqs = np.linspace(1, 2.0 ** max_logscale, n_freqs, dtype=np.float32)
        if multi_pi:
            freqs = freqs * np.float32(math.pi)
        self.freqs = [float(f) for f in freqs.astype(np.float32)]
        self.n_freqs = n_freqs

    @property
    def out_dim(self) -> int:
        return 3 + 3 * 2 * self.n_freqs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [x]
        for f in self.freqs:
            outs.append(torch.sin(f * x))
            outs.append(torch.cos(f * x))
        return torch.cat(outs, -1)


class FCNet(nn.Module):
    """Kaiming-leaky Linears with LeakyReLU, and a tanh RGB head."""

    def __init__(self, in_dim: int, hidden_dim: int, hidden_layers: int, rgb_dim: int = 3,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i in range(hidden_layers):
            self.add_module(f"fc_{i}", TorchLinear(
                in_dim if i == 0 else hidden_dim, hidden_dim,
                kernel_init=winit.kaiming_leaky_kernel, generator=generator, dtype=dtype))
        self.to_rgb = TorchLinear(hidden_dim if hidden_layers else in_dim, rgb_dim,
                                  generator=generator, dtype=dtype)
        self.hidden_layers = hidden_layers

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.hidden_layers):
            x = F.leaky_relu(getattr(self, f"fc_{i}")(x), 0.2)
        return torch.tanh(self.to_rgb(x))


class ModulatedFCConv(nn.Module):
    """StyleGAN2 modulated FC with equalized lr: the raw (in, out) weight
    is scaled by ``scale`` (default 1/sqrt(in)); the modulation is an
    EqualLinear with bias 1 that receives this layer's ``scale`` too (as in
    the reference); demodulation sums in f32 with eps 1e-8."""

    def __init__(self, in_channel: int, out_channel: int, style_dim: int,
                 demodulate: bool = True, scale: Optional[float] = None, eps: float = 1e-8,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(winit.normal_kernel(1.0)((in_channel, out_channel), generator))
        self.modulation = EqualLinear(style_dim, in_channel, bias_init_value=1.0, scale=scale,
                                      generator=generator, dtype=dtype)
        self.scale = scale if scale is not None else 1.0 / math.sqrt(in_channel)
        self.demodulate = demodulate
        self.eps = eps
        self.dtype = dtype

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        squeeze = x.dim() == 2
        if squeeze:
            x = x[:, None, :]
        s = self.modulation(style)
        w = self.weight.to(self.dtype) * self.scale
        out = (x.to(self.dtype) * s[:, None, :]) @ w
        if self.demodulate:
            denom = (s.float() ** 2) @ (w.float() ** 2)
            out = out * torch.rsqrt(denom + self.eps)[:, None, :].to(self.dtype)
        return out[:, 0] if squeeze else out


#: resolutions of INRNetwork_Skip_Prog
PROG_RESOLUTIONS = ("16", "32", "64", "128", "256", "512", "1024")


class INRNetworkSkipProg(nn.Module):
    """Progressive FiLM decoder: blocks keyed by resolution, a residual
    skip where the widths match, per-block ToRGB (frequency_init(100))
    accumulation, exit at ``img_size``, tanh.  Style keys
    ``{prefix}_w{res}_0`` / ``{prefix}_w{res}_1``."""

    def __init__(self, in_dim: int, style_dim: int, dim_scale: float = 1.0, rgb_dim: int = 3,
                 name_prefix: str = "inr", generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ch = int(256 * dim_scale)
        for i, res in enumerate(PROG_RESOLUTIONS):
            self.add_module(f"film_{res}_0", FiLMSineLayer(in_dim if i == 0 else ch, ch,
                                                           style_dim, generator=generator,
                                                           dtype=dtype))
            self.add_module(f"film_{res}_1", FiLMSineLayer(ch, ch, style_dim,
                                                           generator=generator, dtype=dtype))
            self.add_module(f"to_rgb_{res}", TorchLinear(
                ch, rgb_dim, kernel_init=winit.frequency_kernel(100.0), generator=generator,
                dtype=dtype))
        self.name_prefix = name_prefix

    def forward(self, x: torch.Tensor, style_dict: Mapping[str, torch.Tensor],
                img_size: int = 1024) -> torch.Tensor:
        p, stop, rgb = self.name_prefix, _stop(img_size), None
        for res in PROG_RESOLUTIONS:
            x_orig = x
            x = getattr(self, f"film_{res}_0")(x, style_dict[f"{p}_w{res}_0"])
            x = getattr(self, f"film_{res}_1")(x, style_dict[f"{p}_w{res}_1"])
            if x.shape[-1] == x_orig.shape[-1]:
                x = x + x_orig
            out = getattr(self, f"to_rgb_{res}")(x)
            rgb = out if rgb is None else rgb + out
            if res == stop:
                break
        return torch.tanh(rgb)


class CLNBlock(nn.Module):
    """Two (Linear → CLN → LeakyReLU) stages, with a residual skip when
    asked for and the widths match."""

    def __init__(self, in_dim: int, out_dim: int, style_dim: int,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.linear1 = TorchLinear(in_dim, out_dim, generator=generator, dtype=dtype)
        self.cln1 = CLN(out_dim, style_dim, generator=generator, dtype=dtype)
        self.linear2 = TorchLinear(out_dim, out_dim, generator=generator, dtype=dtype)
        self.cln2 = CLN(out_dim, style_dim, generator=generator, dtype=dtype)

    def forward(self, x: torch.Tensor, style0: torch.Tensor, style1: torch.Tensor,
                skip: bool = False) -> torch.Tensor:
        out = F.leaky_relu(self.cln1(self.linear1(x), style0), 0.2)
        out = F.leaky_relu(self.cln2(self.linear2(out), style1), 0.2)
        if skip and out.shape[-1] == x.shape[-1]:
            out = out + x
        return out


#: resolutions of INRNetwork_Skip_CLN
CLN_RESOLUTIONS = ("16", "32", "64", "128", "256", "512", "1024")


class INRNetworkSkipCLN(nn.Module):
    """CLN-conditioned progressive decoder: CLNBlocks keyed by resolution
    (skip from 128 on), per-block ToRGB (frequency_init(100)) accumulation,
    exit at ``img_size``, tanh.  Style keys ``{prefix}_w{res}_0`` /
    ``{prefix}_w{res}_1``."""

    def __init__(self, in_dim: int, style_dim: int, dim_scale: float = 1.0, rgb_dim: int = 3,
                 name_prefix: str = "inr", generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ch = int(256 * dim_scale)
        for i, res in enumerate(CLN_RESOLUTIONS):
            self.add_module(f"block_{res}", CLNBlock(in_dim if i == 0 else ch, ch, style_dim,
                                                     generator=generator, dtype=dtype))
            self.add_module(f"to_rgb_{res}", TorchLinear(
                ch, rgb_dim, kernel_init=winit.frequency_kernel(100.0), generator=generator,
                dtype=dtype))
        self.name_prefix = name_prefix

    def forward(self, x: torch.Tensor, style_dict: Mapping[str, torch.Tensor],
                img_size: int = 1024) -> torch.Tensor:
        p, stop, rgb = self.name_prefix, _stop(img_size), None
        for res in CLN_RESOLUTIONS:
            x = getattr(self, f"block_{res}")(x, style_dict[f"{p}_w{res}_0"],
                                              style_dict[f"{p}_w{res}_1"], skip=int(res) >= 128)
            out = getattr(self, f"to_rgb_{res}")(x)
            rgb = out if rgb is None else rgb + out
            if res == stop:
                break
        return torch.tanh(rgb)


#: resolutions of Linear_Skip_Prog
LINEAR_PROG_RESOLUTIONS = ("32", "64", "128", "256", "512", "1024")


class LinearSkipProg(nn.Module):
    """Style-free progressive decoder behind one CLN-conditioned input
    layer (style key ``{prefix}_w``): per-resolution Linear
    (frequency_init(25)) + LeakyReLU blocks, ToRGB accumulation, exit at
    ``img_size``, tanh."""

    def __init__(self, in_dim: int, style_dim: int, hidden_dim: int = 256, rgb_dim: int = 3,
                 name_prefix: str = "linear", generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cln_layer = CLNLayer(in_dim, hidden_dim, style_dim, generator=generator,
                                  dtype=dtype)
        for res in LINEAR_PROG_RESOLUTIONS:
            self.add_module(f"linear_{res}", TorchLinear(
                hidden_dim, hidden_dim, kernel_init=winit.frequency_kernel(25.0),
                generator=generator, dtype=dtype))
            self.add_module(f"to_rgb_{res}", TorchLinear(hidden_dim, rgb_dim,
                                                         generator=generator, dtype=dtype))
        self.name_prefix = name_prefix

    def forward(self, x: torch.Tensor, style_dict: Mapping[str, torch.Tensor],
                img_size: int = 1024) -> torch.Tensor:
        stop, rgb = _stop(img_size), None
        x = self.cln_layer(x, style_dict[f"{self.name_prefix}_w"])
        for res in LINEAR_PROG_RESOLUTIONS:
            x = F.leaky_relu(getattr(self, f"linear_{res}")(x), 0.2)
            out = getattr(self, f"to_rgb_{res}")(x)
            rgb = out if rgb is None else rgb + out
            if res == stop:
                break
        return torch.tanh(rgb)


class ModSinLayer(nn.Module):
    """RMS-normalize, then ``lrelu((gain_fc(style) + 1) * x + bias_fc(style))``;
    with ``use_sine``, ``sin(freq * x + phase) * (gain_fc(style) + 1)`` (that
    variant has no ``bias_fc``)."""

    def __init__(self, in_dim: int, style_dim: int, use_sine: bool = False, freq: float = 1.0,
                 phase: float = 0.0, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.gain_fc = TorchLinear(style_dim, in_dim, generator=generator, dtype=dtype)
        if not use_sine:
            self.bias_fc = TorchLinear(style_dim, in_dim, generator=generator, dtype=dtype)
        self.use_sine, self.freq, self.phase = use_sine, freq, phase

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        gain = self.gain_fc(style) + 1.0
        if x.dim() == 3:
            gain = gain[:, None, :]
        if self.use_sine:
            return torch.sin(self.freq * x + self.phase) * gain
        bias = self.bias_fc(style)
        if x.dim() == 3:
            bias = bias[:, None, :]
        h = x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + 1e-8)
        return F.leaky_relu(h * gain + bias, 0.2)
