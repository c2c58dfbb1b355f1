"""The pi-GAN baseline: counterpart of `cips3d_tpu/models/pigan.py`.

  * `PiGANFiLMLayer`, `CustomMappingNetwork` (one MLP emits every layer's
    frequencies and phases; freq = raw * 15 + 30; the last weight x 0.25),
    `SpatialSirenBaseline` (8 FiLM layers → sigma; colour FiLM on [dirs, x]
    → sigmoid RGB; ``use_box_warp=False`` is TALLSIREN) and
    `ImplicitGenerator3d` (camera and rays, coarse, hierarchical fine,
    sort-free compositing, pixels * 2 - 1), on the port's `core/`;
  * `CoordConv`, `ResidualCoordConvBlock` and `ProgressiveDiscriminator`
    (a CoordConv residual pyramid with an alpha fade-in;
    ``predict_encodings`` adds the latent and position heads of the encoder
    D).

State dicts use the reference pi-GAN's layout (``siren.network.{i}.layer``,
``siren.mapping_network.network.{0,2,4,6}``, ``layers.{i}.network.{0,2}
.conv``, ``layers.{i}.proj``, ``fromRGB.{i}.model.0``, ``final_layer``);
`utils/convert.py` maps them to the JAX trees.  The D holds all 8 blocks
and 9 input convs; a call at size s runs the blocks from `PIGAN_START[s]`
on (the JAX D creates only those).  Random draws come in as `PiGANDraws`
or from a `torch.Generator`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cips3d_tpu_torch.core import rays as rays_lib
from cips3d_tpu_torch.core import volume
from cips3d_tpu_torch.models import init as winit
from cips3d_tpu_torch.models.generator import RenderOptions
from cips3d_tpu_torch.models.layers import TorchLinear, uniform_box_warp


def first_layer_kernel(shape, generator=None) -> torch.Tensor:
    """first_layer_film_sine_init on an (in, out) kernel: U(-1/in, 1/in)."""
    return (torch.rand(tuple(shape), generator=generator) * 2.0 - 1.0) / shape[0]


class PiGANFiLMLayer(nn.Module):
    """sin(freq * (W x + b) + phase)."""

    def __init__(self, in_dim: int, hidden_dim: int, first_layer: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kinit = first_layer_kernel if first_layer else winit.frequency_kernel(25.0)
        self.layer = TorchLinear(in_dim, hidden_dim, kernel_init=kinit, generator=generator)

    def forward(self, x, freq, phase):
        h = self.layer(x)
        if x.dim() == 3:
            freq, phase = freq[:, None, :], phase[:, None, :]
        return torch.sin(freq * h + phase)


class CustomMappingNetwork(nn.Module):
    """z → (frequencies, phase shifts): 3 x (linear, leaky ReLU 0.2), linear."""

    def __init__(self, z_dim: int, map_hidden_dim: int, map_output_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        layers = []
        for i in range(3):
            layers += [TorchLinear(z_dim if i == 0 else map_hidden_dim, map_hidden_dim,
                                   kernel_init=winit.kaiming_leaky_kernel, generator=generator),
                       nn.LeakyReLU(0.2)]
        layers.append(TorchLinear(map_hidden_dim, map_output_dim,
                                  kernel_init=winit.scaled_kernel(winit.kaiming_leaky_kernel, 0.25),
                                  generator=generator))
        self.network = nn.Sequential(*layers)

    def forward(self, z):
        out = self.network(z)
        half = out.shape[-1] // 2
        return out[..., :half], out[..., half:]


class SpatialSirenBaseline(nn.Module):
    """The pi-GAN SIREN (SPATIALSIRENBASELINE; TALLSIREN without the box
    warp)."""

    def __init__(self, z_dim: int = 256, hidden_dim: int = 256, n_layers: int = 8,
                 use_box_warp: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.hidden_dim, self.use_box_warp = hidden_dim, use_box_warp
        self.network = nn.ModuleList(
            PiGANFiLMLayer(3 if i == 0 else hidden_dim, hidden_dim, first_layer=i == 0, generator=g)
            for i in range(n_layers))
        self.final_layer = TorchLinear(hidden_dim, 1, kernel_init=winit.frequency_kernel(25.0),
                                       generator=g)
        self.color_layer_sine = PiGANFiLMLayer(hidden_dim + 3, hidden_dim, generator=g)
        self.color_layer_linear = nn.Sequential(TorchLinear(
            hidden_dim, 3, kernel_init=winit.frequency_kernel(25.0), generator=g))
        self.mapping_network = CustomMappingNetwork(z_dim, 256, (n_layers + 1) * hidden_dim * 2,
                                                    generator=g)

    def forward(self, points, z, ray_directions):
        freqs, phases = self.mapping_network(z)
        return self.forward_with_frequencies(points, freqs, phases, ray_directions)

    def forward_with_frequencies(self, points, frequencies, phase_shifts, ray_directions):
        """points, dirs (b, n, 3) → rgb and sigma (b, n, 4)."""
        frequencies = frequencies * 15.0 + 30.0
        x = uniform_box_warp(points) if self.use_box_warp else points
        h = self.hidden_dim
        for i, layer in enumerate(self.network):
            x = layer(x, frequencies[..., i * h:(i + 1) * h], phase_shifts[..., i * h:(i + 1) * h])
        sigma = self.final_layer(x)
        c = self.color_layer_sine(torch.cat([ray_directions, x], -1), frequencies[..., -h:],
                                  phase_shifts[..., -h:])
        return torch.cat([torch.sigmoid(self.color_layer_linear(c)), sigma], -1)


class PiGANDraws(NamedTuple):
    """Every random draw of one `ImplicitGenerator3d.forward` (float32)."""

    perturb: torch.Tensor   # (b, n, S, 1) depth-jitter uniforms
    camera: tuple           # the pose draws of `rays.draw_camera` for opts.sample_dist
    u: torch.Tensor         # (b * n, S) importance-sample uniforms
    nc: torch.Tensor        # (b, n, S, 1) resample density noise, standard normal
    nf: torch.Tensor        # (b, n, 2S, 1) compositing density noise ((b, n, S, 1) without
    #                         hierarchical sampling)


def draw_pigan(b: int, opts: RenderOptions, generator: Optional[torch.Generator] = None,
               device=None) -> PiGANDraws:
    n, s = opts.img_size ** 2, opts.num_steps
    m = 2 * s if opts.hierarchical_sample else s
    return PiGANDraws(torch.rand((b, n, s, 1), generator=generator, device=device),
                      rays_lib.draw_camera(b, opts.sample_dist, generator, device),
                      torch.rand((b * n, s), generator=generator, device=device),
                      torch.randn((b, n, s, 1), generator=generator, device=device),
                      torch.randn((b, n, m, 1), generator=generator, device=device))


class ImplicitGenerator3d(nn.Module):
    """pi-GAN generator: SIREN + volume rendering."""

    def __init__(self, z_dim: int = 256, hidden_dim: int = 256, use_box_warp: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.z_dim, self.hidden_dim = z_dim, hidden_dim
        self.siren = SpatialSirenBaseline(z_dim, hidden_dim, use_box_warp=use_box_warp,
                                          generator=generator)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def mapping(self, z):
        return self.siren.mapping_network(z)

    def forward(self, z: torch.Tensor, opts: RenderOptions,
                generator: Optional[torch.Generator] = None, draws: Optional[PiGANDraws] = None,
                freqs_phases: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """(imgs (b, 3, H, W) in [-1, 1], pitch_yaw (b, 2))."""
        b, s = z.shape[0], opts.num_steps
        if draws is None:
            draws = draw_pigan(b, opts, generator, z.device)
        noise = opts.nerf_noise   # a number, or the step's 0-d schedule tensor
        world = rays_lib.get_world_points_and_direction(
            b, s, opts.img_size, opts.fov, opts.ray_start, opts.ray_end, opts.h_stddev,
            opts.v_stddev, opts.h_mean, opts.v_mean, opts.sample_dist,
            opts.lock_view_dependence, device=z.device, perturb_uniform=draws.perturb,
            camera_draws=draws.camera)
        n = world.points.shape[1]
        freqs, phases = freqs_phases if freqs_phases is not None else self.mapping(z)
        dirs = world.dirs_expanded.reshape(b, n * s, 3)

        def siren(pts):
            return self.siren.forward_with_frequencies(
                pts.reshape(b, n * s, 3), freqs, phases, dirs).reshape(b, n, s, 4)

        coarse = siren(world.points)
        if opts.hierarchical_sample:
            fine_pts, fine_z = volume.get_fine_points(
                draws.u, coarse, world.z_vals, 3, opts.clamp_mode, noise, s, world.origins,
                world.dirs, noise=draws.nc)
            fine = siren(fine_pts)
            all_out = torch.cat([fine, coarse], -2)
            pixels, _, _ = volume.volume_render_unsorted(
                all_out[..., :3], all_out[..., 3:], torch.cat([fine_z, world.z_vals], -2),
                noise=draws.nf, noise_std=noise, last_back=opts.last_back,
                white_back=opts.white_back, clamp_mode=opts.clamp_mode)
        else:
            pixels, _, _ = volume.volume_render(
                coarse, world.z_vals, noise=draws.nf, noise_std=noise, dim_rgb=3,
                last_back=opts.last_back, white_back=opts.white_back, clamp_mode=opts.clamp_mode)
        h = w = opts.img_size
        imgs = pixels.transpose(1, 2).reshape(b, 3, h, w) * 2.0 - 1.0
        return imgs, torch.cat([world.pitch, world.yaw], -1)


# --------------------------------------------------------------------- #
# discriminators


def _conv(in_ch: int, out_ch: int, k: int, generator, padding: int = 0) -> nn.Conv2d:
    """A conv with torch's default weight distribution U(+-1/sqrt(fan_in))
    and a zero bias."""
    conv = nn.Conv2d(in_ch, out_ch, k, padding=padding)
    bound = 1.0 / math.sqrt(in_ch * k * k)
    with torch.no_grad():
        conv.weight.copy_((torch.rand(conv.weight.shape, generator=generator) * 2 - 1) * bound)
        conv.bias.zero_()
    return conv


class CoordConv(nn.Module):
    """Conv2d over the input with two coordinate channels appended, in the
    order [x, y over H, x over W], each linspace(-1, 1)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = _conv(in_ch + 2, out_ch, kernel_size, generator, padding=kernel_size // 2)

    def forward(self, x):
        b, _, hh, ww = x.shape
        yc = torch.linspace(-1.0, 1.0, hh, dtype=x.dtype, device=x.device)
        xc = torch.linspace(-1.0, 1.0, ww, dtype=x.dtype, device=x.device)
        return self.conv(torch.cat([x, yc[None, None, :, None].expand(b, 1, hh, ww),
                                    xc[None, None, None, :].expand(b, 1, hh, ww)], 1))


class ResidualCoordConvBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, downsample: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.network = nn.Sequential(CoordConv(inplanes, planes, generator=generator),
                                     nn.LeakyReLU(0.2),
                                     CoordConv(planes, planes, generator=generator),
                                     nn.LeakyReLU(0.2))
        self.downsample = downsample
        self.proj = _conv(inplanes, planes, 1, generator) if inplanes != planes else None

    def forward(self, x):
        y, identity = self.network(x), x
        if self.downsample:
            y, identity = F.avg_pool2d(y, 2), F.avg_pool2d(identity, 2)
        if self.proj is not None:
            identity = self.proj(identity)
        return (y + identity) / math.sqrt(2)


class AdapterBlock(nn.Module):
    """1x1 conv from RGB (the leaky ReLU runs in the discriminator)."""

    def __init__(self, out_ch: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.model = nn.Sequential(_conv(3, out_ch, 1, generator))

    def forward(self, x):
        return F.leaky_relu(self.model(x), 0.2)


PIGAN_PLANES = (16, 32, 64, 128, 256, 400, 400, 400, 400)
PIGAN_OUT = (32, 64, 128, 256, 400, 400, 400, 400)
#: the first block an image of each size enters
PIGAN_START = {2: 8, 4: 7, 8: 6, 16: 5, 32: 4, 64: 3, 128: 2, 256: 1, 512: 0}


class ProgressiveDiscriminator(nn.Module):
    """CoordConv progressive D; ``predict_encodings`` gives the encoder
    variant, whose 2x2 valid final conv emits 1 + 256 + 2 channels (logit,
    latent, position).  Returns (logit (b, 1), latent or None, position or
    None)."""

    def __init__(self, predict_encodings: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.predict_encodings = predict_encodings
        self.layers = nn.ModuleList(
            ResidualCoordConvBlock(PIGAN_PLANES[i], PIGAN_OUT[i], downsample=True, generator=g)
            for i in range(8))
        self.fromRGB = nn.ModuleList(AdapterBlock(c, generator=g) for c in PIGAN_PLANES)
        self.final_layer = _conv(400, (1 + 256 + 2) if predict_encodings else 1, 2, g)

    def forward(self, x, alpha=1.0):
        """(logit, latent, position); ``alpha`` a number or the step's 0-d
        fade-in tensor."""
        size = x.shape[-1]
        start = PIGAN_START[size]
        h = self.fromRGB[start](x)
        for i, blk in enumerate(self.layers[start:]):
            if i == 1:
                # the JAX package's nearest halving keeps pixels 2i + 1
                h = alpha * h + (1 - alpha) * self.fromRGB[start + 1](x[..., 1::2, 1::2])
            h = blk(h)
        out = self.final_layer(h).reshape(x.shape[0], -1)
        if self.predict_encodings:
            return out[:, 0:1], out[:, 1:257], out[:, 257:259]
        return out[:, 0:1], None, None
