"""The work counts of `work/` against `FlopCounterMode` on the frozen
reference at a tiny size: each per-point or per-pixel count is the
difference of two counts that differ only in the number of points."""

import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from reference.cips_net import CIPSNet
from reference.generator import Generator, GeneratorConfig, RenderOptions, sample_zs
from reference.nerf_net import NeRFNetwork
from work import kernels, peaks

H, L, R, STYLE = 16, 2, 8, 16


def _flops(fn):
    with FlopCounterMode(display=False) as c:
        fn()
    return c.get_total_flops()


def _styles(prefix, layers, dim, b=1):
    g = torch.Generator().manual_seed(0)
    return {f"{prefix}_w{i}": torch.randn(b, dim, generator=g) for i in range(layers)}


@torch.no_grad()
def test_siren_macs_is_the_sirens_work_a_point():
    net = NeRFNetwork(hidden_dim=H, hidden_layers=L, rgb_dim=R, style_dim=STYLE,
                      generator=torch.Generator().manual_seed(1))
    styles = _styles("nerf", L, STYLE)
    styles["nerf_rgb"] = styles["nerf_w0"]

    def count(p):
        return _flops(lambda: net(torch.rand(1, p, 3), styles))

    assert count(64) - count(32) == 2 * 32 * kernels.siren_macs(H, L, H // 2, R)


@torch.no_grad()
def test_inr_tile_count_is_the_decodes_work_a_pixel():
    D = 32
    net = CIPSNet(input_dim=R, hidden_dim=D, style_dim=D,
                  generator=torch.Generator().manual_seed(2))
    styles = {f"inr_w{r}_{j}": torch.randn(1, D) for r in
              ("4", "8", "16", "32", "64", "128", "256", "512", "1024") for j in (0, 1)}

    def count(n):
        return _flops(lambda: net(torch.rand(1, n, R), styles))

    per_pixel = (count(64) - count(32)) // 32
    flops, _ = kernels.inr_tile(1, 1, R, D, 18, 6)
    assert per_pixel == flops


@torch.no_grad()
def test_pixel_macs_is_the_generators_work_a_pixel():
    cfg = GeneratorConfig(z_dim_nerf=16, z_dim_inr=32, nerf_hidden_dim=H, nerf_style_dim=STYLE,
                          nerf_mapping_layers=2, inr_hidden_dim=32, inr_style_dim=32,
                          inr_mapping_layers=2, nerf_rgb_dim=R)
    G = Generator(cfg, generator=torch.Generator().manual_seed(3))
    zs = sample_zs(1, cfg, torch.Generator().manual_seed(4))

    def count(img):
        opts = RenderOptions(img_size=img, num_steps=3)
        return _flops(lambda: G(zs, opts, torch.Generator().manual_seed(5)))

    per_pixel = (count(16) - count(8)) // (16 * 16 - 8 * 8)
    assert per_pixel == 2 * kernels.pixel_macs(dataclasses.asdict(cfg), 3)


@pytest.mark.parametrize("work", [kernels.ray_tile, kernels.ray_tile_residuals,
                                  kernels.ray_tile_bwd])
def test_ray_tile_counts_grow_with_the_rays(work):
    one = work(1, 1024, 12, 128, 2, 64, 32)
    two = work(2, 1024, 12, 128, 2, 64, 32)
    assert two[0] == 2 * one[0] and one[1] < two[1] < 2 * one[1]


def test_the_peaks_are_the_tf32_and_hbm_rates():
    assert peaks.F32_PRODUCT_FLOPS == 495e12 and peaks.HBM_BYTES == 3.35e12
    assert peaks.least_seconds(495e12, 0) == 1.0 and peaks.least_seconds(0, 3.35e12) == 1.0


def test_step_flops_counts_as_flop_counter_mode_and_sees_r1():
    from reference.discriminator import DiscriminatorMultiScaleAux
    from reference.step import StepSettings, Trainer
    from work.step import step_flops

    cfg = GeneratorConfig(z_dim_nerf=16, z_dim_inr=32, nerf_hidden_dim=H, nerf_style_dim=STYLE,
                          nerf_mapping_layers=2, inr_hidden_dim=32, inr_style_dim=32,
                          inr_mapping_layers=2, nerf_rgb_dim=R)
    G = Generator(cfg, generator=torch.Generator().manual_seed(6))
    zs = sample_zs(2, cfg, torch.Generator().manual_seed(7))
    opts = RenderOptions(img_size=16, num_steps=3)
    with torch.no_grad():
        assert step_flops(lambda: G(zs, opts, torch.Generator().manual_seed(8))) == _flops(
            lambda: G(zs, opts, torch.Generator().manual_seed(8)))
    D = DiscriminatorMultiScaleAux(max_size=16, channels_override={4: 16, 8: 16, 16: 16},
                                   generator=torch.Generator().manual_seed(9))
    real = torch.randint(0, 255, (2, 3, 16, 16), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(10))

    def count(r1):
        s = StepSettings(16, 2, 1e-4, 1e-4, 0.0, 0.999, r1, 1, 10.0, True, False, 10000, False,
                         0.999, 1000)
        trainer = Trainer(G, D, s, RenderOptions(num_steps=3))
        return step_flops(lambda: trainer.step(real, torch.Generator().manual_seed(11)))

    assert count(10.0) > count(0.0) > 0
