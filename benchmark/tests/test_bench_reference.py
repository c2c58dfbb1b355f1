"""The frozen reference against the program's plain path at a tiny size on
the CPU: the same weights and generator state give the same images, logits
and training step.  This file alone imports both."""

import dataclasses

import pytest
import torch

import harness
from reference.discriminator import DiscriminatorMultiScaleAux as RefD
from reference.generator import Generator as RefG
from reference.generator import GeneratorConfig as RefGCfg
from reference.generator import RenderOptions as RefOpts
from reference.generator import sample_zs as ref_zs

GEN = dict(z_dim_nerf=16, z_dim_inr=32, nerf_hidden_dim=16, nerf_style_dim=16,
           nerf_mapping_layers=2, inr_hidden_dim=32, inr_style_dim=32, inr_mapping_layers=2,
           nerf_rgb_dim=8)
DISC = dict(max_size=16, channels_override={4: 16, 8: 16, 16: 16})


def _pair(fast_sin, freeze_nerf=False):
    from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR

    cfg = dict(GEN, fast_sin=fast_sin, freeze_nerf=freeze_nerf)
    ref = harness.seeded_modules(lambda g: RefG(RefGCfg(**cfg), generator=g), 5, "cpu")
    prog = GeneratorNerfINR(GeneratorConfig(**cfg))
    harness.load_weights(prog, ref.state_dict())
    return ref, prog


@pytest.mark.parametrize("fast_sin", [True, False])
@pytest.mark.parametrize("noise", [0.0, 0.5])
def test_generator_forward_matches(fast_sin, noise):
    from cips3d_tpu_torch.models.generator import RenderOptions, sample_zs

    ref, prog = _pair(fast_sin)
    zs = sample_zs(2, prog.cfg, torch.Generator().manual_seed(1))
    want = ref(ref_zs(2, ref.cfg, torch.Generator().manual_seed(1)),
               RefOpts(img_size=16, num_steps=3, nerf_noise=noise),
               torch.Generator().manual_seed(2), return_aux_img=True)
    got, _ = prog(zs, RenderOptions(img_size=16, num_steps=3, nerf_noise=noise),
                  torch.Generator().manual_seed(2), return_aux_img=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("aux", [False, True])
def test_discriminator_and_r1_match(aux):
    from cips3d_tpu_torch.models.discriminator import DiscriminatorMultiScaleAux
    from cips3d_tpu_torch.train import losses

    ref = harness.seeded_modules(lambda g: RefD(diffaug=True, **DISC, generator=g), 6, "cpu")
    prog = DiscriminatorMultiScaleAux(diffaug=True, **DISC)
    harness.load_weights(prog, ref.state_dict())
    x = torch.randn(4, 3, 16, 16, generator=torch.Generator().manual_seed(3))
    from reference import losses as ref_losses
    from reference.discriminator import draw_disc_diffaug

    da = draw_disc_diffaug(4, 16, aux, torch.Generator().manual_seed(4))
    want = ref_losses.r1_penalty(lambda t: ref(t, 0.5, aux, True, da), x, 10.0)
    got = losses.r1_penalty(lambda t: prog(t, 0.5, aux, True, da), x, 10.0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_serving_frame_matches():
    """The reference's explicit-camera frame against the program's eager one."""
    import math

    from cips3d_tpu_torch.apps.serve import RenderService
    from reference.generator import render_frame, truncated_styles

    ref, prog = _pair(True)
    service = RenderService(prog.eval(), img_size=16, num_steps=3, forward_points=128)
    img, depth = service.render(seed=9, yaw=1.4, pitch=1.7, psi=0.7, dispatch="eager")
    zs = ref_zs(1, ref.cfg, torch.Generator().manual_seed(9))
    styles = truncated_styles(ref, zs, 0.7, ref_zs(2000, ref.cfg,
                                                   torch.Generator().manual_seed(0)))
    pos = torch.tensor([[math.sin(1.7) * math.cos(1.4), math.cos(1.7),
                         math.sin(1.7) * math.sin(1.4)]])
    want_img, want_depth = render_frame(
        ref, styles, RefOpts(img_size=16, num_steps=3, h_stddev=0.0, v_stddev=0.0),
        torch.Generator().manual_seed(9), pos, -pos, 128)
    torch.testing.assert_close(img, want_img, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(depth, want_depth, rtol=1e-5, atol=1e-6)
