"""The port's discriminator (`cips3d_tpu_torch/models/discriminator.py`)
and R1 penalty against the JAX package.

A narrow channel table (as `tests/test_discriminator.py`), JAX init bridged
into the port with `utils/convert.py`; the same numpy inputs go through
both.  Tolerances: logits rtol 1e-4 / atol 1e-5 (f32 convolutions summed in
another order); gradients by the normalised error max|a-b| / (max|b| + 1)
< 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cips3d_tpu.models.discriminator import Discriminator as JaxFixedD
from cips3d_tpu.models.discriminator import DiscriminatorMultiScaleAux as JaxD
from cips3d_tpu.models.layers import minibatch_stddev as jax_minibatch_stddev
from cips3d_tpu.ops.upfirdn2d import blur_pad_up, make_kernel, upfirdn2d as jax_upfirdn2d
from cips3d_tpu.train import losses as jax_losses
from cips3d_tpu_torch.models import discriminator as disc
from cips3d_tpu_torch.models.layers import EqualConvTranspose2d, minibatch_stddev
from cips3d_tpu_torch.ops import upfirdn2d as port_upfirdn
from cips3d_tpu_torch.train import losses
from cips3d_tpu_torch.utils.convert import discriminator_state_dict, load_jax_d_params

TINY = {4: 16, 8: 16, 16: 16, 32: 16, 64: 16, 128: 16, 256: 16, 512: 16, 1024: 16}
TOL = dict(rtol=1e-4, atol=1e-5)


def _grad_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1.0)


@pytest.fixture(scope="module")
def pair():
    jd = JaxD(max_size=32, channels_override=TINY)
    params = jd.init(jax.random.PRNGKey(0), jnp.zeros((2, 3, 8, 8)), method=jd.init_all)
    params = jax.tree_util.tree_map(np.asarray, params)
    port = disc.DiscriminatorMultiScaleAux(max_size=32, channels_override=TINY)
    load_jax_d_params(port, params)
    return jd, params, port


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_bridge_covers_every_parameter(pair):
    _, params, port = pair
    assert sorted(discriminator_state_dict(params)) == sorted(port.state_dict())


@pytest.mark.parametrize("size,alpha,fade_in,aux", [
    (16, 1.0, False, False), (32, 0.3, True, True), (16, 0.7, True, False), (8, 1.0, True, True),
], ids=["r16", "r32-fade-aux", "r16-fade", "r8-aux"])
def test_logits_match_jax(pair, size, alpha, fade_in, aux):
    jd, params, port = pair
    x = _x((4, 3, size, size), size)
    ref = jd.apply(params, jnp.asarray(x), alpha, use_aux_disc=aux, fade_in=fade_in)
    with torch.no_grad():
        out = port(torch.from_numpy(x), alpha, use_aux_disc=aux, fade_in=fade_in)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_aux_split_halves_the_batch(pair):
    _, _, port = pair
    x = torch.from_numpy(_x((4, 3, 16, 16), 1))
    with torch.no_grad():
        both = port(x, 1.0, use_aux_disc=True)
        main = port.main_disc(x[:2])
        aux = port.aux_disc(x[2:])
    torch.testing.assert_close(both, torch.cat([main, aux]))


def test_fade_in_resize_matches_jax():
    x = _x((2, 3, 16, 16), 2)
    ref = jax.image.resize(jnp.asarray(x), (2, 3, 8, 8), method="bilinear")
    out = disc.resize_bilinear(torch.from_numpy(x), 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d_reg_every", [1, 4])
def test_r1_penalty_and_its_grads_match_jax(pair, d_reg_every):
    """R1's value, and the D-parameter gradient of the penalized loss (a
    gradient of a gradient through the blurs and the fade-in)."""
    jd, params, port = pair
    x = _x((4, 3, 16, 16), 3)

    def loss_jax(p):
        pen, logits = jax_losses.r1_penalty(
            lambda xx: jd.apply(p, xx, 0.6, use_aux_disc=True, fade_in=True),
            jnp.asarray(x), 10.0, d_reg_every)
        return jnp.mean(pen + jax.nn.softplus(-logits)), pen

    (_, pen_ref), g_ref = jax.value_and_grad(loss_jax, has_aux=True)(params)
    pen, logits = losses.r1_penalty(lambda xx: port(xx, 0.6, use_aux_disc=True, fade_in=True),
                                    torch.from_numpy(x), 10.0, d_reg_every)
    np.testing.assert_allclose(pen.detach().numpy(), np.asarray(pen_ref), rtol=1e-4, atol=1e-6)
    loss = (pen + torch.nn.functional.softplus(-logits)).mean()
    grads = torch.autograd.grad(loss, list(port.parameters()), allow_unused=True)
    ref = discriminator_state_dict(g_ref)
    for (name, p), g in zip(port.named_parameters(), grads):   # unused heads: zero grads
        g = torch.zeros_like(p) if g is None else g
        assert _grad_err(g.numpy(), ref[name]) < 1e-4, name


def test_minibatch_stddev_and_fixed_d_match_jax():
    x = _x((8, 6, 4, 4), 4)
    np.testing.assert_allclose(minibatch_stddev(torch.from_numpy(x), 4).numpy(),
                               np.asarray(jax_minibatch_stddev(jnp.asarray(x), 4)), **TOL)
    jd = JaxFixedD(size=16, channels_override=TINY)
    xi = _x((4, 3, 16, 16), 5)
    params = jax.tree_util.tree_map(np.asarray, jd.init(jax.random.PRNGKey(1), jnp.asarray(xi)))
    port = disc.Discriminator(size=16, channels_override=TINY)
    p = params["params"]
    sd = discriminator_state_dict({k: v for k, v in p.items()
                                   if not k.startswith(("first_", "res_"))})
    sd.update({f"res.{k[4:]}.{n}": v for k, sub in p.items() if k.startswith("res_")
               for n, v in discriminator_state_dict(sub).items()})
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        out = port(torch.from_numpy(xi))
    np.testing.assert_allclose(out.numpy(), np.asarray(jd.apply(params, jnp.asarray(xi))), **TOL)


def test_upsampling_conv_layer_matches_upfirdn_spec():
    """ConvLayer(upsample): transposed conv then the x4 blur, against the
    JAX upfirdn2d on the transposed-conv output."""
    layer = disc.ConvLayer(4, 6, 3, upsample=True, activate=False, use_bias=False,
                           generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x((2, 4, 8, 8), 6))
    with torch.no_grad():
        out = layer(x)
        mid = layer.conv(x)
    k = make_kernel((1, 3, 3, 1)) * 4.0
    ref = jax_upfirdn2d(jnp.asarray(mid.numpy()), k,
                                pad=blur_pad_up((1, 3, 3, 1), 3))
    assert out.shape == (2, 6, 16, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert isinstance(layer.conv, EqualConvTranspose2d)
    np.testing.assert_allclose(
        port_upfirdn.upfirdn2d(mid, port_upfirdn.make_kernel((1, 3, 3, 1)), down=2,
                               pad=(1, 1)).numpy(),
        np.asarray(jax_upfirdn2d(jnp.asarray(mid.numpy()),
                                         make_kernel((1, 3, 3, 1)), down=2,
                                         pad=(1, 1))), **TOL)


@pytest.mark.parametrize("kernel", ["blur", "blur_x4_asymmetric"])
@pytest.mark.parametrize("down,pad", [(2, (2, 1)), (1, (2, 1)), (1, (-1, -1))])
def test_upfirdn2d_matches_jax(kernel, down, pad):
    """The banded products against JAX, for separable kernels."""
    k = (make_kernel((1, 3, 3, 1)) if kernel == "blur"
         else np.outer([1, 2, 1], [1, 3, 3, 2]).astype(np.float32) * 4.0)
    x = _x((2, 3, 9, 9), 7)
    ref = jax_upfirdn2d(jnp.asarray(x), k, 1, down, pad)
    out = port_upfirdn.upfirdn2d(torch.from_numpy(x), k, down, pad)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=2e-6)


def test_upfirdn2d_rejects_non_separable_kernel():
    k = np.outer([1, 2, 1], [1, 0, -1]).astype(np.float32) + np.eye(3, dtype=np.float32)
    with pytest.raises(NotImplementedError, match="separable"):
        port_upfirdn.upfirdn2d(torch.zeros(1, 1, 5, 5), k)


def test_diffaug_is_not_ported():
    """DiffAug is ported (this test held the raise before): a D built with
    it augments only when a call brings draws, and then differs from the
    plain D on the same parameters; a D without it ignores draws."""
    g = torch.Generator().manual_seed(0)
    d_aug = disc.DiscriminatorMultiScaleAux(max_size=16, diffaug=True, channels_override=TINY,
                                            generator=g)
    d_plain = disc.DiscriminatorMultiScaleAux(max_size=16, channels_override=TINY)
    d_plain.load_state_dict(d_aug.state_dict())
    x = torch.rand((4, 3, 16, 16), generator=g) * 2 - 1
    draws = disc.draw_disc_diffaug(4, 16, True, g)
    with torch.no_grad():
        plain = d_plain(x, use_aux_disc=True, diffaug=draws)
        torch.testing.assert_close(d_aug(x, use_aux_disc=True), plain)
        assert not torch.allclose(d_aug(x, use_aux_disc=True, diffaug=draws), plain)
