"""The port's counterparts of the JAX package's smaller helpers, each
against its JAX function on seeded numpy inputs: `upfirdn2d_general` (up
and down per axis, negative pads, a non-separable kernel),
`LayerNormTorch`, `load_pytree_like`, `FiLMLeakyLayer`,
`MultiHeadMappingNetworkEqualLR` (its JAX parameters through
`utils/convert.py`), `uniform_pm` and `presin_kernel` (by their bounds and
shapes: torch cannot reproduce `jax.random`), `batch_gather_points` and
`batch_scatter_points` (bit for bit).

Tolerances: f32 rtol 1e-5 / atol 2e-6 for upfirdn2d (as
`tests/test_torch_discriminator.py`), rtol 1e-4 / atol 1e-5 for the
LayerNorm, rtol 1e-5 / atol 1e-6 for the FiLM layer and the mapping; bf16
within one bf16 rounding (2^-8 relative) of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cips3d_tpu.models.layers import LayerNormTorch as JaxLayerNorm
from cips3d_tpu.ops.upfirdn2d import upfirdn2d_general as jax_upfirdn2d_general
from cips3d_tpu.utils.checkpoint import load_pytree_like as jax_load_pytree_like
from cips3d_tpu_torch.models.layers import LayerNormTorch
from cips3d_tpu_torch.ops import upfirdn2d as port_upfirdn
from cips3d_tpu_torch.utils.checkpoint import load_pytree_like, save_pytree
from cips3d_tpu_torch.utils.convert import tree_state_dict


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------- upfirdn2d_general

KERNELS = {
    "blur": np.outer([1, 3, 3, 1], [1, 3, 3, 1]).astype(np.float32) / 64.0,
    "asymmetric": np.outer([1, 2, 1], [1, 3, 3, 2]).astype(np.float32) * 4.0,
    "non_separable": (np.outer([1, 2, 1], [1, 0, -1]) + np.eye(3)).astype(np.float32),
    "identity": np.ones((1, 1), np.float32),
}
# (up_x, up_y, down_x, down_y, pad_x0, pad_x1, pad_y0, pad_y1): tests/test_ops.py's cases,
# negative pads, and factors and pads that differ per axis
UPFIRDN_CASES = {
    "same": (1, 1, 1, 1, 2, 1, 2, 1),
    "down2": (1, 1, 2, 2, 2, 2, 2, 2),
    "up2": (2, 2, 1, 1, 2, 1, 2, 1),
    "no_pad": (1, 1, 1, 1, 0, 0, 0, 0),
    "up2_down2": (2, 2, 2, 2, 3, 1, 3, 1),
    "negative_pad": (1, 1, 1, 1, -1, -1, -1, -1),
    "per_axis": (2, 1, 1, 2, 1, 2, 0, 3),
}


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("case", list(UPFIRDN_CASES))
def test_upfirdn2d_general_matches_jax(case, kernel):
    args = UPFIRDN_CASES[case]
    k = KERNELS[kernel]
    x = _x((2, 3, 10, 9), 1)
    ref = jax_upfirdn2d_general(jnp.asarray(x), k, *args)
    out = port_upfirdn.upfirdn2d_general(t(x), k, *args)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("case", ["down2", "up2_down2", "per_axis"])
def test_upfirdn2d_bf16_rounds_where_jax_rounds(case):
    """bf16: the banded matrices in bf16, products accumulated in f32 and
    rounded back after each axis, as the JAX einsums with
    preferred_element_type=float32: within one bf16 rounding of JAX's."""
    x = _x((2, 4, 8, 8), 2)
    args = UPFIRDN_CASES[case]
    ref = jax_upfirdn2d_general(jnp.asarray(x, jnp.bfloat16), KERNELS["blur"], *args)
    out = port_upfirdn.upfirdn2d_general(t(x).bfloat16(), KERNELS["blur"], *args)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -8, atol=1e-6)


def test_upfirdn2d_callers_are_unchanged_and_double_differentiable():
    """The discriminator's blurs (`upfirdn2d` with one pad) give the two
    banded products of the port's earlier lowering bit for bit, and the
    gradient of a gradient through them matches JAX's (R1)."""
    x = t(_x((2, 3, 9, 9), 3))
    k = port_upfirdn.make_kernel((1, 3, 3, 1))
    for down, pad in ((2, (2, 1)), (1, (2, 1)), (1, (-1, -1))):
        u, s, vt = np.linalg.svd(k)
        my = torch.as_tensor(port_upfirdn._axis_matrix(9, tuple((u[:, 0] * s[0]).tolist()), 1,
                                                       down, *pad))
        mx = torch.as_tensor(port_upfirdn._axis_matrix(9, tuple(vt[0].tolist()), 1, down, *pad))
        before = torch.einsum("ncow,pw->ncop", torch.einsum("oh,nchw->ncow", my, x), mx)
        assert torch.equal(port_upfirdn.upfirdn2d(x, k, down, pad), before)

    x6 = _x((1, 1, 6, 6), 4)

    def jf(v):
        return jnp.sum(jax_upfirdn2d_general(v, k, 1, 1, 2, 2, 2, 1, 2, 1) ** 2)

    ref = jax.grad(lambda v: jnp.sum(jax.grad(jf)(v) ** 2))(jnp.asarray(x6))
    v = t(x6).requires_grad_(True)
    (g,) = torch.autograd.grad((port_upfirdn.upfirdn2d(v, k, 2, (2, 1)) ** 2).sum(), v,
                               create_graph=True)
    (gg,) = torch.autograd.grad((g ** 2).sum(), v)
    np.testing.assert_allclose(gg.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- LayerNorm

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_torch_matches_jax(dtype):
    """`LayerNormTorch`: statistics in f32, the result in the input's dtype;
    bf16 within one bf16 rounding of JAX's."""
    jdt, pdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = _x((2, 5, 12), 5) * 3 + 1
    ln = JaxLayerNorm()
    lp = ln.init(jax.random.PRNGKey(0), jnp.asarray(x))
    lp = jax.tree_util.tree_map(lambda a: a + 0.3 * jnp.asarray(_x(a.shape, 6)), lp)
    port_ln = LayerNormTorch(12)
    sd = tree_state_dict(lp)
    port_ln.load_state_dict({"weight": t(sd["LayerNorm_0.weight"]), "bias": t(sd["LayerNorm_0.bias"])})
    ref = np.asarray(ln.apply(lp, jnp.asarray(x, jdt)).astype(jnp.float32))
    got = port_ln(t(x).to(pdt))
    assert got.dtype == pdt
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == "float32" else dict(rtol=2 ** -8, atol=1e-2)
    np.testing.assert_allclose(got.detach().float().numpy(), ref, **tol)


# ---------------------------------------------------------------- checkpoints

def test_load_pytree_like_matches_jax_and_refuses_a_missing_key(tmp_path):
    """Grafts an .npz onto a nested reference (as the JAX function does,
    values cast to each leaf's dtype) and onto a state dict with dotted
    keys; a key the file lacks raises naming it, a shape that differs
    raises too."""
    rng = np.random.default_rng(10)
    tree = {"params": {"siren": {"film_0": {"kernel": rng.standard_normal((3, 4)),
                                            "bias": rng.standard_normal(4)}},
                       "step": np.arange(3, dtype=np.int32)}}
    path = str(tmp_path / "G.npz")
    save_pytree(path, tree)
    ref = {"params": {"siren": {"film_0": {"kernel": np.zeros((3, 4), np.float32),
                                           "bias": np.zeros(4, np.float32)}},
                      "step": np.zeros(3, np.int64)}}
    got = load_pytree_like(path, ref)
    want = jax_load_pytree_like(path, ref)
    for keys in (("siren", "film_0", "kernel"), ("siren", "film_0", "bias"), ("step",)):
        a, b = got["params"], want["params"]
        for k in keys:
            a, b = a[k], b[k]
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    sd = {"params.siren.film_0.kernel": torch.zeros(3, 4, dtype=torch.bfloat16)}
    flat = load_pytree_like(path, sd)
    assert flat["params.siren.film_0.kernel"].dtype == np.float32
    np.testing.assert_array_equal(flat["params.siren.film_0.kernel"],
                                  tree["params"]["siren"]["film_0"]["kernel"].astype(np.float32))
    with pytest.raises(KeyError, match=r"\['film_1'\]"):
        load_pytree_like(path, {"params": {"siren": {"film_1": {"kernel": np.zeros((3, 4))}}}})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_pytree_like(path, {"params.step": np.zeros(4)})


# ---------------------------------------------------------------- layers, mapping, inits, points

FWD = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rank", [2, 3])
def test_film_leaky_layer_matches_jax(rank):
    from cips3d_tpu.models.layers import FiLMLeakyLayer as JaxFiLMLeaky
    from cips3d_tpu_torch.models.layers import FiLMLeakyLayer

    x = _x((3, 7, 12) if rank == 3 else (3, 12), 11)
    style = _x((3, 9), 12)
    jl = JaxFiLMLeaky(out_dim=16)
    params = jl.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(style))
    port = FiLMLeakyLayer(12, 16, 9)
    port.load_state_dict({k: t(v) for k, v in tree_state_dict(params).items()})
    ref = jl.apply(params, jnp.asarray(x), jnp.asarray(style))
    np.testing.assert_allclose(port(t(x), t(style)).detach().numpy(), np.asarray(ref), **FWD)


@pytest.mark.parametrize("base_layers,head_layers,lr_mlp,scale", [
    (3, 2, 0.01, 0.01), (2, 0, 1.0, 0.5), (0, 2, 0.1, 1.0)])
def test_equal_lr_mapping_matches_jax(base_layers, head_layers, lr_mlp, scale):
    """Base stack with heads, base stack alone (its last layer without an
    activation), one z a head; parameters perturbed away from the init so
    that the biases count."""
    from cips3d_tpu.models.mapping import MultiHeadMappingNetworkEqualLR as JaxEqualLR
    from cips3d_tpu_torch.models.mapping import MultiHeadMappingNetworkEqualLR
    from cips3d_tpu_torch.utils.convert import mapping_equal_lr_state_dict

    heads = {"w_0": 6, "w_rgb": 5} if head_layers else {"w_0": 8, "w_1": 8}
    kw = dict(hidden_dim=8, base_layers=base_layers, head_layers=head_layers,
              head_dim_dict=heads, lr_mlp=lr_mlp, scale=scale)
    z = _x((len(heads), 4, 10) if base_layers == 0 else (4, 10), 13)
    jm = JaxEqualLR(**kw)
    params = jm.init(jax.random.PRNGKey(4), jnp.asarray(z))
    params = jax.tree_util.tree_map(lambda a: a + 0.1 * jnp.asarray(_x(a.shape, a.size)),
                                    params)
    port = MultiHeadMappingNetworkEqualLR(z_dim=10, **kw)
    port.load_state_dict({k: t(v) for k, v in mapping_equal_lr_state_dict(params).items()},
                         strict=True)
    ref = jm.apply(params, jnp.asarray(z))
    got = port(t(z))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(ref[k]), **FWD)


def test_uniform_pm_and_presin_kernel_bounds_and_shapes():
    """Both draw U(-b, b): the port's samples (b from the shape; sqrt(9/in)
    for the pre-sine kernel) have the shapes and bounds of the JAX
    package's, and both spread over the whole interval."""
    from cips3d_tpu.models import init as jinit
    from cips3d_tpu_torch.models import init as pinit

    def bound(shape):
        return 0.5 / shape[0]

    for shape in ((64, 32), (9, 300)):
        for jf, pf, b in ((jinit.uniform_pm(bound), pinit.uniform_pm(bound), bound(shape)),
                          (jinit.presin_kernel, pinit.presin_kernel, (9.0 / shape[0]) ** 0.5)):
            ref = np.asarray(jf(jax.random.PRNGKey(5), shape))
            got = pf(shape, torch.Generator().manual_seed(5))
            assert tuple(got.shape) == ref.shape == shape and got.dtype == torch.float32
            for a in (got.numpy(), ref):
                assert np.abs(a).max() <= b and np.abs(a).max() > 0.95 * b
                assert abs(a.mean()) < 0.1 * b


@pytest.mark.parametrize("trailing", [(3,), (4, 3), ()])
def test_batch_gather_scatter_match_jax_bit_for_bit(trailing):
    """`batch_gather_points` on (b, n, c) and (b, n, s, c), and
    `batch_scatter_points` of two gathered subsets (as
    `tests/test_volume.py` combines them) back to the input, (b, k) points
    included: equal to JAX's bit for bit."""
    from cips3d_tpu.core import points as jp
    from cips3d_tpu_torch.core import points as pp

    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 8) + trailing).astype(np.float32)
    perm = np.stack([rng.permutation(8) for _ in range(2)])
    ig, ino = perm[:, :3], perm[:, 3:]
    tig, tino = (torch.from_numpy(i.astype(np.int64)) for i in (ig, ino))
    if len(trailing) >= 1:
        for idx, tidx in ((ig, tig), (ino, tino)):
            np.testing.assert_array_equal(pp.batch_gather_points(t(x), tidx).numpy(),
                                          np.asarray(jp.batch_gather_points(jnp.asarray(x),
                                                                            jnp.asarray(idx))))
    if len(trailing) == 2:
        return   # the scatter merges (b, k, c) or (b, k) points
    pick = np.take_along_axis(x, ig.reshape(ig.shape + (1,) * len(trailing)), 1)
    rest = np.take_along_axis(x, ino.reshape(ino.shape + (1,) * len(trailing)), 1)
    ref = np.asarray(jp.batch_scatter_points(jnp.asarray(ig), jnp.asarray(pick),
                                             jnp.asarray(ino), jnp.asarray(rest), 8))
    grad_part = t(pick).requires_grad_()
    got = pp.batch_scatter_points(tig, grad_part, tino, t(rest), 8)
    np.testing.assert_array_equal(got.detach().numpy(), ref)
    np.testing.assert_array_equal(ref, x)
    (g,) = torch.autograd.grad((got * t(x)).sum(), grad_part)   # differentiable in points_grad
    np.testing.assert_array_equal(g.numpy(), pick)
