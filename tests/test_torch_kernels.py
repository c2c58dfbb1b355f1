"""The port's CUDA kernels against their plain PyTorch versions.

This file imports neither JAX nor `cips3d_tpu`, so it also runs on the
machine with the card, where JAX is absent:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

The ``gpu`` cases skip without a CUDA device (the kernels have no CPU
mode); the others check, on any machine, what surrounds the kernels.
Tolerances: f32 rtol 2e-4 / atol 2e-5 (the Pallas tests').  With bf16
matmul inputs both versions round the same values but sum in another order:
ray tile rtol 1e-2 / atol 3e-3 (5e-3 at the flagship widths, as in
`chip_smoke.py`: wider sums flip more bf16 roundings of the hidden states),
INR tile rtol 1e-2 / atol 1e-3 (1e-2 over 9 blocks of the ragged cases, with a
check that the kernel rounds where the plain version does), each tight
enough that the f32 kernel, which skips the rounding, fails it.  Backward:
weight and FiLM grads by the normalised error max|a-b| / (max|b| + 1) of
`tests/test_pallas_ray.py` (1e-4 in f32, 1e-2 with bf16 inputs, which the
f32 kernel fails), d pts per ray within 1e-4 (max|b| + 1).
"""

import shutil

import numpy as np
import pytest
import torch

from cips3d_tpu_torch.models.cips_net import CIPSNet
from cips3d_tpu_torch.models.nerf_net import NeRFNetwork
from cips3d_tpu_torch.ops import build, inr_tile, ray_tile

F32_TOL = dict(rtol=2e-4, atol=2e-5)
RAY_BF16_TOL = dict(rtol=1e-2, atol=3e-3)
RAY_BF16_WIDE_TOL = dict(rtol=1e-2, atol=5e-3)   # chip_smoke.py's, at the flagship widths
INR_BF16_TOL = dict(rtol=1e-2, atol=1e-3)
# chip_smoke.py's at the flagship width: over 9 blocks and a few hundred pixels a hidden
# state within rounding of a bf16 step flips alone now and then (up to 3.7e-3 seen)
INR_BF16_WIDE_TOL = dict(rtol=1e-2, atol=1e-2)
B, N, S = 2, 45, 10          # N not a multiple of the kernels' 16-ray block
N_WIDE = 101                 # at the flagship widths: 6 full ray blocks and a ragged one
FLAGSHIP = dict(hidden=128, rgb=32)   # H 128, C 64, R 32, L 2


def _ray_inputs(device, hidden=32, rgb=16, n=N, steps=S):
    N, S = n, steps
    g = torch.Generator().manual_seed(0)
    siren = NeRFNetwork(hidden_dim=hidden, hidden_layers=2, rgb_dim=rgb, style_dim=hidden,
                        generator=g).to(device)
    styles = {k: torch.randn(B, hidden, generator=g).to(device)
              for k in ("nerf_w0", "nerf_w1", "nerf_rgb")}
    origins = torch.randn(B, N, 3, generator=g) * 0.05
    d = torch.randn(B, N, 3, generator=g) + torch.tensor([0.0, 0.0, -1.0])
    dirs = d / d.norm(dim=-1, keepdim=True)
    z = torch.sort(torch.linspace(0.88, 1.12, S) + torch.rand(B, N, S, generator=g) * 0.024,
                   -1).values
    pts = origins[:, :, None] + dirs[:, :, None] * z[..., None]
    draws = ray_tile.draw_ray_randoms(B, N, S, True, g, "cpu")
    wt = ray_tile.flat_weights(siren, styles)
    return wt, [t.to(device) for t in (pts, origins, dirs, z, *draws)]


def _inr_inputs(device, n_blocks, D=64, in0=16, style=24, n=70, b=2):
    g = torch.Generator().manual_seed(1)
    net = CIPSNet(input_dim=in0, hidden_dim=D, style_dim=style, generator=g).to(device)
    styles = {f"inr_w{r}_{j}": torch.randn(b, style, generator=g).to(device)
              for r in ("4", "8", "16", "32", "64", "128", "256", "512", "1024") for j in (0, 1)}
    weights, mods = inr_tile.extract_inr_weights(net, n_blocks)
    s, d = inr_tile.compute_inr_mods(mods, styles, D)
    x = torch.randn(b, n, in0, generator=g).to(device)
    return x, s, d, weights._replace(wr=weights.wr * 50)   # make ToRGB show the whole chain


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _points_outside(a, b, tol):
    """Share of rows (the last axis) with any element outside the tolerance."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    far = (a - b).abs() > tol["atol"] + tol["rtol"] * b.abs()
    return far.reshape(-1, a.shape[-1]).any(-1).float().mean().item()


def _close(a, b, tol):
    np.testing.assert_allclose(a.detach().float().cpu().numpy(),
                               b.detach().float().cpu().numpy(), **tol)


# ---------------------------------------------------------------- any machine

def test_kernel_sources_are_in_the_package():
    names = {p.name for p in build._sources()}
    assert {"ray_tile.cu", "ray_tile_bwd.cu", "inr_tile.cu", "common.cu", "common.cuh",
            "fast_sin.cuh", "ray_tile.cuh"} <= names


def test_build_needs_nvcc():
    if shutil.which("nvcc"):
        pytest.skip("nvcc present: the build would run")
    with pytest.raises(RuntimeError, match="nvcc"):
        build._nvcc()


def test_cuda_wrappers_refuse_cpu_tensors():
    wt, args = _ray_inputs("cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ray_tile.ray_tile_cuda(wt, *args)
    with pytest.raises(ValueError, match="CUDA"):
        ray_tile.ray_tile_cuda(wt, *args, with_residuals=True)
    d_fea, d_dep = torch.ones(B, N, 16), torch.ones(B, N, 1)
    with pytest.raises(ValueError, match="CUDA"):
        ray_tile.ray_tile_bwd_cuda(wt, *args, 0.0, d_fea, d_dep)
    x, s, d, w = _inr_inputs("cpu", 9)
    with pytest.raises(ValueError, match="CUDA"):
        inr_tile.inr_tile_cuda(x, s, d, w)


@pytest.mark.parametrize("widths", [dict(hidden=40), dict(rgb=24)], ids=["H40", "R24"])
def test_cuda_wrappers_refuse_widths_off_the_mma_tiling(widths):
    """The kernels tile the layers in 16-wide MMA steps: other widths raise
    before any launch (the plain version takes them)."""
    wt, args = _ray_inputs("cpu", **widths)
    with pytest.raises(ValueError, match="multiples of 16"):
        ray_tile.ray_tile_cuda(wt, *args)
    with pytest.raises(ValueError, match="multiples of 16"):
        ray_tile.ray_tile_bwd_cuda(wt, *args, 0.0, torch.ones(B, N, wt[-4].shape[1]),
                                   torch.ones(B, N, 1))
    assert ray_tile.ray_tile_plain(wt, *args)[0].shape == (B, N, wt[-4].shape[1])


def test_dispatch_runs_plain_on_cpu():
    wt, args = _ray_inputs("cpu")
    before = ray_tile.ray_tile_cuda.launches, inr_tile.inr_tile_cuda.launches
    fea, dep = ray_tile.ray_tile(wt, *args)
    g, d_pts = ray_tile.ray_tile_bwd(wt, *args, 0.0, torch.ones_like(fea), torch.ones_like(dep))
    x, s, d, w = _inr_inputs("cpu", 9)
    out = inr_tile.inr_tile(x, s, d, w)
    assert fea.shape == (B, N, 16) and dep.shape == (B, N, 1) and out.shape == (2, 70, 3)
    assert [t.shape for t in g] == [t.shape for t in wt] and d_pts.shape == (B, N, S, 3)
    assert (ray_tile.ray_tile_cuda.launches, inr_tile.inr_tile_cuda.launches) == before


@pytest.mark.parametrize("b,n,steps,sms", [(4, 4096, 12, 132), (1, 16384, 24, 132), (2, 45, 10, 132),
                                            (3, 17, 32, 8), (1, 1, 3, 132)])
def test_bwd_plan_split(b, n, steps, sms):
    """The backward's grid and scratch: every ray block of a batch row is
    walked by one of its gx blocks, the fixed split covers every point once,
    and the flat grad sizes are those of the weights."""
    wt, _ = _ray_inputs("cpu", **FLAGSHIP)
    L, H, C, R = 2, 128, 64, 32
    plan = ray_tile.bwd_plan(b, n, steps, L, H, C, R, sms)
    blocks = -(-n // ray_tile.BLOCK_RAYS)
    assert 1 <= plan.gx <= blocks and (plan.gx == blocks or plan.gx * b >= sms)
    assert plan.rows == b * 2 * n * steps
    assert (plan.nsplit - 1) * ray_tile.SPLIT_ROWS < plan.rows <= plan.nsplit * ray_tile.SPLIT_ROWS
    assert ray_tile.SPLIT_ROWS % 32 == 0
    layers, (wc, bc, gc, fc, wr, br, ws, bs) = ray_tile._split(wt)
    assert plan.n_weight == sum(t.numel() for t in [l[0] for l in layers] + [wc, wr, ws])
    assert plan.n_bias == sum(t.numel() for t in [l[1] for l in layers] + [bc, br, bs])
    assert plan.n_film == sum(t.shape[1] for t in [x for l in layers for x in l[2:]] + [gc, fc])
    # a point's cotangent row: d a of each hidden layer, d ac, d sigma (+7 zeros), d rgb,
    # each block starting on 16 bytes in bf16
    assert plan.cot_width == L * H + C + 8 + R and plan.cot_width % 8 == 0


@pytest.mark.parametrize("b,n,sms", [(1, 16384, 132), (4, 4096, 132), (2, 45, 132), (1, 5, 132)])
def test_forward_grid(b, n, sms):
    """The persistent forward: one block per SM, fewer when there are fewer
    ray blocks."""
    grid = ray_tile.forward_grid(b, n, sms)
    assert grid == min(sms, b * -(-n // ray_tile.BLOCK_RAYS)) and grid >= 1


@pytest.mark.parametrize("b,n,sms", [(1, 16384, 132), (4, 4096, 132), (2, 70, 132), (3, 1, 8)])
def test_inr_forward_grid(b, n, sms):
    """The INR tile's persistent grid: at most one block per SM, no idle
    block, every 64-pixel tile of every batch row walked by exactly one
    block (block i takes tiles i, i + grid, ...), and one scratch slot of
    64 x D floats a block."""
    grid = inr_tile.forward_grid(b, n, sms)
    row_tiles = -(-n // inr_tile.TILE_PIXELS)
    assert 1 <= grid <= sms and grid <= b * row_tiles
    walked = [t for i in range(grid) for t in range(i, b * row_tiles, grid)]
    tiles = sorted((t // row_tiles, (t % row_tiles) * inr_tile.TILE_PIXELS) for t in walked)
    assert tiles == [(bi, p0) for bi in range(b) for p0 in range(0, n, inr_tile.TILE_PIXELS)]
    for D in (64, 512):
        shape = inr_tile.scratch_shape(grid, D)
        assert int(np.prod(shape)) == grid * 64 * D and shape[0] == grid


def test_ray_tile_bwd_plain_float64():
    """The plain backward runs in float64 (the witness the f32 kernel is held
    to on the card) and agrees with its f32 run."""
    wt, args = _ray_inputs("cpu")
    g = torch.Generator().manual_seed(4)
    d_fea, d_dep = torch.randn(B, N, 16, generator=g), torch.randn(B, N, 1, generator=g)
    g32, p32 = ray_tile.ray_tile_bwd_plain(wt, *args, 0.0, d_fea, d_dep)
    g64, p64 = ray_tile.ray_tile_bwd_plain([w.double() for w in wt], *[a.double() for a in args],
                                           0.0, d_fea.double(), d_dep.double(),
                                           mm_dtype=torch.float64)
    assert all(t.dtype == torch.float64 for t in g64 + [p64])
    for a, b in zip(g32 + [p32], g64 + [p64]):
        assert _grad_err(a, b) < 1e-4


def test_inr_tile_plain_float64_witness():
    """``mm_dtype=float64`` runs the whole plain decode in float64."""
    x, s, d, w = _inr_inputs("cpu", 9)
    exact = inr_tile.inr_tile_plain(x, s, d, w, mm_dtype=torch.float64)
    assert exact.dtype == torch.float64
    _close(inr_tile.inr_tile_plain(x, s, d, w), exact.float(), dict(rtol=1e-5, atol=1e-6))


# ---------------------------------------------------------------- on the card

@pytest.mark.gpu
@pytest.mark.parametrize("mm_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kwargs", [
    dict(), dict(clamp_mode="softplus"), dict(noise_std=0.4), dict(white_back=True),
    dict(last_back=True), dict(fast_sin=True),
], ids=["relu", "softplus", "noise", "white_back", "last_back", "fast_sin"])
def test_ray_tile_kernel_matches_plain(cuda_device, mm_dtype, kwargs):
    wt, args = _ray_inputs(cuda_device)
    kwargs = dict(kwargs)
    ns = kwargs.pop("noise_std", 0.0)
    launches = ray_tile.ray_tile_cuda.launches
    fa, da = ray_tile.ray_tile_cuda(wt, *args, ns, mm_dtype=mm_dtype, out_dtype=mm_dtype, **kwargs)
    fb, db = ray_tile.ray_tile_plain(wt, *args, ns, mm_dtype=mm_dtype, out_dtype=mm_dtype, **kwargs)
    torch.cuda.synchronize()
    assert ray_tile.ray_tile_cuda.launches == launches + 1
    assert fa.dtype == mm_dtype and da.dtype == torch.float32
    tol = F32_TOL if mm_dtype == torch.float32 else RAY_BF16_TOL
    _close(fa, fb, tol)
    _close(da, db, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("mm_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n_blocks", [9, 5])
def test_inr_tile_kernel_matches_plain(cuda_device, mm_dtype, n_blocks):
    x, s, d, w = _inr_inputs(cuda_device, n_blocks)
    out = inr_tile.inr_tile_cuda(x, s, d, w, mm_dtype=mm_dtype)
    ref = inr_tile.inr_tile_plain(x, s, d, w, mm_dtype=mm_dtype)
    torch.cuda.synchronize()
    assert ref.abs().max() > 0.1   # the chain, not only the biases, reaches the output
    _close(out, ref, F32_TOL if mm_dtype == torch.float32 else INR_BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("mm_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n_blocks", [4, 5, 9])
@pytest.mark.parametrize("D", [64, 512])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 200])
def test_inr_tile_kernel_ragged(cuda_device, n, b, D, n_blocks, mm_dtype):
    """The 64-pixel tiles against the plain version: n ragged against the
    tile (rows past n read zeros and are never stored), several batch rows
    of one persistent grid, D = 64 (most channel slices idle) and 512, the
    first residual block (4) and none (blocks 4), a 32-wide first layer
    (two 16-row weight stages)."""
    x, s, d, w = _inr_inputs(cuda_device, n_blocks, D=D, in0=32, n=n, b=b)
    out = inr_tile.inr_tile_cuda(x, s, d, w, mm_dtype=mm_dtype)
    ref = inr_tile.inr_tile_plain(x, s, d, w, mm_dtype=mm_dtype)
    torch.cuda.synchronize()
    assert out.shape == (b, n, 3)
    if mm_dtype == torch.float32:
        _close(out, ref, F32_TOL)
        return
    _close(out, ref, INR_BF16_WIDE_TOL)
    if b * n >= 64:   # and, with enough pixels for a mean, it rounds where the plain
        # version does: twice as close to the bf16 plain version as to the f32 one
        f32 = inr_tile.inr_tile_plain(x, s, d, w)
        assert 2 * (out - ref).abs().mean() <= (out - f32).abs().mean()


@pytest.mark.gpu
@pytest.mark.parametrize("mm_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_inr_tile_kernel_deterministic(cuda_device, mm_dtype):
    """Two launches give the same bits (each block reads back only its own
    scratch slot)."""
    x, s, d, w = _inr_inputs(cuda_device, 9, D=512, in0=32, n=200, b=3)
    one = inr_tile.inr_tile_cuda(x, s, d, w, mm_dtype=mm_dtype)
    two = inr_tile.inr_tile_cuda(x, s, d, w, mm_dtype=mm_dtype)
    assert torch.equal(one, two)


@pytest.mark.gpu
def test_inr_tile_kernel_as_close_to_float64_as_plain(cuda_device):
    """At the flagship's width (D = 512, 18 layers of 512-deep dots) on
    order-1 features, the f32 kernel is at most twice as far from a float64
    decode as the f32 plain version."""
    x, s, d, w = _inr_inputs(cuda_device, 9, D=512, in0=32, n=256)
    out = inr_tile.inr_tile_cuda(x, s, d, w)
    ref = inr_tile.inr_tile_plain(x, s, d, w)
    exact = inr_tile.inr_tile_plain(x, s, d, w, mm_dtype=torch.float64)
    torch.cuda.synchronize()
    assert (out.double() - exact).abs().max() <= 2 * (ref.double() - exact).abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["ray_tile", "inr_tile"])
def test_bf16_tolerance_sees_the_rounding(cuda_device, kernel):
    """Control: the f32 kernel, which skips the bf16 rounding, lies outside
    the bf16 tolerance of the bf16 plain version."""
    if kernel == "ray_tile":
        wt, args = _ray_inputs(cuda_device)
        out = ray_tile.ray_tile_cuda(wt, *args, mm_dtype=torch.float32)[0]
        ref = ray_tile.ray_tile_plain(wt, *args, mm_dtype=torch.bfloat16)[0]
        tol = RAY_BF16_TOL
    else:
        x, s, d, w = _inr_inputs(cuda_device, 9)
        out = inr_tile.inr_tile_cuda(x, s, d, w, mm_dtype=torch.float32)
        ref = inr_tile.inr_tile_plain(x, s, d, w, mm_dtype=torch.bfloat16)
        tol = INR_BF16_TOL
    torch.cuda.synchronize()
    with pytest.raises(AssertionError):
        _close(out, ref, tol)


@pytest.mark.gpu
def test_kernels_check_shapes(cuda_device):
    wt, args = _ray_inputs(cuda_device)
    with pytest.raises(ValueError, match="expected float32"):
        ray_tile.ray_tile_cuda(wt, args[0][:, :, :4], *args[1:])
    x, s, d, w = _inr_inputs(cuda_device, 9)
    with pytest.raises(ValueError, match="expected float32"):
        inr_tile.inr_tile_cuda(x.double(), s, d, w)


def _grad_err(a, b):
    """max|a - b| / (max|b| + 1), the normalised error of the Pallas tests."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return ((a - b).abs().max() / (b.abs().max() + 1)).item()


def _rays_outside(a, b, tol=1e-4):
    """Share of rays with any d pts element off by more than tol (max|b| + 1)."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    bound = tol * (b.abs().max() + 1)
    return ((a - b).abs() > bound).reshape(a.shape[0] * a.shape[1], -1).any(-1).float().mean().item()


BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("mm_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ray_tile_residuals_match_plain(cuda_device, mm_dtype):
    wt, args = _ray_inputs(cuda_device)
    before = ray_tile.ray_tile_cuda.residual_launches
    fa, da, ra = ray_tile.ray_tile_cuda(wt, *args, 0.4, mm_dtype=mm_dtype, with_residuals=True)
    fb, db, rb = ray_tile.ray_tile_plain(wt, *args, 0.4, mm_dtype=mm_dtype, with_residuals=True)
    torch.cuda.synchronize()
    assert ray_tile.ray_tile_cuda.residual_launches == before + 1
    tol = F32_TOL if mm_dtype == torch.float32 else RAY_BF16_TOL
    _close(fa, fb, tol)
    _close(da, db, tol)
    for x, y in zip(ra, rb):
        assert x.dtype == y.dtype and x.shape == y.shape
        # pre-activations reach |a| ~ 20: the f32 tolerance scaled to them
        _close(x, y, dict(rtol=tol["rtol"], atol=tol["atol"] * 20))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["recompute", "residual"])
@pytest.mark.parametrize("mm_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kwargs", [
    dict(), dict(clamp_mode="softplus"), dict(noise_std=0.4), dict(white_back=True),
    dict(last_back=True), dict(fast_sin=True),
], ids=["relu", "softplus", "noise", "white_back", "last_back", "fast_sin"])
def test_ray_tile_bwd_matches_plain(cuda_device, mode, mm_dtype, kwargs):
    wt, args = _ray_inputs(cuda_device)
    kwargs = dict(kwargs)
    ns = kwargs.pop("noise_std", 0.0)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    d_fea = torch.randn(B, N, 16, generator=g, device=cuda_device)
    d_dep = torch.randn(B, N, 1, generator=g, device=cuda_device)
    res = None
    if mode == "residual":
        res = ray_tile.ray_tile_cuda(wt, *args, ns, mm_dtype=mm_dtype, with_residuals=True,
                                     **kwargs)[2]
    ga, pa = ray_tile.ray_tile_bwd_cuda(wt, *args, ns, d_fea, d_dep, residuals=res,
                                        mm_dtype=mm_dtype, **kwargs)
    gb, pb = ray_tile.ray_tile_bwd_plain(wt, *args, ns, d_fea, d_dep, residuals=res,
                                         mm_dtype=mm_dtype, **kwargs)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(ga, gb)):
        assert a.shape == b.shape
        assert _grad_err(a, b) < BWD_TOL[mm_dtype], f"grad {i}: {_grad_err(a, b):.3e}"
    assert _rays_outside(pa, pb, 1e-4 if mm_dtype == torch.float32 else 1e-2) == 0
    # and the plain backward agrees with autograd through the plain forward
    leaves = [t.detach().requires_grad_() for t in wt]
    p = args[0].detach().requires_grad_()
    fea, dep = ray_tile.ray_tile_plain(leaves, p, *args[1:], ns, mm_dtype=mm_dtype, **kwargs)
    gc = torch.autograd.grad((fea, dep), leaves + [p], (d_fea, d_dep))
    if mm_dtype == torch.float32:
        for a, b in zip(gb, gc[:-1]):
            assert _grad_err(a, b) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["recompute", "residual"])
@pytest.mark.parametrize("widths", ["narrow", "flagship"])
def test_ray_tile_bwd_deterministic(cuda_device, mode, widths):
    """Two runs give the same bits; at the flagship widths and S 24 over
    several weight-grad splits."""
    wide = widths == "flagship"
    n, out = (N_WIDE, 32) if wide else (N, 16)
    wt, args = _ray_inputs(cuda_device, n=n, steps=24, **FLAGSHIP) if wide \
        else _ray_inputs(cuda_device)
    d_fea = torch.ones(B, n, out, device=cuda_device)
    d_dep = torch.ones(B, n, 1, device=cuda_device)
    res = ray_tile.ray_tile_cuda(wt, *args, 0.4, with_residuals=True)[2] if mode == "residual" \
        else None
    one = ray_tile.ray_tile_bwd_cuda(wt, *args, 0.4, d_fea, d_dep, residuals=res)
    two = ray_tile.ray_tile_bwd_cuda(wt, *args, 0.4, d_fea, d_dep, residuals=res)
    for a, b in zip(one[0] + [one[1]], two[0] + [two[1]]):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_ray_tile_bwd_bf16_control(cuda_device):
    """The f32 backward kernel lies outside the bf16 tolerance of the bf16
    plain backward."""
    wt, args = _ray_inputs(cuda_device)
    d_fea = torch.ones(B, N, 16, device=cuda_device)
    d_dep = torch.ones(B, N, 1, device=cuda_device)
    ga, _ = ray_tile.ray_tile_bwd_cuda(wt, *args, 0.0, d_fea, d_dep)
    gb, _ = ray_tile.ray_tile_bwd_plain(wt, *args, 0.0, d_fea, d_dep, mm_dtype=torch.bfloat16)
    assert max(_grad_err(a, b) for a, b in zip(ga, gb)) > BWD_TOL[torch.bfloat16]


# ---------------------------------------------- on the card, flagship widths

@pytest.mark.gpu
@pytest.mark.parametrize("steps", [10, 12, 24])
@pytest.mark.parametrize("mm_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("residuals", [False, True], ids=["plain", "residuals"])
def test_ray_tile_kernel_flagship(cuda_device, steps, mm_dtype, residuals):
    """#2 and #2r at H 128, C 64, R 32 with n ragged against the 16-ray block."""
    wt, args = _ray_inputs(cuda_device, n=N_WIDE, steps=steps, **FLAGSHIP)
    out = ray_tile.ray_tile_cuda(wt, *args, 0.0, mm_dtype=mm_dtype, with_residuals=residuals)
    ref = ray_tile.ray_tile_plain(wt, *args, 0.0, mm_dtype=mm_dtype, with_residuals=residuals)
    torch.cuda.synchronize()
    tol = F32_TOL if mm_dtype == torch.float32 else RAY_BF16_WIDE_TOL
    _close(out[0], ref[0], tol)
    _close(out[1], ref[1], tol)
    if residuals:
        # a hidden state within rounding of a bf16 step, or a sine of a large argument, can
        # part alone: as chip_smoke.py, at most 0.1 % of the points may lie outside
        for x, y in zip(out[2], ref[2]):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert _points_outside(x, y, dict(rtol=tol["rtol"], atol=tol["atol"] * 20)) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("steps", [10, 12, 24])
@pytest.mark.parametrize("mm_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["recompute", "residual"])
def test_ray_tile_bwd_flagship(cuda_device, steps, mm_dtype, mode):
    """#3 at H 128, C 64, R 32 (several weight-grad splits at S 24) with n
    ragged against the 16-ray block."""
    wt, args = _ray_inputs(cuda_device, n=N_WIDE, steps=steps, **FLAGSHIP)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    d_fea = torch.randn(B, N_WIDE, 32, generator=g, device=cuda_device)
    d_dep = torch.randn(B, N_WIDE, 1, generator=g, device=cuda_device)
    res = None
    if mode == "residual":
        res = ray_tile.ray_tile_cuda(wt, *args, 0.0, mm_dtype=mm_dtype, with_residuals=True)[2]
    ga, pa = ray_tile.ray_tile_bwd_cuda(wt, *args, 0.0, d_fea, d_dep, residuals=res,
                                        mm_dtype=mm_dtype)
    gb, pb = ray_tile.ray_tile_bwd_plain(wt, *args, 0.0, d_fea, d_dep, residuals=res,
                                         mm_dtype=mm_dtype)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(ga, gb)):
        assert a.shape == b.shape
        assert _grad_err(a, b) < BWD_TOL[mm_dtype], f"grad {i}: {_grad_err(a, b):.3e}"
    assert _rays_outside(pa, pb, 1e-4 if mm_dtype == torch.float32 else 1e-2) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["recompute", "residual"])
def test_ray_tile_bwd_as_close_to_float64_as_plain(cuda_device, mode):
    """At the flagship widths the f32 backward kernel is at most twice as far
    from a float64 run of the plain backward as the f32 plain backward."""
    wt, args = _ray_inputs(cuda_device, n=N_WIDE, steps=24, **FLAGSHIP)
    g = torch.Generator(device=cuda_device).manual_seed(6)
    d_fea = torch.randn(B, N_WIDE, 32, generator=g, device=cuda_device)
    d_dep = torch.randn(B, N_WIDE, 1, generator=g, device=cuda_device)
    res = ray_tile.ray_tile_cuda(wt, *args, 0.0, with_residuals=True)[2] if mode == "residual" \
        else None
    ga, _ = ray_tile.ray_tile_bwd_cuda(wt, *args, 0.0, d_fea, d_dep, residuals=res)
    gb, _ = ray_tile.ray_tile_bwd_plain(wt, *args, 0.0, d_fea, d_dep, residuals=res)
    g64, _ = ray_tile.ray_tile_bwd_plain([w.double() for w in wt], *[a.double() for a in args],
                                         0.0, d_fea.double(), d_dep.double(), residuals=res,
                                         mm_dtype=torch.float64)
    torch.cuda.synchronize()
    far = lambda gs: max(((a.double() - b).abs().max() / (b.abs().max() + 1)).item()
                         for a, b in zip(gs, g64))
    assert far(ga) <= 2 * far(gb)
