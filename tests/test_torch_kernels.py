"""The port's CUDA kernels against their plain PyTorch versions.

This file imports neither JAX nor `cips3d_tpu`, so it also runs on the
machine with the card, where JAX is absent:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

The ``gpu`` cases skip without a CUDA device (the kernels have no CPU
mode); the others check, on any machine, what surrounds the kernels.
Tolerances: f32 rtol 2e-4 / atol 2e-5 (the Pallas tests').  With bf16
matmul inputs both versions round the same values but sum in another order:
ray tile rtol 1e-2 / atol 3e-3, INR tile rtol 1e-2 / atol 1e-3, each tight
enough that the f32 kernel, which skips the rounding, fails it.
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
INR_BF16_TOL = dict(rtol=1e-2, atol=1e-3)
B, N, S = 2, 45, 10          # N not a multiple of the kernel's 4-ray block


def _ray_inputs(device, hidden=32, rgb=16):
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


def _inr_inputs(device, n_blocks, D=64, in0=16, style=24, n=70):
    g = torch.Generator().manual_seed(1)
    net = CIPSNet(input_dim=in0, hidden_dim=D, style_dim=style, generator=g).to(device)
    styles = {f"inr_w{r}_{j}": torch.randn(2, style, generator=g).to(device)
              for r in ("4", "8", "16", "32", "64", "128", "256", "512", "1024") for j in (0, 1)}
    weights, mods = inr_tile.extract_inr_weights(net, n_blocks)
    s, d = inr_tile.compute_inr_mods(mods, styles, D)
    x = torch.randn(2, n, in0, generator=g).to(device)
    return x, s, d, weights._replace(wr=weights.wr * 50)   # make ToRGB show the whole chain


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(a, b, tol):
    np.testing.assert_allclose(a.detach().float().cpu().numpy(),
                               b.detach().float().cpu().numpy(), **tol)


# ---------------------------------------------------------------- any machine

def test_kernel_sources_are_in_the_package():
    names = {p.name for p in build._sources()}
    assert {"ray_tile.cu", "inr_tile.cu", "common.cu", "common.cuh", "fast_sin.cuh"} <= names


def test_build_needs_nvcc():
    if shutil.which("nvcc"):
        pytest.skip("nvcc present: the build would run")
    with pytest.raises(RuntimeError, match="nvcc"):
        build._nvcc()


def test_cuda_wrappers_refuse_cpu_tensors():
    wt, args = _ray_inputs("cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ray_tile.ray_tile_cuda(wt, *args)
    x, s, d, w = _inr_inputs("cpu", 9)
    with pytest.raises(ValueError, match="CUDA"):
        inr_tile.inr_tile_cuda(x, s, d, w)


def test_dispatch_runs_plain_on_cpu():
    wt, args = _ray_inputs("cpu")
    before = ray_tile.ray_tile_cuda.launches, inr_tile.inr_tile_cuda.launches
    fea, dep = ray_tile.ray_tile(wt, *args)
    x, s, d, w = _inr_inputs("cpu", 9)
    out = inr_tile.inr_tile(x, s, d, w)
    assert fea.shape == (B, N, 16) and dep.shape == (B, N, 1) and out.shape == (2, 70, 3)
    assert (ray_tile.ray_tile_cuda.launches, inr_tile.inr_tile_cuda.launches) == before


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
