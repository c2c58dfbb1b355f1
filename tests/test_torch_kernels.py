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
from pathlib import Path

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


def _ray_inputs(device, hidden=32, rgb=16, n=N, steps=S, layers=2, color=None):
    N, S = n, steps
    g = torch.Generator().manual_seed(0)
    siren = NeRFNetwork(hidden_dim=hidden, hidden_layers=layers, rgb_dim=rgb, style_dim=hidden,
                        color_hidden_dim=color, generator=g).to(device)
    styles = {k: torch.randn(B, hidden, generator=g).to(device)
              for k in [f"nerf_w{i}" for i in range(layers)] + ["nerf_rgb"]}
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
            "fast_sin.cuh", "ray_tile.cuh", "ray_tile_streamed.cu", "inr_tile_streamed.cu",
            "stream_gemm.cuh", "wgrad.cuh"} <= names


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
def test_cuda_wrappers_pad_widths_off_the_mma_tiling(widths):
    """The kernels tile the layers in 16-wide MMA steps; the wrappers run
    other widths zero-padded (they reach the device check, not a shape
    error) and cut the results back.  The padded weights, cotangent and
    residuals through the plain versions give the unpadded results: in
    float64 to rounding (bit for bit is not defined here, the CPU's BLAS
    blocks a padded product otherwise)."""
    n = 12
    wt, args = _ray_inputs("cpu", n=n, **widths)
    R = wt[-4].shape[1]
    d_fea, d_dep = torch.ones(B, n, R), torch.ones(B, n, 1)
    with pytest.raises(ValueError, match="CUDA"):
        ray_tile.ray_tile_cuda(wt, *args)
    with pytest.raises(ValueError, match="CUDA"):
        ray_tile.ray_tile_bwd_cuda(wt, *args, 0.0, d_fea, d_dep)
    w = ray_tile.widths(wt)
    assert w.padded and (w.Hp, w.Cp, w.Rp) == tuple(-(-x // 16) * 16 for x in (w.H, w.C, w.R))
    wt, args = [t.double() for t in wt], [a.double() for a in args]
    kw = dict(mm_dtype=torch.float64, clamp_mode="softplus", white_back=True, last_back=True)
    wp = ray_tile.pad_weights(wt, w)
    assert [t.shape[-1] for t in wp[:4]] == [w.Hp] * 4 and wp[-4].shape == (w.Cp, w.Rp)
    fea, dep, res = ray_tile.ray_tile_plain(wt, *args, 0.4, with_residuals=True, **kw)
    fp, dp, rp = ray_tile.ray_tile_plain(wp, *args, 0.4, with_residuals=True, **kw)
    rp = ray_tile.unpad_residuals(rp, w)
    exact = lambda a, b: torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    exact(fp[..., :w.R], fea)
    exact(dp, dep)
    for a, b in zip(rp, res):
        exact(a, b)
    g = torch.Generator().manual_seed(2)
    d_fea = torch.randn(B, n, R, generator=g, dtype=torch.float64)
    d_dep = torch.randn(B, n, 1, generator=g, dtype=torch.float64)
    for r in (None, res):
        ref, ref_pts = ray_tile.ray_tile_bwd_plain(wt, *args, 0.4, d_fea, d_dep, residuals=r,
                                                   **kw)
        got, got_pts = ray_tile.ray_tile_bwd_plain(
            wp, *args, 0.4, torch.nn.functional.pad(d_fea, (0, w.Rp - w.R)), d_dep,
            residuals=None if r is None else ray_tile.pad_residuals(r, w), **kw)
        got = ray_tile.unpad_grads(got, wt)
        for a, b in zip(got + [got_pts], ref + [ref_pts]):
            assert a.shape == b.shape
            exact(a, b)


def test_inr_wrapper_pads_widths_off_its_tiling():
    """The INR tile's wrapper zero-pads D to a multiple of 64 and in0 to a
    multiple of 16 (D 200, in0 24 reach the device check); through the plain
    version the padded decode is the unpadded one."""
    x, s, d, w = _inr_inputs("cpu", 9, D=200, in0=24)
    with pytest.raises(ValueError, match="CUDA"):
        inr_tile.inr_tile_cuda(x, s, d, w)
    xp, sp, dp, wp = inr_tile.pad_widths(x, s, d, w)
    assert xp.shape[-1] == 32 and sp.shape[-1] == dp.shape[-1] == 256
    assert wp.w0.shape == (32, 256) and wp.wrest.shape[1:] == (256, 256)
    assert wp.wr.shape[1:] == (256, 3)
    ref = inr_tile.inr_tile_plain(x, s, d, w, mm_dtype=torch.float64)
    got = inr_tile.inr_tile_plain(xp, sp, dp, wp, mm_dtype=torch.float64)
    torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("steps", [33, 48, 64])
def test_cuda_wrappers_take_long_rays(steps):
    """#2, #2r and #3 take every S up to MAX_STEPS: on CPU tensors the
    wrappers get past the shape gate to the device check."""
    assert ray_tile.MAX_STEPS >= 64
    wt, args = _ray_inputs("cpu", n=5, steps=steps)
    d_fea, d_dep = torch.ones(B, 5, 16), torch.ones(B, 5, 1)
    res = ray_tile.ray_tile_plain(wt, *args, with_residuals=True)[2]
    with pytest.raises(ValueError, match="needs CUDA"):
        ray_tile.ray_tile_cuda(wt, *args)
    with pytest.raises(ValueError, match="needs CUDA"):
        ray_tile.ray_tile_cuda(wt, *args, with_residuals=True)
    for r in (None, res):
        with pytest.raises(ValueError, match="needs CUDA"):
            ray_tile.ray_tile_bwd_cuda(wt, *args, 0.0, d_fea, d_dep, residuals=r)


# Shapes past the resident kernels' limits (S past MAX_STEPS, widths past 128, L past the
# weight-grad kernel's products or its shared memory) and INR widths past 512: the streamed
# path takes them.  (id, ray inputs, the path the mirror picks on an H100)
PAST_CAPS = [
    ("S65", dict(steps=65), "streamed"), ("S96", dict(steps=96), "streamed"),
    ("S256", dict(steps=256), "streamed"),
    ("H144", dict(hidden=144, color=144), "streamed"),
    ("H256", dict(hidden=256, color=256), "streamed"),
    ("R64", dict(rgb=64), "resident"),
    ("L1", dict(layers=1), "resident"), ("L3", dict(layers=3), "resident"),
    ("L8", dict(layers=8), "streamed"),
    ("L3_H128", dict(layers=3, hidden=128, rgb=32), "streamed"),
]


@pytest.mark.parametrize("case,kw,expect", PAST_CAPS, ids=[c[0] for c in PAST_CAPS])
def test_cuda_wrappers_take_past_the_resident_caps(case, kw, expect):
    """#2, #2r and #3 (both modes) take every shape the JAX function takes:
    on CPU tensors the wrappers get past the shape checks to the device
    check, on either path; the mirror of the resident layouts picks the
    path the card would take."""
    n = 3
    wt, args = _ray_inputs("cpu", n=n, **kw)
    w = ray_tile.widths(wt)
    S = args[0].shape[2]
    assert ray_tile.ray_path(S, w.L, w.Hp, w.Cp, w.Rp) == expect
    d_fea, d_dep = torch.ones(B, n, w.R), torch.ones(B, n, 1)
    res = ray_tile.ray_tile_plain(wt, *args, with_residuals=True)[2]
    for path in ("auto", "streamed"):
        with pytest.raises(ValueError, match="needs CUDA"):
            ray_tile.ray_tile_cuda(wt, *args, path=path)
        with pytest.raises(ValueError, match="needs CUDA"):
            ray_tile.ray_tile_cuda(wt, *args, with_residuals=True, path=path)
        for r in (None, res):
            with pytest.raises(ValueError, match="needs CUDA"):
                ray_tile.ray_tile_bwd_cuda(wt, *args, 0.0, d_fea, d_dep, residuals=r, path=path)


def _inr_zeros(D, in0=32, n_blocks=4, n=3, b=2):
    """Decode operands of the right shapes (zeros: only the wrapper's checks read them)."""
    L = 2 * n_blocks
    w = inr_tile.InrWeights(w0=torch.zeros(in0, D), wrest=torch.zeros(L - 1, D, D),
                            wr=torch.zeros(n_blocks - 3, D, 3), br=torch.zeros(n_blocks - 3, 3))
    return torch.zeros(b, n, in0), torch.zeros(b, L, D), torch.zeros(b, L, D), w


@pytest.mark.parametrize("D", [576, 1024])
def test_inr_wrapper_takes_past_the_resident_cap(D):
    """#1 takes INR widths past 512 (the streamed path): the wrapper gets to
    the device check; the mirror picks the streamed path."""
    assert inr_tile.inr_path(D) == "streamed" and inr_tile.inr_path(512) == "resident"
    for path in ("auto", "streamed"):
        with pytest.raises(ValueError, match="needs CUDA"):
            inr_tile.inr_tile_cuda(*_inr_zeros(D), path=path)


def test_cuda_wrappers_refuse_what_jax_refuses():
    """The wrappers raise where `fused_ray_render` and `fused_inr_decode`
    raise, before any launch: no hidden layer, one sample a ray (the resample
    needs two), an input wider than D, fewer than 4 INR blocks; and on an
    unknown path."""
    wt, args = _ray_inputs("cpu", n=3)
    no_layers = wt[8:]
    with pytest.raises(ValueError, match="L=0"):
        ray_tile.ray_tile_cuda(no_layers, *args)
    with pytest.raises(ValueError, match="L=0"):
        ray_tile.ray_tile_bwd_cuda(no_layers, *args, 0.0, torch.ones(B, 3, 16),
                                   torch.ones(B, 3, 1))
    wt, args = _ray_inputs("cpu", n=3, steps=1)
    with pytest.raises(ValueError, match="S=1"):
        ray_tile.ray_tile_cuda(wt, *args)
    wt, args = _ray_inputs("cpu", n=3, steps=2)   # two samples: JAX takes them
    with pytest.raises(ValueError, match="needs CUDA"):
        ray_tile.ray_tile_cuda(wt, *args)
    with pytest.raises(ValueError, match="path must be one of"):
        ray_tile.ray_tile_cuda(wt, *args, path="fast")
    with pytest.raises(ValueError, match="path must be one of"):
        inr_tile.inr_tile_cuda(*_inr_zeros(64), path="fast")
    with pytest.raises(ValueError, match=r"in0=48 \(<= D=32\)"):
        inr_tile.inr_tile_cuda(*_inr_zeros(32, in0=48))
    with pytest.raises(ValueError, match="n_blocks=3"):
        inr_tile.inr_tile_cuda(*_inr_zeros(64, n_blocks=3))


def _shipped_generators():
    """(config, generator node, sample counts) of each shipped config with a NeRF."""
    from cips3d_tpu_torch.config import yaml_lite

    root = Path(__file__).resolve().parent.parent / "configs"
    for f in sorted(root.glob("*.yaml")):
        d = yaml_lite.safe_load(f.read_text())
        g = d.get("generator", {})
        if "nerf_hidden_dim" not in g:
            continue
        S = d.get("render", {}).get("num_steps") or d.get("nerf_kwargs", {}).get("n_samples")
        # the stage's count, the serving count (RenderService, eval --serving), multiview's
        # doubled serving count and the resident cap
        yield f.name, g, sorted({S, 24, 48, ray_tile.MAX_STEPS})


def test_path_choice_keeps_shipped_configs_resident():
    """The mirror of the resident layouts keeps every shipped config on the
    resident path (f32 and bf16, at each config's sample counts), so their
    outputs stay the resident kernels'; the NeRF depth 3 at the flagship
    width in f32 takes the streamed path at every S (its weights alone pass
    the card's shared memory)."""
    seen = 0
    for name, g, steps in _shipped_generators():
        L, H, R = g["nerf_hidden_layers"], g["nerf_hidden_dim"], g["nerf_rgb_dim"]
        for S in steps:
            for mm in (torch.float32, torch.bfloat16):
                assert ray_tile.ray_path(S, L, H, H // 2, R, mm) == "resident", (name, S, mm)
        assert inr_tile.inr_path(g["inr_hidden_dim"]) == "resident"
        seen += 1
    assert seen >= 4
    for S in (3, 12, 24, 64):
        assert ray_tile.ray_path(S, 3, 128, 64, 32) == "streamed"
        assert max(ray_tile.resident_smem(S, 3, 128, 64, 32)) > ray_tile.SMEM_OPTIN
    # the flagship's resident layouts at S = 24: the forward's 179600 bytes, as PERF.md has it
    assert ray_tile.resident_smem(24, 2, 128, 64, 32)[0] == 179600


def test_backward_runs_on_the_forwards_path(monkeypatch):
    """Under autograd the forward takes the path `ray_path_of` chooses and
    the backward gets the same one, so a residual of one path is never fed
    to the other: the CUDA wrappers are replaced by recorders running the
    plain versions (on the CPU no path is chosen) and the choice forced to
    "streamed"."""
    wt, args = _ray_inputs("cpu", n=3)
    seen = []

    def fwd(*a, path, **kw):
        seen.append(("fwd", path, kw.get("with_residuals", False)))
        return ray_tile.ray_tile_plain(*a, **kw)

    def bwd(*a, path, residuals=None, **kw):
        seen.append(("bwd", path, residuals is not None))
        return ray_tile.ray_tile_bwd_plain(*a, residuals=residuals, **kw)

    monkeypatch.setattr(ray_tile, "ray_tile_cuda", fwd)
    monkeypatch.setattr(ray_tile, "ray_tile_bwd_cuda", bwd)
    monkeypatch.setattr(ray_tile, "ray_path_of", lambda wt, pts, mm: "streamed")
    leaves = [t.detach().requires_grad_() for t in wt]
    for impl in ("pallas_residual", "pallas"):
        seen.clear()
        kw = dict(clamp_mode="relu", white_back=False, last_back=False, fast_sin=False,
                  mm_dtype=torch.float32, warp_scale=2.0 / 0.24, out_dtype=torch.float32)
        fea, dep = ray_tile.RayTileFunction.apply((0.0, impl, kw), *args, *leaves)
        (fea.sum() + dep.sum()).backward()
        res = impl == "pallas_residual"
        assert seen == [("fwd", "streamed", res), ("bwd", "streamed", res)]


def test_dispatch_runs_plain_on_cpu():
    wt, args = _ray_inputs("cpu")
    before = dict(build.LAUNCHES)
    fea, dep = ray_tile.ray_tile(wt, *args)
    g, d_pts = ray_tile.ray_tile_bwd(wt, *args, 0.0, torch.ones_like(fea), torch.ones_like(dep))
    x, s, d, w = _inr_inputs("cpu", 9)
    out = inr_tile.inr_tile(x, s, d, w)
    assert fea.shape == (B, N, 16) and dep.shape == (B, N, 1) and out.shape == (2, 70, 3)
    assert [t.shape for t in g] == [t.shape for t in wt] and d_pts.shape == (B, N, S, 3)
    assert build.LAUNCHES == before


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
    launches = build.launches("ray_tile")
    fa, da = ray_tile.ray_tile_cuda(wt, *args, ns, mm_dtype=mm_dtype, out_dtype=mm_dtype, **kwargs)
    fb, db = ray_tile.ray_tile_plain(wt, *args, ns, mm_dtype=mm_dtype, out_dtype=mm_dtype, **kwargs)
    torch.cuda.synchronize()
    assert build.launches("ray_tile") == launches + 1
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
    before = build.launches("ray_tile_residuals")
    fa, da, ra = ray_tile.ray_tile_cuda(wt, *args, 0.4, mm_dtype=mm_dtype, with_residuals=True)
    fb, db, rb = ray_tile.ray_tile_plain(wt, *args, 0.4, mm_dtype=mm_dtype, with_residuals=True)
    torch.cuda.synchronize()
    assert build.launches("ray_tile_residuals") == before + 1
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

# S past 32: each lane of a ray's warp holds several samples (csrc/ray_tile.cuh)
STEPS = sorted({10, 12, 24, 33, 48, 64, ray_tile.MAX_STEPS})


@pytest.mark.gpu
@pytest.mark.parametrize("steps", STEPS)
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
@pytest.mark.parametrize("steps", STEPS)
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


@pytest.mark.gpu
@pytest.mark.parametrize("steps", [33, 48, 64])
@pytest.mark.parametrize("mm_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ray_tile_long_rays_deterministic(cuda_device, steps, mm_dtype):
    """Past 32 samples a ray, with density noise: #2, #2r and #3 in both
    modes give the same bits twice."""
    wt, args = _ray_inputs(cuda_device, n=N_WIDE, steps=steps, **FLAGSHIP)
    d_fea = torch.ones(B, N_WIDE, 32, device=cuda_device)
    d_dep = torch.ones(B, N_WIDE, 1, device=cuda_device)

    def run():
        fea, dep = ray_tile.ray_tile_cuda(wt, *args, 0.4, mm_dtype=mm_dtype)
        fr, dr, res = ray_tile.ray_tile_cuda(wt, *args, 0.4, mm_dtype=mm_dtype,
                                             with_residuals=True)
        out = [fea, dep, fr, dr, *res]
        for r in (None, res):
            g, p = ray_tile.ray_tile_bwd_cuda(wt, *args, 0.4, d_fea, d_dep, residuals=r,
                                              mm_dtype=mm_dtype)
            out += g + [p]
        return out

    for a, b in zip(run(), run()):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("mm_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("widths", [dict(hidden=40), dict(rgb=24), dict(hidden=40, rgb=24)],
                         ids=["H40", "R24", "H40-R24"])
def test_ray_tile_kernels_at_padded_widths(cuda_device, mm_dtype, widths):
    """Widths off the 16-wide tiling run zero-padded: #2, #2r and #3 (both
    modes) against the plain version at the true widths."""
    wt, args = _ray_inputs(cuda_device, n=N_WIDE, steps=24, **widths)
    R = wt[-4].shape[1]
    g = torch.Generator(device=cuda_device).manual_seed(7)
    d_fea = torch.randn(B, N_WIDE, R, generator=g, device=cuda_device)
    d_dep = torch.randn(B, N_WIDE, 1, generator=g, device=cuda_device)
    tol = F32_TOL if mm_dtype == torch.float32 else RAY_BF16_TOL
    before = {k: build.launches(k) for k in build.KERNELS}
    fa, da, ra = ray_tile.ray_tile_cuda(wt, *args, 0.0, mm_dtype=mm_dtype, with_residuals=True)
    fb, db, rb = ray_tile.ray_tile_plain(wt, *args, 0.0, mm_dtype=mm_dtype, with_residuals=True)
    torch.cuda.synchronize()
    assert fa.shape == (B, N_WIDE, R) and fa.is_contiguous()
    _close(fa, fb, tol)
    _close(da, db, tol)
    for x, y in zip(ra, rb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert _points_outside(x, y, dict(rtol=tol["rtol"], atol=tol["atol"] * 20)) <= 1e-3
    fa, da = ray_tile.ray_tile_cuda(wt, *args, 0.0, mm_dtype=mm_dtype)
    _close(fa, fb, tol)
    for res in (None, ra):
        ga, pa = ray_tile.ray_tile_bwd_cuda(wt, *args, 0.0, d_fea, d_dep, residuals=res,
                                            mm_dtype=mm_dtype)
        gb, pb = ray_tile.ray_tile_bwd_plain(wt, *args, 0.0, d_fea, d_dep, residuals=res,
                                             mm_dtype=mm_dtype)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(ga, gb)):
            assert a.shape == b.shape
            assert _grad_err(a, b) < BWD_TOL[mm_dtype], f"grad {i}: {_grad_err(a, b):.3e}"
        assert _rays_outside(pa, pb, 1e-4 if mm_dtype == torch.float32 else 1e-2) == 0
    after = {k: build.launches(k) - before[k] for k in build.KERNELS}
    assert after == dict(ray_tile=1, ray_tile_residuals=1, ray_tile_bwd_recompute=1,
                         ray_tile_bwd_residual=1, inr_tile=0, **{k: 0 for k in build.STREAMED})


@pytest.mark.gpu
@pytest.mark.parametrize("mm_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D,in0", [(448, 24), (200, 24), (448, 32)])
def test_inr_tile_kernel_at_padded_widths(cuda_device, D, in0, mm_dtype):
    """D off the 64-channel tiling and in0 off the 16-row weight stage run
    zero-padded, against the plain version at the true widths."""
    x, s, d, w = _inr_inputs(cuda_device, 9, D=D, in0=in0, n=200, b=2)
    before = build.launches("inr_tile")
    out = inr_tile.inr_tile_cuda(x, s, d, w, mm_dtype=mm_dtype)
    ref = inr_tile.inr_tile_plain(x, s, d, w, mm_dtype=mm_dtype)
    torch.cuda.synchronize()
    assert out.shape == (2, 200, 3) and build.launches("inr_tile") == before + 1
    _close(out, ref, F32_TOL if mm_dtype == torch.float32 else INR_BF16_WIDE_TOL)


# ---------------------------------------------- on the card, the streamed path

# Shapes past each of the resident kernels' limits, n ragged against the 64-point products
# and the 8-ray per-ray blocks: S past 64, H past 128 (C = H), the NeRF depth 3 at the
# flagship widths (past the shared memory in f32), R 64 at depth 1, depth 8.
STREAM_SHAPES = {
    "S80": dict(steps=80),
    "H144": dict(hidden=144, color=144, steps=12),
    "L3_flagship": dict(layers=3, hidden=128, rgb=32, steps=24),
    "R64_L1": dict(rgb=64, layers=1, steps=12),
    "L8": dict(layers=8, steps=10),
}
N_STREAM = 37
FLAGS = [dict(), dict(clamp_mode="softplus"), dict(noise_std=0.4), dict(white_back=True),
         dict(last_back=True), dict(fast_sin=True)]
FLAG_IDS = ["relu", "softplus", "noise", "white_back", "last_back", "fast_sin"]


def _cotangents(dev, n, R, seed=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(B, n, R, generator=g, device=dev),
            torch.randn(B, n, 1, generator=g, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("mm_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kwargs", FLAGS, ids=FLAG_IDS)
def test_streamed_ray_tile_matches_plain(cuda_device, mm_dtype, kwargs):
    """#2 and #2r on the streamed path at the narrow shape, every option."""
    wt, args = _ray_inputs(cuda_device)
    kwargs = dict(kwargs)
    ns = kwargs.pop("noise_std", 0.0)
    tol = F32_TOL if mm_dtype == torch.float32 else RAY_BF16_TOL
    before = {k: build.launches(k) for k in ("ray_tile_streamed", "ray_tile_residuals_streamed")}
    fa, da = ray_tile.ray_tile_cuda(wt, *args, ns, mm_dtype=mm_dtype, out_dtype=mm_dtype,
                                    path="streamed", **kwargs)
    fr, dr, ra = ray_tile.ray_tile_cuda(wt, *args, ns, mm_dtype=mm_dtype, with_residuals=True,
                                        path="streamed", **kwargs)
    fb, db, rb = ray_tile.ray_tile_plain(wt, *args, ns, mm_dtype=mm_dtype, with_residuals=True,
                                         **kwargs)
    torch.cuda.synchronize()
    assert {k: build.launches(k) - v for k, v in before.items()} == dict(
        ray_tile_streamed=1, ray_tile_residuals_streamed=1)
    assert fa.dtype == mm_dtype
    _close(fa, fb.to(mm_dtype), tol)
    _close(da, db, tol)
    _close(fr, fb, tol)
    _close(dr, db, tol)
    for x, y in zip(ra, rb):
        # a sine of a large argument can part alone: at most 0.1 % of the points outside
        assert x.dtype == y.dtype and x.shape == y.shape
        assert _points_outside(x, y, dict(rtol=tol["rtol"], atol=tol["atol"] * 20)) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["recompute", "residual"])
@pytest.mark.parametrize("mm_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kwargs", [dict(), dict(noise_std=0.4, clamp_mode="softplus",
                                                 white_back=True, last_back=True, fast_sin=True)],
                         ids=["relu", "noise_softplus_white_last_fast_sin"])
def test_streamed_ray_tile_bwd_matches_plain(cuda_device, mode, mm_dtype, kwargs):
    """#3 on the streamed path at the narrow shape, both modes."""
    wt, args = _ray_inputs(cuda_device)
    kwargs = dict(kwargs)
    ns = kwargs.pop("noise_std", 0.0)
    d_fea, d_dep = _cotangents(cuda_device, N, 16)
    res = None
    if mode == "residual":
        res = ray_tile.ray_tile_cuda(wt, *args, ns, mm_dtype=mm_dtype, with_residuals=True,
                                     path="streamed", **kwargs)[2]
    name = f"ray_tile_bwd_{mode}_streamed"
    before = build.launches(name)
    ga, pa = ray_tile.ray_tile_bwd_cuda(wt, *args, ns, d_fea, d_dep, residuals=res,
                                        mm_dtype=mm_dtype, path="streamed", **kwargs)
    gb, pb = ray_tile.ray_tile_bwd_plain(wt, *args, ns, d_fea, d_dep, residuals=res,
                                         mm_dtype=mm_dtype, **kwargs)
    torch.cuda.synchronize()
    assert build.launches(name) == before + 1
    for i, (a, b) in enumerate(zip(ga, gb)):
        assert a.shape == b.shape
        assert _grad_err(a, b) < BWD_TOL[mm_dtype], f"grad {i}: {_grad_err(a, b):.3e}"
    assert _rays_outside(pa, pb, 1e-4 if mm_dtype == torch.float32 else 1e-2) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("mm_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", list(STREAM_SHAPES))
def test_streamed_ray_tile_past_the_caps(cuda_device, shape, mm_dtype):
    """#2, #2r and #3 (both modes) at shapes the resident kernels do not
    take (or, for R64_L1, do not have to), on the path "auto" picks or the
    streamed one, against the plain version."""
    wt, args = _ray_inputs(cuda_device, n=N_STREAM, **STREAM_SHAPES[shape])
    w = ray_tile.widths(wt)
    S = args[0].shape[2]
    auto = ray_tile.ray_path(S, w.L, w.Hp, w.Cp, w.Rp, mm_dtype, build.smem_optin(cuda_device),
                             ray_tile.library_smem)
    path = "auto" if auto == "streamed" else "streamed"
    d_fea, d_dep = _cotangents(cuda_device, N_STREAM, w.R)
    tol = F32_TOL if mm_dtype == torch.float32 else RAY_BF16_WIDE_TOL
    before = {k: build.launches(k) for k in build.KERNELS}
    fa, da = ray_tile.ray_tile_cuda(wt, *args, 0.0, mm_dtype=mm_dtype, path=path)
    fr, dr, ra = ray_tile.ray_tile_cuda(wt, *args, 0.0, mm_dtype=mm_dtype, with_residuals=True,
                                        path=path)
    fb, db, rb = ray_tile.ray_tile_plain(wt, *args, 0.0, mm_dtype=mm_dtype, with_residuals=True)
    torch.cuda.synchronize()
    for x, y in ((fa, fb), (da, db), (fr, fb), (dr, db)):
        _close(x, y, tol)
    rtol = dict(rtol=tol["rtol"], atol=tol["atol"] * 20)
    r64 = None
    for i, (x, y) in enumerate(zip(ra, rb)):
        assert x.dtype == y.dtype and x.shape == y.shape
        if _points_outside(x, y, rtol) <= 1e-3:
            continue
        # deep SIRENs (8 FiLM layers of gains ~30) carry a rounding into a few points' hidden
        # states: then the kernel may part from a float64 run of the plain version on at most
        # twice the points the f32 plain version parts from it on
        if r64 is None:
            r64 = ray_tile.ray_tile_plain([w.double() for w in wt], *[a.double() for a in args],
                                          0.0, mm_dtype=torch.float64, with_residuals=True)[2]
        y64 = r64[i].to(y.dtype) if mm_dtype == torch.bfloat16 else r64[i]
        assert _points_outside(x, y64, rtol) <= max(1e-3, 2 * _points_outside(y, y64, rtol)), i
    for res in (None, ra):
        ga, pa = ray_tile.ray_tile_bwd_cuda(wt, *args, 0.0, d_fea, d_dep, residuals=res,
                                            mm_dtype=mm_dtype, path=path)
        gb, pb = ray_tile.ray_tile_bwd_plain(wt, *args, 0.0, d_fea, d_dep, residuals=res,
                                             mm_dtype=mm_dtype)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(ga, gb)):
            assert a.shape == b.shape
            assert _grad_err(a, b) < BWD_TOL[mm_dtype], f"grad {i}: {_grad_err(a, b):.3e}"
        assert _rays_outside(pa, pb, 1e-4 if mm_dtype == torch.float32 else 1e-2) == 0
    after = {k: build.launches(k) - before[k] for k in build.KERNELS}
    assert after == {k: int(k in ("ray_tile_streamed", "ray_tile_residuals_streamed",
                                  "ray_tile_bwd_recompute_streamed",
                                  "ray_tile_bwd_residual_streamed")) for k in build.KERNELS}


@pytest.mark.gpu
@pytest.mark.parametrize("mm_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", ["S80", "L3_flagship"])
def test_streamed_ray_tile_deterministic(cuda_device, shape, mm_dtype):
    """With density noise, #2, #2r and #3 in both modes on the streamed
    path give the same bits twice (the weight grads included)."""
    wt, args = _ray_inputs(cuda_device, n=N_STREAM, **STREAM_SHAPES[shape])
    d_fea, d_dep = _cotangents(cuda_device, N_STREAM, wt[-4].shape[1])
    kw = dict(mm_dtype=mm_dtype, path="streamed")

    def run():
        fea, dep = ray_tile.ray_tile_cuda(wt, *args, 0.4, **kw)
        fr, dr, res = ray_tile.ray_tile_cuda(wt, *args, 0.4, with_residuals=True, **kw)
        out = [fea, dep, fr, dr, *res]
        for r in (None, res):
            g, p = ray_tile.ray_tile_bwd_cuda(wt, *args, 0.4, d_fea, d_dep, residuals=r, **kw)
            out += g + [p]
        return out

    for a, b in zip(run(), run()):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("mm_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_streamed_against_resident_flagship(cuda_device, mm_dtype):
    """At the flagship shape (L 2, H 128, C 64, R 32, S 24), which both
    paths take, path="streamed" against path="resident": #2, #2r and #3
    (both modes) within the kernel rows' tolerances.  "auto" there is the
    resident path."""
    wt, args = _ray_inputs(cuda_device, n=N_WIDE, steps=24, **FLAGSHIP)
    assert ray_tile.ray_path_of(wt, args[0], mm_dtype) == "resident"
    d_fea, d_dep = _cotangents(cuda_device, N_WIDE, 32)
    tol = F32_TOL if mm_dtype == torch.float32 else RAY_BF16_WIDE_TOL
    out = {}
    for path in ("resident", "streamed"):
        fea, dep = ray_tile.ray_tile_cuda(wt, *args, 0.0, mm_dtype=mm_dtype, path=path)
        fr, dr, res = ray_tile.ray_tile_cuda(wt, *args, 0.0, mm_dtype=mm_dtype,
                                             with_residuals=True, path=path)
        grads = [ray_tile.ray_tile_bwd_cuda(wt, *args, 0.0, d_fea, d_dep, residuals=r,
                                            mm_dtype=mm_dtype, path=path) for r in (None, res)]
        out[path] = (fea, dep, fr, dr, res, grads)
    torch.cuda.synchronize()
    a, b = out["streamed"], out["resident"]
    for x, y in zip(a[:4], b[:4]):
        _close(x, y, tol)
    for x, y in zip(a[4], b[4]):
        assert _points_outside(x, y, dict(rtol=tol["rtol"], atol=tol["atol"] * 20)) <= 1e-3
    for (ga, pa), (gb, pb) in zip(a[5], b[5]):
        for x, y in zip(ga, gb):
            assert _grad_err(x, y) < BWD_TOL[mm_dtype]
        assert _rays_outside(pa, pb, 1e-4 if mm_dtype == torch.float32 else 1e-2) == 0
    with pytest.raises(ValueError, match="path='resident'"):
        wt3, args3 = _ray_inputs(cuda_device, n=5, steps=12, layers=3, hidden=128, rgb=32)
        ray_tile.ray_tile_cuda(wt3, *args3, path="resident")


@pytest.mark.gpu
def test_streamed_bf16_tolerance_sees_the_rounding(cuda_device):
    """Controls: the f32 streamed kernels lie outside the bf16 tolerances of
    the bf16 plain versions (#2, #3, #1), and the bf16 streamed #2 outside
    the f32 tolerance of the f32 plain version."""
    wt, args = _ray_inputs(cuda_device, n=N_STREAM, **STREAM_SHAPES["L3_flagship"])
    out = ray_tile.ray_tile_cuda(wt, *args, path="streamed")[0]
    ref = ray_tile.ray_tile_plain(wt, *args, mm_dtype=torch.bfloat16)[0]
    with pytest.raises(AssertionError):
        _close(out, ref, RAY_BF16_WIDE_TOL)
    out_b = ray_tile.ray_tile_cuda(wt, *args, mm_dtype=torch.bfloat16, path="streamed")[0]
    with pytest.raises(AssertionError):
        _close(out_b, ray_tile.ray_tile_plain(wt, *args)[0], F32_TOL)
    d_fea, d_dep = _cotangents(cuda_device, N_STREAM, 32)
    ga, _ = ray_tile.ray_tile_bwd_cuda(wt, *args, 0.0, d_fea, d_dep, path="streamed")
    gb, _ = ray_tile.ray_tile_bwd_plain(wt, *args, 0.0, d_fea, d_dep, mm_dtype=torch.bfloat16)
    assert max(_grad_err(a, b) for a, b in zip(ga, gb)) > BWD_TOL[torch.bfloat16]
    x, s, d, w = _inr_inputs(cuda_device, 9, D=576, in0=32, n=70)
    out = inr_tile.inr_tile_cuda(x, s, d, w, path="streamed")
    ref = inr_tile.inr_tile_plain(x, s, d, w, mm_dtype=torch.bfloat16)
    with pytest.raises(AssertionError):
        _close(out, ref, INR_BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("mm_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D,n_blocks,n", [(64, 9, 70), (576, 9, 133), (1024, 5, 65),
                                          (512, 4, 1)])
def test_streamed_inr_tile_matches_plain(cuda_device, D, n_blocks, n, mm_dtype):
    """#1 on the streamed path (past 512, where "auto" takes it, and below,
    where it is asked for) against the plain version, n ragged against the
    64-pixel products; twice, bit for bit."""
    x, s, d, w = _inr_inputs(cuda_device, n_blocks, D=D, in0=32, n=n, b=2)
    path = "auto" if D > inr_tile.MAX_WIDTH else "streamed"
    before = {k: build.launches(k) for k in ("inr_tile", "inr_tile_streamed")}
    out = inr_tile.inr_tile_cuda(x, s, d, w, mm_dtype=mm_dtype, path=path)
    again = inr_tile.inr_tile_cuda(x, s, d, w, mm_dtype=mm_dtype, path=path)
    ref = inr_tile.inr_tile_plain(x, s, d, w, mm_dtype=mm_dtype)
    torch.cuda.synchronize()
    assert {k: build.launches(k) - v for k, v in before.items()} == dict(inr_tile=0,
                                                                         inr_tile_streamed=2)
    assert torch.equal(out, again)
    _close(out, ref, F32_TOL if mm_dtype == torch.float32 else INR_BF16_WIDE_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("mm_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_streamed_inr_against_resident(cuda_device, mm_dtype):
    """At D = 512, which both paths take: path="streamed" against
    path="resident", within the kernel rows' tolerances; "resident" past
    512 raises."""
    x, s, d, w = _inr_inputs(cuda_device, 9, D=512, in0=32, n=200, b=2)
    a = inr_tile.inr_tile_cuda(x, s, d, w, mm_dtype=mm_dtype, path="streamed")
    b = inr_tile.inr_tile_cuda(x, s, d, w, mm_dtype=mm_dtype, path="resident")
    _close(a, b, F32_TOL if mm_dtype == torch.float32 else INR_BF16_WIDE_TOL)
    with pytest.raises(ValueError, match="path='resident'"):
        inr_tile.inr_tile_cuda(*_inr_inputs(cuda_device, 4, D=576, in0=32, n=3), path="resident")


@pytest.mark.gpu
def test_layout_mirror_matches_library(cuda_device):
    """`resident_smem`, the CPU's mirror of the resident layouts, is the
    library's own count (`library_smem`, which the wrappers' choice reads on
    the card), at the shapes the tests and the main path take; the resident
    INR layout, the same at every D up to MAX_WIDTH, fits the card."""
    lib = build.library()
    for S, L, H, C, R in ((10, 2, 32, 16, 16), (24, 2, 128, 64, 32), (64, 2, 128, 128, 32),
                          (24, 3, 128, 64, 32), (12, 1, 32, 16, 64), (2, 2, 32, 16, 16)):
        for mm in (torch.float32, torch.bfloat16):
            assert ray_tile.resident_smem(S, L, H, C, R, mm) == ray_tile.library_smem(
                S, L, H, C, R, mm)
    optin = build.smem_optin(cuda_device)
    assert optin > 0
    for mm in (0, 1):
        assert 0 < lib.cips_inr_tile_smem(mm) <= optin


@pytest.mark.gpu
@pytest.mark.parametrize("mm_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_resident_path_takes_two_samples(cuda_device, mm_dtype):
    """S = 2, which JAX takes: #2 and #3 (residual mode) against the plain
    version on the resident path."""
    wt, args = _ray_inputs(cuda_device, steps=2)
    tol = F32_TOL if mm_dtype == torch.float32 else RAY_BF16_TOL
    fa, da, ra = ray_tile.ray_tile_cuda(wt, *args, mm_dtype=mm_dtype, with_residuals=True,
                                        path="resident")
    fb, db = ray_tile.ray_tile_plain(wt, *args, mm_dtype=mm_dtype)
    _close(fa, fb, tol)
    _close(da, db, tol)
    d_fea, d_dep = _cotangents(cuda_device, N, 16)
    ga, pa = ray_tile.ray_tile_bwd_cuda(wt, *args, 0.0, d_fea, d_dep, residuals=ra,
                                        mm_dtype=mm_dtype, path="resident")
    gb, pb = ray_tile.ray_tile_bwd_plain(wt, *args, 0.0, d_fea, d_dep, residuals=ra,
                                         mm_dtype=mm_dtype)
    for a, b in zip(ga, gb):
        assert _grad_err(a, b) < BWD_TOL[mm_dtype]


# the streamed products' edges (`csrc/stream_gemm.cuh`: 128-row tiles, 128 / 64 / 32-column
# tiles, 16-deep (f32) or 32-deep (bf16) panels; the head kernel's 64-column colour slabs and
# 32-column rgb slabs): ragged rows over b = 2 batch rows, widths off the tiles, depths off
# the panels
CORE_RAY_SHAPES = {
    "C64_R32_ragged": dict(hidden=128, rgb=32, n=37, steps=10),       # 370 rows a batch row
    "H48_C48_R16": dict(hidden=48, color=48, rgb=16, n=45, steps=6),  # half tiles, half panels
    "H96_C144_R48": dict(hidden=96, color=144, rgb=48, n=29, steps=9),  # 3 colour, 2 rgb slabs
}
CORE_INR_SHAPES = {
    "D528_in48": dict(D=528, in0=48, n=133, b=2),   # D padded to 576: 4.5 column tiles
    "D576_in16": dict(D=576, in0=16, n=129, b=3),   # the first K under one bf16 panel
}


@pytest.mark.gpu
@pytest.mark.parametrize("mm_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", list(CORE_RAY_SHAPES))
def test_stream_core_ray_edges(cuda_device, shape, mm_dtype):
    """#2, #2r and #3 (residual mode) on the streamed path at shapes off the
    new core's tiles, against the plain version; twice, bit for bit."""
    kw = dict(CORE_RAY_SHAPES[shape])
    n = kw.pop("n")
    wt, args = _ray_inputs(cuda_device, n=n, **kw)
    d_fea, d_dep = _cotangents(cuda_device, n, kw["rgb"])
    tol = F32_TOL if mm_dtype == torch.float32 else RAY_BF16_WIDE_TOL

    def run():
        fea, dep = ray_tile.ray_tile_cuda(wt, *args, 0.0, mm_dtype=mm_dtype, path="streamed")
        fr, dr, res = ray_tile.ray_tile_cuda(wt, *args, 0.0, mm_dtype=mm_dtype,
                                             with_residuals=True, path="streamed")
        g, p = ray_tile.ray_tile_bwd_cuda(wt, *args, 0.0, d_fea, d_dep, residuals=res,
                                          mm_dtype=mm_dtype, path="streamed")
        return [fea, dep, fr, dr, *res, *g, p]

    got, again = run(), run()
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    fb, db, rb = ray_tile.ray_tile_plain(wt, *args, 0.0, mm_dtype=mm_dtype, with_residuals=True)
    for x, y in ((got[0], fb), (got[1], db), (got[2], fb), (got[3], db)):
        _close(x, y, tol)
    for x, y in zip(got[4:8], rb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert _points_outside(x, y, dict(rtol=tol["rtol"], atol=tol["atol"] * 20)) <= 1e-3
    gb, pb = ray_tile.ray_tile_bwd_plain(wt, *args, 0.0, d_fea, d_dep, residuals=got[4:8],
                                         mm_dtype=mm_dtype)
    for i, (a, b) in enumerate(zip(got[8:-1], gb)):
        assert a.shape == b.shape
        assert _grad_err(a, b) < BWD_TOL[mm_dtype], f"grad {i}: {_grad_err(a, b):.3e}"
    assert _rays_outside(got[-1], pb, 1e-4 if mm_dtype == torch.float32 else 1e-2) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("mm_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", list(CORE_INR_SHAPES))
def test_stream_core_inr_edges(cuda_device, shape, mm_dtype):
    """#1 on the streamed path (the ToRGB in the products' epilogues) at
    widths and depths off the new core's tiles, b > 1, against the plain
    version; twice, bit for bit."""
    x, s, d, w = _inr_inputs(cuda_device, 9, **CORE_INR_SHAPES[shape])
    out = inr_tile.inr_tile_cuda(x, s, d, w, mm_dtype=mm_dtype, path="streamed")
    again = inr_tile.inr_tile_cuda(x, s, d, w, mm_dtype=mm_dtype, path="streamed")
    ref = inr_tile.inr_tile_plain(x, s, d, w, mm_dtype=mm_dtype)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    _close(out, ref, F32_TOL if mm_dtype == torch.float32 else INR_BF16_WIDE_TOL)


@pytest.mark.gpu
def test_stream_rows_are_the_library_tile(cuda_device):
    """The streamed backward's per-chunk sums are sized by the library's own
    row tile (`cips_stream_tile`), which the wrapper reads: at n S one row
    past a whole number of tiles the last chunk (one row a batch row) still
    counts in the FiLM and bias grads."""
    lib = build.library()
    rows = ray_tile.stream_rows(lib)
    assert rows == lib.cips_stream_tile(0) and rows % 16 == 0
    assert lib.cips_stream_tile(1) % rows == 0 or rows % lib.cips_stream_tile(1) == 0
    steps = 4
    n = (2 * rows + 1 + steps - 1) // steps   # n S past 2 tiles
    wt, args = _ray_inputs(cuda_device, n=n, steps=steps, hidden=32, rgb=16)
    assert (n * steps) % rows != 0
    d_fea, d_dep = _cotangents(cuda_device, n, 16)
    ga, _ = ray_tile.ray_tile_bwd_cuda(wt, *args, 0.0, d_fea, d_dep, path="streamed")
    gb, _ = ray_tile.ray_tile_bwd_plain(wt, *args, 0.0, d_fea, d_dep)
    for i, (a, b) in enumerate(zip(ga, gb)):
        assert _grad_err(a, b) < BWD_TOL[torch.float32], f"grad {i}: {_grad_err(a, b):.3e}"


# the streamed backward's weight grads (one launch, the points as the depth in splits of
# STREAM_SPLIT_ROWS) and its final sums (fixed row groups of each batch row's 128-row chunks): a
# last split and a last chunk only partly full, the most products (depth 8: w_0 .. w_7, wc
# with ws, wr), and widths past one 128-row tile
BWD_EDGE_SHAPES = {
    "ragged": dict(n=130, steps=10),          # 5200 points: 6 splits; n S = 10 x 128 + 20
    "L8": dict(layers=8, n=110, steps=10),    # 4400 points; n S = 8 x 128 + 76
    "H144": dict(hidden=144, color=144, n=61, steps=12),   # 2928 points; n S = 5 x 128 + 92
}


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["recompute", "residual"])
@pytest.mark.parametrize("mm_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", list(BWD_EDGE_SHAPES))
def test_streamed_bwd_weight_grads_and_sums(cuda_device, shape, mm_dtype, mode):
    """#3 on the streamed path at the edges of its weight-grad products and
    final sums, the exact sine, against the plain backward on the residuals
    of the streamed forward (the ones recompute mode computes again: at depth
    8 an f32 forward parts from the plain one on a few points, which
    test_streamed_ray_tile_past_the_caps holds to a float64 witness)."""
    kw = dict(BWD_EDGE_SHAPES[shape])
    n = kw.pop("n")
    wt, args = _ray_inputs(cuda_device, n=n, **kw)
    w = ray_tile.widths(wt)
    rows, chunk = B * 2 * n * kw["steps"], ray_tile.stream_rows(build.library())
    split = ray_tile.STREAM_SPLIT_ROWS
    assert rows > split and rows % split and (n * kw["steps"]) % chunk
    d_fea, d_dep = _cotangents(cuda_device, n, w.R)
    res = ray_tile.ray_tile_cuda(wt, *args, 0.0, mm_dtype=mm_dtype, with_residuals=True,
                                 path="streamed")[2]
    ga, pa = ray_tile.ray_tile_bwd_cuda(wt, *args, 0.0, d_fea, d_dep,
                                        residuals=res if mode == "residual" else None,
                                        mm_dtype=mm_dtype, path="streamed")
    gb, pb = ray_tile.ray_tile_bwd_plain(wt, *args, 0.0, d_fea, d_dep, residuals=res,
                                         mm_dtype=mm_dtype)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(ga, gb)):
        assert a.shape == b.shape
        assert _grad_err(a, b) < BWD_TOL[mm_dtype], f"grad {i}: {_grad_err(a, b):.3e}"
    assert _rays_outside(pa, pb, 1e-4 if mm_dtype == torch.float32 else 1e-2) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("mm_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_streamed_bwd_edges_deterministic(cuda_device, mm_dtype):
    """Under density noise, #3 in both modes at the ragged split and chunk
    gives the same bits twice, with the exact and the polynomial sine."""
    wt, args = _ray_inputs(cuda_device, n=130, steps=10)
    d_fea, d_dep = _cotangents(cuda_device, 130, 16)
    for fast in (False, True):
        kw = dict(mm_dtype=mm_dtype, path="streamed", fast_sin=fast)
        res = ray_tile.ray_tile_cuda(wt, *args, 0.4, with_residuals=True, **kw)[2]
        for r in (None, res):
            once = ray_tile.ray_tile_bwd_cuda(wt, *args, 0.4, d_fea, d_dep, residuals=r, **kw)
            again = ray_tile.ray_tile_bwd_cuda(wt, *args, 0.4, d_fea, d_dep, residuals=r, **kw)
            for a, b in zip(once[0] + [once[1]], again[0] + [again[1]]):
                assert torch.equal(a, b)
