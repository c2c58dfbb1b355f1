"""Fused CIPS-INR decoder (forward / serving path).

Counterpart of `cips3d_tpu/ops/pallas/inr_tile.py`.  The modulation of
every SinStyleMod is per batch, not per pixel:

    out = lrelu( demod * ((x * s) @ W) ),   s = mod(style) + 1,
    demod = rsqrt((s^2) @ (W^2) + eps)

so ``s`` and ``demod`` are (b, dim) vectors computed outside the kernel
(`compute_inr_mods`, 18 tiny matmuls), and the decode itself is 18 scaled
matmuls with leaky-ReLU, the residual from block 4, ToRGB accumulation
from block 3 and a final tanh.  Two versions of that decode:
  * `inr_tile_plain`, CIPSNet's math in PyTorch ops on the extracted weights;
  * `inr_tile_cuda`, the hand-written kernel of `csrc/inr_tile.cu`.
`inr_tile` runs the plain version for CPU tensors and the kernel for CUDA
tensors; a failed build or launch raises.  Forward only: the G phase
decodes through `CIPSNet` under autograd.
"""

from __future__ import annotations

import math
from typing import List, Mapping, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from cips3d_tpu_torch.models.cips_net import CIPS_RESOLUTIONS, FIRST_RGB, FIRST_SKIP
from cips3d_tpu_torch.ops import build

MAX_WIDTH = 512    # the kernel's 16 warps x 32 channels cover hidden widths up to 512
TILE_PIXELS = 64   # pixels per tile of the kernel (`kPix` of csrc/inr_tile.cu)


class InrWeights(NamedTuple):
    """The decode's weights in (in, out) layout, all float32."""

    w0: torch.Tensor      # (in0, D) first layer
    wrest: torch.Tensor   # (2 * n_blocks - 1, D, D)
    wr: torch.Tensor      # (n_blocks - 3, D, 3) ToRGB kernels from block 3
    br: torch.Tensor      # (n_blocks - 3, 3)


def num_blocks(img_size: int) -> int:
    """Blocks run for ``img_size``: resolutions "4".."1024", 2^k -> k - 1."""
    return min(int(math.log2(img_size)) - 1, len(CIPS_RESOLUTIONS))


def extract_inr_weights(inr_net, n_blocks: int) -> Tuple[InrWeights, List]:
    """Stack a `CIPSNet`'s weights for the decode; also returns the
    per-layer modulation FCs as [(SinStyleMod, style key)] for
    `compute_inr_mods`."""
    w, mods = [], []
    for i in range(n_blocks):
        res = CIPS_RESOLUTIONS[i]
        block = inr_net.network[res]
        for j, stage in enumerate((block.mod1, block.mod2)):
            w.append(stage.weight[0])
            mods.append((stage, f"{inr_net.name_prefix}_w{res}_{j}"))
    rgbs = [inr_net.to_rgbs[CIPS_RESOLUTIONS[i]].linear for i in range(FIRST_RGB, n_blocks)]
    weights = InrWeights(
        w0=w[0].float().contiguous(),
        wrest=torch.stack(w[1:]).float().contiguous(),
        wr=torch.stack([lin.weight.T for lin in rgbs]).float().contiguous(),
        br=torch.stack([lin.bias for lin in rgbs]).float().contiguous(),
    )
    return weights, mods


def compute_inr_mods(mods, style_dict: Mapping[str, torch.Tensor], D: int,
                     eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-layer (s, demod), each (b, L, D) f32.  s = mod(style) + 1,
    zero-padded to D for the first layer; demod uses the unpadded shapes."""
    s_rows, d_rows = [], []
    for stage, key in mods:
        s = (style_dict[key].float() @ stage.modulation.weight.T.float()
             + stage.modulation.bias.float() + 1.0)
        w = stage.weight[0].float()
        d_rows.append(torch.rsqrt((s * s) @ (w * w) + eps))
        s_rows.append(F.pad(s, (0, D - s.shape[1])))
    return torch.stack(s_rows, 1).contiguous(), torch.stack(d_rows, 1).contiguous()


def inr_tile_plain(x: torch.Tensor, s: torch.Tensor, d: torch.Tensor, weights: InrWeights,
                   mm_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version: x (b, n, in0), s/d (b, L, D) → tanh(rgb)
    (b, n, 3) f32; with ``mm_dtype`` float64 all of it runs in float64 (a
    witness of the f32 versions' rounding)."""
    acc = torch.float64 if mm_dtype == torch.float64 else torch.float32

    def mm(t):  # round to the matmul-input dtype; products of the rounded values are exact in acc
        return t.to(mm_dtype).to(acc)

    n_blocks = (weights.wrest.shape[0] + 1) // 2
    x, s, d = x.to(acc), s.to(acc), d.to(acc)
    rgb = None
    for blk in range(n_blocks):
        x_orig = x
        for j in (0, 1):
            layer = 2 * blk + j
            w = weights.w0 if layer == 0 else weights.wrest[layer - 1]
            xs = mm(x * s[:, layer, None, :w.shape[0]])
            x = F.leaky_relu((xs @ mm(w)) * d[:, layer, None, :], 0.2)
        if blk >= FIRST_SKIP:
            x = x + x_orig
        if blk >= FIRST_RGB:
            r = blk - FIRST_RGB
            out = mm(x) @ mm(weights.wr[r]) + weights.br[r].to(acc)
            rgb = out if rgb is None else rgb + out
    return torch.tanh(rgb)


def forward_grid(b: int, n: int, sms: int) -> int:
    """Blocks of the persistent kernel: one per SM, or one per 64-pixel tile
    when there are fewer.  Block i walks tiles i, i + grid, ... of the
    b * ceil(n / 64) tiles, tile t covering pixels 64 (t % ceil(n / 64)) on
    of batch row t // ceil(n / 64)."""
    return max(1, min(b * -(-n // TILE_PIXELS), sms))


def scratch_shape(grid: int, D: int) -> Tuple[int, int, int]:
    """The kernel's f32 scratch: one slot a block, holding the block input
    of its tile for the residual."""
    return (grid, TILE_PIXELS, D)


def inr_tile_cuda(x: torch.Tensor, s: torch.Tensor, d: torch.Tensor, weights: InrWeights,
                  mm_dtype=torch.float32) -> torch.Tensor:
    """The CUDA kernel (`csrc/inr_tile.cu`); same arguments and result as
    `inr_tile_plain`.  Raises if the library cannot be built or the launch
    fails; never falls back to the plain version."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"inr_tile_cuda needs CUDA tensors, got {dev}")
    b, n, in0 = x.shape
    L, D = s.shape[1], s.shape[2]
    n_blocks = L // 2
    if D % 64 or D > MAX_WIDTH or in0 % 16 or in0 > D or n_blocks <= FIRST_RGB:
        raise ValueError(f"unsupported shape: D={D} (multiple of 64, <= {MAX_WIDTH}), "
                         f"in0={in0} (multiple of 16, <= D), n_blocks={n_blocks} (> {FIRST_RGB})")
    if mm_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mm dtype must be float32 or bfloat16, got {mm_dtype}")
    expect = {"x": (x, (b, n, in0)), "s": (s, (b, L, D)), "d": (d, (b, L, D)),
              "w0": (weights.w0, (in0, D)), "wrest": (weights.wrest, (L - 1, D, D)),
              "wr": (weights.wr, (n_blocks - FIRST_RGB, D, 3)),
              "br": (weights.br, (n_blocks - FIRST_RGB, 3))}
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"{name}: expected float32 {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    x, s, d = x.contiguous(), s.contiguous(), d.contiguous()
    w0 = weights.w0.to(mm_dtype).contiguous()
    wrest = weights.wrest.to(mm_dtype).contiguous()
    wr = weights.wr.to(mm_dtype).contiguous()
    br = weights.br.contiguous()
    lib = build.library()
    if lib.cips_inr_tile_pixels() != TILE_PIXELS:
        raise RuntimeError("the kernel library's tile is not TILE_PIXELS")
    grid = forward_grid(b, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    out = torch.empty((b, n, 3), dtype=torch.float32, device=dev)
    scratch = torch.empty(scratch_shape(grid, D), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cips_inr_tile_forward(
            x.data_ptr(), s.data_ptr(), d.data_ptr(), w0.data_ptr(), wrest.data_ptr(),
            wr.data_ptr(), br.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            b, n, in0, D, n_blocks, int(mm_dtype == torch.bfloat16), grid, stream)
    build.check(lib, err, "inr_tile")
    inr_tile_cuda.launches += 1
    return out


inr_tile_cuda.launches = 0


def kernel_occupancy(D: int, mm_dtype=torch.float32) -> Tuple[int, int, int]:
    """Resident warps per SM, dynamic shared memory (bytes) and threads of
    the kernel at width D, from the CUDA occupancy API."""
    import ctypes

    lib = build.library()
    buf = (ctypes.c_int * 3)()
    build.check(lib, lib.cips_inr_tile_occupancy(D, int(mm_dtype == torch.bfloat16), buf),
                "inr_tile occupancy")
    return tuple(buf)


def inr_tile(x, *args, **kwargs):
    """`inr_tile_plain` for CPU tensors, `inr_tile_cuda` otherwise."""
    if x.device.type == "cpu":
        return inr_tile_plain(x, *args, **kwargs)
    return inr_tile_cuda(x, *args, **kwargs)


class _ForwardOnly(torch.autograd.Function):
    """Passes the decode's output through; its backward raises, as
    autodiff of the Pallas decode does: the kernel has no backward."""

    @staticmethod
    def forward(ctx, out, *inputs):
        return out.view_as(out)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("fused_inr_decode is forward only (the INR-tile kernel has no "
                           "backward): train with GeneratorConfig(fused_inr=False)")


def fused_inr_decode(inr_net, style_dict: Mapping[str, torch.Tensor], x: torch.Tensor, *,
                     img_size: int = 1024, dtype=torch.float32) -> torch.Tensor:
    """Forward equivalent of `CIPSNet.forward` for pre_rgb_dim = 3:
    x (b, n, in0) → tanh(rgb) (b, n, 3) in ``dtype``.  Forward only:
    differentiating the result raises."""
    n_blocks = num_blocks(img_size)
    if n_blocks <= FIRST_RGB:
        raise ValueError(f"fused_inr_decode needs >= 4 blocks (img_size >= 32); got "
                         f"img_size={img_size} - use CIPSNet")
    mm_dtype = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
    with torch.no_grad():
        weights, mods = extract_inr_weights(inr_net, n_blocks)
        s, d = compute_inr_mods(mods, style_dict, weights.wrest.shape[-1])
        out = inr_tile(x.float().contiguous(), s, d, weights, mm_dtype=mm_dtype).to(dtype)
    if torch.is_grad_enabled():
        out = _ForwardOnly.apply(out, x, *style_dict.values())
    return out
