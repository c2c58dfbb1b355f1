"""Operations and bytes of one call of each hand-written kernel, from its
shapes: a multiply-add is 2 FLOP; each input byte is read once and each
output byte written once (float32, 4 bytes).

#2  ray tile forward: per ray S coarse and S fine points through the
    FiLM-SIREN (depth L, width H, colour width C, feature width R).
#2r the same, writing each point's residuals (pre-activation and output of
    every hidden layer and of the colour layer).
#3  ray tile backward from the residuals: d-weights at every point and
    d-inputs, except d-points of the fine points (the resample is
    detached).
#1  INR tile: the modulated FC decode, per pixel ``layers`` products
    (in0 -> D, then D -> D) and ``heads`` ToRGB heads (D -> 3).
"""

from __future__ import annotations

from typing import Tuple


def siren_macs(H: int, L: int, C: int, R: int) -> int:
    """Multiply-adds of the FiLM-SIREN a point: the first layer from the
    3 coordinates, L - 1 hidden layers, the colour FiLM layer, the feature
    head and the density head."""
    return 3 * H + (L - 1) * H * H + H * C + C * R + H


def _ray_inputs(b: int, n: int, S: int, H: int, L: int, C: int, R: int) -> int:
    """Bytes of #2's inputs: points (S x 3), origin and direction, depths,
    resample uniforms and noise (S each), compositing noise (2S), the
    weights, and each row's FiLM frequencies and phases."""
    return 4 * (b * n * (3 * S + 6 + 3 * S + 2 * S) + siren_macs(H, L, C, R)
                + b * (2 * L * H + 2 * C))


def ray_tile(b: int, n: int, S: int, H: int, L: int, C: int, R: int) -> Tuple[float, float]:
    """#2: (FLOP, bytes) of one call on b x n rays of S coarse samples."""
    pts = b * n * 2 * S
    return (2.0 * pts * siren_macs(H, L, C, R),
            float(_ray_inputs(b, n, S, H, L, C, R) + 4 * b * n * (R + 1)))


def ray_tile_residuals(b: int, n: int, S: int, H: int, L: int, C: int,
                       R: int) -> Tuple[float, float]:
    """#2r: #2 and each point's residuals (a and h of every layer, f32)."""
    pts = b * n * 2 * S
    flops, nbytes = ray_tile(b, n, S, H, L, C, R)
    return flops, nbytes + 8.0 * pts * (L * H + C)


def ray_tile_bwd(b: int, n: int, S: int, H: int, L: int, C: int, R: int) -> Tuple[float, float]:
    """#3 from residuals: reads #2's inputs, the residuals and the
    cotangents of the feature and depth; writes the weights', the FiLM
    rows' and the coarse points' gradients."""
    pts = b * n * 2 * S
    macs = siren_macs(H, L, C, R)
    bwd_macs = pts * 2 * macs - (pts // 2) * 3 * H
    nbytes = (_ray_inputs(b, n, S, H, L, C, R) + 8 * pts * (L * H + C) + 4 * b * n * (R + 1)
              + 4 * (macs + b * (2 * L * H + 2 * C) + b * n * S * 3))
    return 2.0 * bwd_macs, float(nbytes)


def inr_tile(b: int, n: int, in0: int, D: int, layers: int, heads: int) -> Tuple[float, float]:
    """#1: (FLOP, bytes) of one call on b x n pixels."""
    macs = in0 * D + (layers - 1) * D * D + heads * D * 3
    weights = in0 * D + (layers - 1) * D * D + heads * (3 * D + 3)
    nbytes = 4 * (b * n * (in0 + 3) + 2 * b * layers * D + weights)
    return 2.0 * b * n * macs, float(nbytes)


def pixel_macs(cfg: dict, S: int) -> int:
    """Multiply-adds of the generator's forward a pixel: the SIREN at S
    coarse and S fine points, the INR decode through all nine blocks (as
    the render path runs it: the first layer from the R features, 17 layers
    D -> D, the six ToRGB heads of blocks 3-8), the aux head, and the
    camera's rotation (3 x 3) of each coarse sample and of the ray.  The
    mapping nets and the per-image modulations are left out: they run once
    an image, under a thousandth of its work at r64 and above."""
    H, L, R = cfg["nerf_hidden_dim"], cfg["nerf_hidden_layers"], cfg["nerf_rgb_dim"]
    D = cfg["inr_hidden_dim"]
    return (2 * S * siren_macs(H, L, H // 2, R) + R * D + 17 * D * D + 6 * D * 3 + R * 3
            + 9 * (S + 1))
