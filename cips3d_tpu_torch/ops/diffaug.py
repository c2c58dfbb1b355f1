"""Differentiable augmentation (DiffAugment): counterpart of
`cips3d_tpu/ops/diffaug.py`.

Colour (brightness, saturation, contrast), an integer translation by up to
1/8 of the image with zero padding, and a cutout of about 1/5 of it, all
differentiable in the image (NCHW).  The random draws come in as one
`DiffAugDraws` per batch; `draw_diffaug` makes them from a
`torch.Generator`.  Translation is a gather of the zero-padded image at
clipped indices and cutout a box mask, where the JAX package contracts
one-hot matrices: the results are the same.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class DiffAugDraws(NamedTuple):
    """The draws of one `diff_augment` call on a batch of b images."""

    brightness: torch.Tensor   # (b,) U[0, 1)
    saturation: torch.Tensor   # (b,) U[0, 1)
    contrast: torch.Tensor     # (b,) U[0, 1)
    shift_h: torch.Tensor      # (b,) int in [-round(h/8), round(h/8)]
    shift_w: torch.Tensor      # (b,) int in [-round(w/8), round(w/8)]
    cut_h: torch.Tensor        # (b,) int in [0, h + 1 - cut_h % 2)
    cut_w: torch.Tensor        # (b,) int in [0, w + 1 - cut_w % 2)


def _sizes(h: int, w: int):
    """(shift_h, shift_w, cut_h, cut_w): 1/8 of the image's sides for the
    translation, 1/5 for the cutout, rounded."""
    return int(h * 0.125 + 0.5), int(w * 0.125 + 0.5), int(h * 0.2 + 0.5), int(w * 0.2 + 0.5)


def draw_diffaug(b: int, h: int, w: int, generator: Optional[torch.Generator] = None,
                 device=None) -> DiffAugDraws:
    """The draws of one call on b images of h x w."""
    sh, sw, ch, cw = _sizes(h, w)

    def u():
        return torch.rand((b,), generator=generator, device=device)

    def randint(lo, hi):
        return torch.randint(lo, hi, (b,), generator=generator, device=device)

    return DiffAugDraws(u(), u(), u(), randint(-sh, sh + 1), randint(-sw, sw + 1),
                        randint(0, h + (1 - ch % 2)), randint(0, w + (1 - cw % 2)))


def _per_sample(v, x):
    return v.to(x.dtype).reshape(-1, 1, 1, 1)


def rand_brightness(x, u):
    """x + (u - 0.5) per sample."""
    return x + (_per_sample(u, x) - 0.5)


def rand_saturation(x, u):
    """(x - mean over channels) * 2u + that mean."""
    x_mean = x.mean(1, keepdim=True)
    return (x - x_mean) * (_per_sample(u, x) * 2.0) + x_mean


def rand_contrast(x, u):
    """(x - mean over the sample) * (u + 0.5) + that mean."""
    x_mean = x.mean((1, 2, 3), keepdim=True)
    return (x - x_mean) * (_per_sample(u, x) + 0.5) + x_mean


def rand_translation(x, shift_h, shift_w):
    """Shift each sample by (shift_h, shift_w) pixels; what enters from the
    border is zero: out[i, j] = x_pad[clip(i + th + 1), clip(j + tw + 1)] of
    the image padded by one zero pixel."""
    b, c, h, w = x.shape
    x_pad = torch.nn.functional.pad(x, (1, 1, 1, 1))
    dev = x.device
    gh = torch.clamp(torch.arange(h, device=dev)[None, :] + shift_h.to(dev)[:, None] + 1, 0, h + 1)
    gw = torch.clamp(torch.arange(w, device=dev)[None, :] + shift_w.to(dev)[:, None] + 1, 0, w + 1)
    rows = torch.gather(x_pad, 2, gh[:, None, :, None].expand(b, c, h, w + 2))
    return torch.gather(rows, 3, gw[:, None, None, :].expand(b, c, h, w))


def rand_cutout(x, cut_h, cut_w):
    """Zero a box of about (h/5, w/5) centred at (cut_h, cut_w), clipped to
    the image."""
    b, c, h, w = x.shape
    _, _, ch, cw = _sizes(h, w)
    if ch == 0 or cw == 0:
        return x
    dev = x.device
    oh, ow = cut_h.to(dev)[:, None], cut_w.to(dev)[:, None]
    lo_h, hi_h = torch.clamp(oh - ch // 2, 0, h - 1), torch.clamp(ch - 1 + oh - ch // 2, 0, h - 1)
    lo_w, hi_w = torch.clamp(ow - cw // 2, 0, w - 1), torch.clamp(cw - 1 + ow - cw // 2, 0, w - 1)
    ih, iw = torch.arange(h, device=dev)[None, :], torch.arange(w, device=dev)[None, :]
    row_in = (ih >= lo_h) & (ih <= hi_h)                 # (b, h)
    col_in = (iw >= lo_w) & (iw <= hi_w)                 # (b, w)
    mask = 1.0 - (row_in[:, :, None] & col_in[:, None, :]).to(x.dtype)
    return x * mask[:, None]


def diff_augment(x: torch.Tensor, draws: DiffAugDraws,
                 policy: str = "color,translation,cutout") -> torch.Tensor:
    """The pipeline in the policy's order."""
    for p in (policy.split(",") if policy else ()):
        p = p.strip()
        if p == "color":
            x = rand_brightness(x, draws.brightness)
            x = rand_saturation(x, draws.saturation)
            x = rand_contrast(x, draws.contrast)
        elif p == "translation":
            x = rand_translation(x, draws.shift_h, draws.shift_w)
        elif p == "cutout":
            x = rand_cutout(x, draws.cut_h, draws.cut_w)
        else:
            raise KeyError(p)
    return x
