"""FID InceptionV3 feature extractor: counterpart of
`cips3d_tpu/eval/inception.py`.

torch-fidelity's InceptionV3 (`weights-inception-2015-12-05`, the network
behind the reference's FID protocol, `exp/cips3d/configs/ffhq_exp.yaml:16-20`,
`exp/cips3d/scripts/eval_fid.py:36-57`) in its FID variant: BasicConv2d =
conv (no bias) + BN (eps 1e-3, inference) + ReLU; Mixed_5b..7c, with
count_include_pad=False average pools in the A, C and E_1 blocks and the max
pool branch in E_2 (Mixed_7c); pool3 = the global mean.  The modules carry
torch-fidelity's state-dict names, so its checkpoint loads with
`load_state_dict` (the ``fc``/``AuxLogits`` heads dropped); a JAX package
tree maps on through `utils/convert.py::inception_state_dict`.  Its convs
are cuDNN's: no Pallas kernel stands behind them in the JAX package.

The checkpoint is not in the repository and cannot be downloaded, so
`find_weights()` returns None unless ``$CIPS3D_INCEPTION_WEIGHTS`` or a
cache path holds it, and FID falls back to the surrogate
(`eval/fid.py::default_extractor`).
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def find_weights() -> Optional[str]:
    """The InceptionV3 checkpoint: ``$CIPS3D_INCEPTION_WEIGHTS``, else the
    first match in torch hub's cache or ``cache_pretrained/``, else None."""
    env = os.environ.get("CIPS3D_INCEPTION_WEIGHTS")
    if env and os.path.exists(env):
        return env
    patterns = [
        os.path.expanduser("~/.cache/torch/hub/checkpoints/weights-inception-2015-12-05*.pth"),
        "cache_pretrained/weights-inception-2015-12-05*.pth",
        os.path.expanduser("~/.cache/torch/hub/checkpoints/pt_inception*.pth"),
    ]
    for p in patterns:
        hits = sorted(glob.glob(p))
        if hits:
            return hits[0]
    return None


class BasicConv2d(nn.Module):
    """conv (no bias) → BN (eps 1e-3, inference) → ReLU."""

    def __init__(self, i: int, o: int, **kw):
        super().__init__()
        self.conv = nn.Conv2d(i, o, bias=False, **kw)
        self.bn = nn.BatchNorm2d(o, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x):
    return F.avg_pool2d(x, kernel_size=3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_ch: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, kernel_size=1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, kernel_size=1)
        self.branch5x5_2 = BasicConv2d(48, 64, kernel_size=5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_ch, kernel_size=1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, bd, self.branch_pool(_avg_pool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, kernel_size=3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, kernel_size=3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 192, kernel_size=1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, kernel_size=1)
        self.branch7x7_2 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, kernel_size=1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, kernel_size=1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, kernel_size=1)
        self.branch3x3_2 = BasicConv2d(192, 320, kernel_size=3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, kernel_size=1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, kernel_size=3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, kernel_size=3, stride=2)], 1)


class InceptionE(nn.Module):
    """``pool`` 'avg' for Mixed_7b (E_1), 'max' for Mixed_7c (E_2): the FID
    variant's quirk."""

    def __init__(self, in_ch: int, pool: str):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(in_ch, 320, kernel_size=1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, kernel_size=1)
        self.branch3x3_2a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, kernel_size=3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, kernel_size=1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = _avg_pool(x) if self.pool == "avg" else F.max_pool2d(x, 3, stride=1, padding=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3(nn.Module):
    """(n, 3, H, W) scaled to [-1, 1] → (n, 2048) pool3 features."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, kernel_size=3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, kernel_size=3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, kernel_size=3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, kernel_size=1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, kernel_size=3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, pool="avg")
        self.Mixed_7c = InceptionE(2048, pool="max")

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, kernel_size=3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, kernel_size=3, stride=2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


def load_inception(path: str) -> InceptionV3:
    """An `InceptionV3` with torch-fidelity's checkpoint (its classifier heads
    dropped), in eval mode."""
    sd = torch.load(path, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    model = InceptionV3()
    model.load_state_dict({k: v for k, v in sd.items()
                           if not k.startswith(("fc.", "AuxLogits."))}, strict=True)
    return model.eval()


def tf1x_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) interpolation matrix of TF1's
    ``tf.image.resize_bilinear(align_corners=False)``, the resize
    torch-fidelity uses: src = dst * in/out (asymmetric, not half-pixel),
    floor + lerp, edge clamp.  One matrix per spatial axis."""
    m = np.zeros((out_size, in_size), np.float32)
    scale = in_size / out_size
    for i in range(out_size):
        src = i * scale
        lo = int(np.floor(src))
        hi = min(lo + 1, in_size - 1)
        frac = src - lo
        m[i, lo] += 1.0 - frac
        m[i, hi] += frac
    return m


def tf1x_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """TF1-style bilinear resize of (n, h, w, c) along the spatial axes."""
    mh = torch.as_tensor(tf1x_resize_matrix(x.shape[1], out_h), device=x.device)
    mw = torch.as_tensor(tf1x_resize_matrix(x.shape[2], out_w), device=x.device)
    return torch.einsum("oh,nhwc,pw->nopc", mh, x, mw)


class InceptionV3Features:
    """Callable (n, H, W, 3) uint8 → (n, 2048) pool3 features (numpy), on
    ``device``.  Preprocessing as torch-fidelity's
    FeatureExtractorInceptionV3: float32 → TF1 bilinear resize to 299 x 299
    → (x - 128) / 128."""

    metric_name = "FID"

    def __init__(self, weights_path: Optional[str] = None,
                 model: Optional[InceptionV3] = None, device="cuda"):
        if model is None:
            if weights_path is None or not os.path.exists(weights_path):
                raise FileNotFoundError(weights_path)
            model = load_inception(weights_path)
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, batch_u8: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(batch_u8), device=self.device).float()
        x = (tf1x_resize(x, 299, 299) - 128.0) / 128.0
        return self.model(x.permute(0, 3, 1, 2)).cpu().numpy()
