"""Learnable camera of the diffcam pipeline: counterpart of
`cips3d_tpu/models/camera.py`.

Pinhole intrinsics fx, fy (in pixels) stored softplus-inverse so that Adam
keeps them positive, and optional per-camera extrinsics (axis-angle rotation
and translation), producing world-space rays ``rays_o``/``rays_d`` (b, H, W,
3) for `GeneratorDiffcam`.  A third Adam trains them beside G and D.  The
initial values are deterministic (no random init); the random poses of
`get_rays_random_pose` take their draws as tensors or from a
`torch.Generator`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from cips3d_tpu_torch.core import rays as rays_lib


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as `jax.nn.softplus` computes it (logaddexp(x, 0))."""
    return torch.logaddexp(x, torch.zeros_like(x))


def axis_angle_to_matrix(aa: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Rodrigues: (b, 3) axis-angle → (b, 3, 3) rotation; the identity where
    the angle is below ``eps``."""
    theta = torch.linalg.norm(aa, dim=-1, keepdim=True)
    k = aa / torch.clamp(theta, min=eps)
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    zero = torch.zeros_like(kx)
    K = torch.stack([torch.stack([zero, -kz, ky], -1),
                     torch.stack([kz, zero, -kx], -1),
                     torch.stack([-ky, kx, zero], -1)], -2)
    th = theta[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    R = eye + torch.sin(th) * K + (1 - torch.cos(th)) * (K @ K)
    return torch.where(th > eps, R, eye.expand(R.shape))


def pinhole_rays(rot: torch.Tensor, trans: torch.Tensor, focal_x, focal_y, H: int, W: int,
                 cx=None, cy=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """World-space rays of a pinhole camera looking along -z: rot (b, 3, 3)
    cam2world, trans (b, 3) origin, focal lengths in pixels (scalar or
    (b,)).  Returns rays_o, rays_d (b, H, W, 3), dirs normalized."""
    b = rot.shape[0]
    cx = (W - 1) / 2.0 if cx is None else cx
    cy = (H - 1) / 2.0 if cy is None else cy
    i = torch.arange(W, dtype=rot.dtype, device=rot.device)
    j = torch.arange(H, dtype=rot.dtype, device=rot.device)
    ii, jj = i[None, :].expand(H, W), j[:, None].expand(H, W)
    fx = torch.as_tensor(focal_x, dtype=rot.dtype, device=rot.device).reshape(-1, 1, 1)
    fy = torch.as_tensor(focal_y, dtype=rot.dtype, device=rot.device).reshape(-1, 1, 1)
    dx = ((ii[None] - cx) / fx).expand(b, H, W)
    dy = (-(jj[None] - cy) / fy).expand(b, H, W)
    dirs = torch.stack([dx, dy, -torch.ones((b, H, W), dtype=rot.dtype, device=rot.device)], -1)
    rays_d = torch.einsum("bij,bhwj->bhwi", rot, dirs)
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    return trans[:, None, None, :].expand(rays_d.shape), rays_d


class CamParams(nn.Module):
    """Learnable intrinsics (``fx_raw``, ``fy_raw``; buffers outside the
    state dict when ``learn_intrinsics`` is false) and, with ``num_cams >
    0``, learnable per-camera extrinsics ``so3``, ``trans``.  ``fov0``
    seeds fx = fy = 0.5 W0 / tan(fov0 / 2)."""

    def __init__(self, H0: int = 64, W0: int = 64, fov0: float = 12.0, num_cams: int = 0,
                 learn_intrinsics: bool = True):
        super().__init__()
        self.H0, self.W0, self.fov0 = H0, W0, fov0
        self.num_cams, self.learn_intrinsics = num_cams, learn_intrinsics
        focal0 = 0.5 * W0 / math.tan(0.5 * math.radians(fov0))
        raw0 = math.log(math.exp(focal0) - 1.0) if focal0 < 30 else focal0
        for name in ("fx_raw", "fy_raw"):
            value = torch.full((1,), raw0)
            if learn_intrinsics:
                setattr(self, name, nn.Parameter(value))
            else:
                self.register_buffer(name, value, persistent=False)
        if num_cams > 0:
            self.so3 = nn.Parameter(torch.zeros((num_cams, 3)))
            self.trans = nn.Parameter(torch.tensor([[0.0, 0.0, 1.0]]).repeat(num_cams, 1))

    def intrinsics(self, H: Optional[int] = None, W: Optional[int] = None):
        """(fx, fy) scaled to the render resolution."""
        H, W = H or self.H0, W or self.W0
        return softplus(self.fx_raw) * (W / self.W0), softplus(self.fy_raw) * (H / self.H0)

    def forward(self, cam_idx: torch.Tensor, H: int, W: int):
        """Rays of the learnable cameras ``cam_idx`` (b,) → (rays_o, rays_d)."""
        fx, fy = self.intrinsics(H, W)
        return pinhole_rays(axis_angle_to_matrix(self.so3[cam_idx]), self.trans[cam_idx],
                            fx, fy, H, W)

    def get_rays_random_pose(self, bs: int, H: int, W: int, r: float = 1.0,
                             h_stddev: float = 0.3, v_stddev: float = 0.155,
                             h_mean: float = math.pi * 0.5, v_mean: float = math.pi * 0.5,
                             mode: str = "gaussian", generator: Optional[torch.Generator] = None,
                             draws: Optional[tuple] = None):
        """A random pose on the sphere (``draws`` as `rays.draw_camera` makes
        them for ``mode``, else drawn from ``generator``) with the learnable
        intrinsics: (rays_o, rays_d (bs, H, W, 3), pitch_yaw (bs, 2))."""
        origin, pitch, yaw = rays_lib.sample_camera_positions(
            bs, r, h_stddev, v_stddev, h_mean, v_mean, mode, generator=generator,
            device=self.fx_raw.device, draws=draws)
        c2w = rays_lib.create_cam2world_matrix(rays_lib.normalize_vecs(-origin), origin)
        fx, fy = self.intrinsics(H, W)
        rays_o, rays_d = pinhole_rays(c2w[:, :3, :3], origin, fx, fy, H, W)
        return rays_o, rays_d, torch.cat([pitch, yaw], -1)
