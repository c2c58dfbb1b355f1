"""Camera and ray math for the NeRF backbone: counterpart of
`cips3d_tpu/core/rays.py`.

Conventions as there: the camera sits on a sphere and looks at the origin;
the pixel grid is NDC in [-1, 1] with y flipped (row 0 at the top); pitch
(phi) is the polar angle from +y and yaw (theta) the azimuth.  Every
function that draws random numbers takes an explicit `torch.Generator` and
also accepts its draws as tensors, so a test can feed it draws made in JAX.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

#: Camera-distribution modes of `sample_camera_positions`.
CAMERA_MODES = ("uniform", "normal", "gaussian", "hybrid", "truncated_gaussian",
                "spherical_uniform", "mean")


def normalize_vecs(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def get_initial_rays_trig(num_steps: int, fov: float, resolution: Tuple[int, int],
                          ray_start: float, ray_end: float, device=None):
    """Camera-space points (HW, S, 3), z-vals (HW, S, 1) and normalized ray
    directions (HW, 3) for a pixel grid."""
    W, H = resolution
    x = torch.linspace(-1.0, 1.0, W, device=device)
    y = torch.linspace(1.0, -1.0, H, device=device)
    xg = x[None, :].expand(H, W).reshape(-1)
    yg = y[:, None].expand(H, W).reshape(-1)
    z = -torch.ones_like(xg) / math.tan((2 * math.pi * fov / 360.0) / 2.0)
    rays_d_cam = normalize_vecs(torch.stack([xg, yg, z], -1))
    z_vals = torch.linspace(ray_start, ray_end, num_steps, device=device)
    z_vals = z_vals[None, :, None].expand(H * W, num_steps, 1)
    return rays_d_cam[:, None, :] * z_vals, z_vals, rays_d_cam


def perturb_points(points, z_vals, ray_directions, uniform: torch.Tensor):
    """Stratified jitter: offset = (uniform - 0.5) * (z_1 - z_0), applied to
    z-vals and points.  ``uniform`` is U[0, 1) shaped like ``z_vals``
    (b, n, S, 1)."""
    spacing = z_vals[:, :, 1:2, :] - z_vals[:, :, 0:1, :]
    offset = (uniform - 0.5) * spacing
    return points + offset * ray_directions[:, :, None, :], z_vals + offset


def truncated_normal(shape, generator: Optional[torch.Generator] = None,
                     device=None) -> torch.Tensor:
    """Standard normal truncated to (-2, 2), by the inverse CDF of a
    uniform draw between the bounds' CDF values."""
    bound = math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(shape, generator=generator, device=device)
    x = math.sqrt(2.0) * torch.erfinv((2.0 * u - 1.0) * bound)
    return torch.clamp(x, -2.0 + 4e-7, 2.0 - 4e-7)


def draw_camera(bs: int, mode: str, generator: Optional[torch.Generator] = None, device=None):
    """The draws `sample_camera_positions` takes for ``mode``, each (bs, 1):
    (theta, phi) standard normals (normal, gaussian), uniforms in [0, 1)
    (uniform, spherical_uniform) or normals truncated to (-2, 2)
    (truncated_gaussian); for hybrid the uniform pair, the normal pair and
    the coin (a bool scalar); () for mean."""
    if mode not in CAMERA_MODES:
        raise ValueError(f"unknown camera mode: {mode!r} (expected one of {CAMERA_MODES})")
    shape = (bs, 1)

    def pair(fn):
        return fn(shape, generator=generator, device=device), \
            fn(shape, generator=generator, device=device)

    if mode in ("normal", "gaussian"):
        return pair(torch.randn)
    if mode in ("uniform", "spherical_uniform"):
        return pair(torch.rand)
    if mode == "truncated_gaussian":
        return pair(truncated_normal)
    if mode == "hybrid":
        coin = torch.rand((), generator=generator, device=device) < 0.5
        return pair(torch.rand) + pair(torch.randn) + (coin,)
    return ()


def sample_camera_positions(bs: int, r: float = 1.0, horizontal_stddev: float = 1.0,
                            vertical_stddev: float = 1.0,
                            horizontal_mean: float = math.pi * 0.5,
                            vertical_mean: float = math.pi * 0.5, mode: str = "normal",
                            generator: Optional[torch.Generator] = None, device=None,
                            draws: Optional[tuple] = None):
    """Camera positions on a sphere: (position (bs, 3), pitch (bs, 1), yaw
    (bs, 1)).  ``draws`` as `draw_camera` makes them for ``mode``; without
    them they are drawn from ``generator``."""
    if draws is None:
        draws = draw_camera(bs, mode, generator, device)
    h_sd, v_sd, h_mean, v_mean = horizontal_stddev, vertical_stddev, horizontal_mean, vertical_mean

    def uniform(ut, up, scale=1.0):
        return ((ut - 0.5) * 2 * h_sd * scale + h_mean, (up - 0.5) * 2 * v_sd * scale + v_mean)

    if mode in ("normal", "gaussian", "truncated_gaussian"):
        theta, phi = draws[0] * h_sd + h_mean, draws[1] * v_sd + v_mean
    elif mode == "uniform":
        theta, phi = uniform(draws[0], draws[1])
    elif mode == "hybrid":
        # one coin for the batch: the doubled uniform or the normal pose
        theta_u, phi_u = uniform(draws[0], draws[1], 2.0)
        coin = torch.as_tensor(draws[4], device=theta_u.device)
        theta = torch.where(coin, theta_u, draws[2] * h_sd + h_mean)
        phi = torch.where(coin, phi_u, draws[3] * v_sd + v_mean)
    elif mode == "spherical_uniform":
        theta = (draws[0] - 0.5) * 2 * h_sd + h_mean
        v = (draws[1] - 0.5) * 2 * (v_sd / math.pi) + v_mean / math.pi
        phi = torch.arccos(1 - 2 * torch.clamp(v, 1e-5, 1 - 1e-5))
    elif mode == "mean":
        theta = torch.full((bs, 1), h_mean, device=device)
        phi = torch.full((bs, 1), v_mean, device=device)
    else:
        raise ValueError(f"unknown camera mode: {mode!r} (expected one of {CAMERA_MODES})")
    phi = torch.clamp(phi, 1e-5, math.pi - 1e-5)
    pos = torch.cat([r * torch.sin(phi) * torch.cos(theta), r * torch.cos(phi),
                     r * torch.sin(phi) * torch.sin(theta)], -1)
    return pos, phi, theta


def create_cam2world_matrix(forward_vector, origin, up_vector=None):
    """Look-at cam2world matrix (b, 4, 4)."""
    forward_vector = normalize_vecs(forward_vector)
    if up_vector is None:
        # filled on the device (no copy from host memory: a captured step makes it too)
        up_vector = torch.zeros_like(forward_vector)
        up_vector.select(-1, 1).fill_(1.0)
    left_vector = normalize_vecs(torch.linalg.cross(up_vector, forward_vector, dim=-1))
    up_vector = normalize_vecs(torch.linalg.cross(forward_vector, left_vector, dim=-1))
    rot = torch.stack([-left_vector, up_vector, -forward_vector], -1)
    b = forward_vector.shape[0]
    cam2world = torch.eye(4, dtype=forward_vector.dtype, device=forward_vector.device)
    cam2world = cam2world[None].repeat(b, 1, 1)
    cam2world[:, :3, :3] = rot
    cam2world[:, :3, 3] = origin
    return cam2world


class WorldRays(NamedTuple):
    points: torch.Tensor          # (b, HW, S, 3) world-space sample points (perturbed)
    dirs_expanded: torch.Tensor   # (b, HW, S, 3) ray dir per sample (or locked)
    origins: torch.Tensor         # (b, HW, 3)
    dirs: torch.Tensor            # (b, HW, 3)
    z_vals: torch.Tensor          # (b, HW, S, 1) perturbed depths
    pitch: torch.Tensor           # (b, 1)
    yaw: torch.Tensor             # (b, 1)


def transform_sampled_points(points, z_vals, ray_directions, h_stddev=1.0, v_stddev=1.0,
                             h_mean=math.pi * 0.5, v_mean=math.pi * 0.5, mode="normal",
                             camera_pos=None, camera_lookup=None, up_vector=None,
                             generator=None, perturb_uniform=None, camera_draws=None):
    """Perturb depths, place the camera (sampled, or ``camera_pos`` looking
    along the view DIRECTION ``camera_lookup``) and map the rays to world
    space.  Returns (points, z_vals, dirs, origins, pitch, yaw)."""
    bs, num_rays, _, _ = points.shape
    dev = points.device
    if perturb_uniform is None:
        perturb_uniform = torch.rand(z_vals.shape, generator=generator, device=dev)
    points, z_vals = perturb_points(points, z_vals, ray_directions, perturb_uniform)
    if camera_pos is None or camera_lookup is None:
        camera_origin, pitch, yaw = sample_camera_positions(
            bs, 1.0, h_stddev, v_stddev, h_mean, v_mean, mode,
            generator=generator, device=dev, draws=camera_draws)
        forward_vector = normalize_vecs(-camera_origin)
    else:
        camera_origin = camera_pos
        pitch = yaw = torch.zeros((bs, 1), device=dev)
        forward_vector = normalize_vecs(camera_lookup)
    cam2world = create_cam2world_matrix(forward_vector, camera_origin, up_vector)
    rot, trans = cam2world[:, :3, :3], cam2world[:, :3, 3]
    world_points = torch.einsum("bij,bnsj->bnsi", rot, points) + trans[:, None, None, :]
    world_dirs = torch.einsum("bij,bnj->bni", rot, ray_directions)
    origins = trans[:, None, :].expand(bs, num_rays, 3)
    return world_points, z_vals, world_dirs, origins, pitch, yaw


def get_world_points_and_direction(batch_size: int, num_steps: int, img_size: int,
                                   fov: float, ray_start: float, ray_end: float,
                                   h_stddev: float, v_stddev: float, h_mean: float,
                                   v_mean: float, sample_dist: str,
                                   lock_view_dependence: bool = False,
                                   camera_pos=None, camera_lookup=None, up_vector=None,
                                   generator: Optional[torch.Generator] = None,
                                   device=None, perturb_uniform=None,
                                   camera_draws=None) -> WorldRays:
    """World-space sample points and camera rays for a full image."""
    points_cam, z_vals, rays_d_cam = get_initial_rays_trig(
        num_steps, fov, (img_size, img_size), ray_start, ray_end, device=device)
    points_cam = points_cam[None].expand(batch_size, *points_cam.shape)
    z_vals = z_vals[None].expand(batch_size, *z_vals.shape)
    rays_d_cam = rays_d_cam[None].expand(batch_size, *rays_d_cam.shape)
    points, z_vals, dirs, origins, pitch, yaw = transform_sampled_points(
        points_cam, z_vals, rays_d_cam, h_stddev, v_stddev, h_mean, v_mean, sample_dist,
        camera_pos, camera_lookup, up_vector, generator, perturb_uniform, camera_draws)
    dirs_expanded = dirs[:, :, None, :].expand(batch_size, dirs.shape[1], num_steps, 3)
    if lock_view_dependence:
        dirs_expanded = torch.zeros_like(dirs_expanded)
        dirs_expanded[..., -1] = -1.0
    return WorldRays(points, dirs_expanded, origins, dirs, z_vals, pitch, yaw)
