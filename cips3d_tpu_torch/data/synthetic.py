"""Procedural multi-view dataset for GAN-training validation: counterpart
of `cips3d_tpu/data/synthetic.py` (numpy only; PNGs through
`utils/image_io.py`).

The build environment has no FFHQ on disk, but adversarial-training dynamics
bugs (divergence, mode collapse, R1/EMA/alpha mistiming) only surface over
thousands of steps on *structured* data.  This module renders a population of
simple 3D scenes — a shaded sphere "head" with two dark face spots, random
size/albedo, over a gradient background — from the same camera distribution
the generator samples during training (pose on the unit sphere, yaw ~
N(pi/2, 0.3), pitch ~ N(pi/2, 0.155), fov 12, object inside the 0.24
UniformBoxWarp scene box; conventions mirror `core/rays.py`).  Appearance is
pose-correlated (lambertian shading + face spots only visible from the
front), so a 3D-aware generator can actually fit it and the mirror-symmetry
monitor is meaningful.

Usage:
    python -m cips3d_tpu_torch.data.synthetic blobs.zip --num 2000 --size 64 --seed 0
"""

from __future__ import annotations

import argparse
import math

import numpy as np


def _camera_rays(yaw: float, pitch: float, img_size: int, fov: float = 12.0,
                 radius: float = 1.0):
    """Ray origins/directions for one camera, matching core/rays.py math."""
    x = np.linspace(-1.0, 1.0, img_size, dtype=np.float64)
    y = np.linspace(1.0, -1.0, img_size, dtype=np.float64)
    xg, yg = np.meshgrid(x, y)  # (H, W)
    z = -np.ones_like(xg) / math.tan(math.radians(fov) / 2.0)
    dirs = np.stack([xg, yg, z], axis=-1).reshape(-1, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)

    pos = radius * np.array(
        [math.sin(pitch) * math.cos(yaw), math.cos(pitch), math.sin(pitch) * math.sin(yaw)]
    )
    fwd = -pos / np.linalg.norm(pos)
    up = np.array([0.0, 1.0, 0.0])
    left = np.cross(up, fwd)
    left /= np.linalg.norm(left)
    up2 = np.cross(fwd, left)
    rot = np.stack([-left, up2, -fwd], axis=-1)  # columns
    dirs_world = dirs @ rot.T
    return pos, dirs_world


def _hsv_to_rgb(h, s, v):
    i = int(h * 6) % 6
    f = h * 6 - int(h * 6)
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    return [
        (v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q),
    ][i]


def sample_scene(rng: np.random.Generator) -> dict:
    """Random scene parameters (one identity)."""
    base_h = rng.uniform(0, 1)
    spot_yaw = math.radians(22.0)
    spot_pitch = math.radians(12.0)

    def unit(yaw_off, pitch_off):
        # object-space directions near +z (the direction facing the mean camera)
        cy, sy = math.cos(yaw_off), math.sin(yaw_off)
        cp, sp = math.cos(pitch_off), math.sin(pitch_off)
        return np.array([sy * cp, sp, cy * cp])

    return dict(
        center=rng.uniform(-0.015, 0.015, 3),
        radius=rng.uniform(0.065, 0.095),
        albedo=np.array(_hsv_to_rgb(base_h, rng.uniform(0.35, 0.75), rng.uniform(0.7, 1.0))),
        spot_dirs=np.stack([unit(-spot_yaw, spot_pitch), unit(spot_yaw, spot_pitch)]),
        spot_color=np.array(_hsv_to_rgb((base_h + 0.5) % 1.0, 0.6, 0.15)),
        spot_width=rng.uniform(0.18, 0.25),
        bg_top=np.array(_hsv_to_rgb(rng.uniform(0, 1), rng.uniform(0.1, 0.3), rng.uniform(0.25, 0.55))),
        bg_bot=np.array(_hsv_to_rgb(rng.uniform(0, 1), rng.uniform(0.1, 0.3), rng.uniform(0.25, 0.55))),
    )


def render_scene(scene: dict, yaw: float, pitch: float, img_size: int,
                 supersample: int = 2) -> np.ndarray:
    """Ray-trace one view -> (img_size, img_size, 3) uint8."""
    s = supersample
    n = img_size * s
    origin, dirs = _camera_rays(yaw, pitch, n)

    c, r = scene["center"], scene["radius"]
    oc = origin - c
    b = dirs @ oc
    disc = b * b - (oc @ oc - r * r)
    hit = disc > 0
    t = -b - np.sqrt(np.where(hit, disc, 0.0))
    hit &= t > 0

    p = origin[None, :] + t[:, None] * dirs
    normal = (p - c[None, :]) / r

    light = np.array([0.45, 0.7, 0.55])
    light /= np.linalg.norm(light)
    lambert = np.clip(normal @ light, 0.0, 1.0) * 0.75 + 0.25

    color = np.broadcast_to(scene["albedo"], normal.shape).copy()
    for sd in scene["spot_dirs"]:
        ang = np.arccos(np.clip(normal @ sd, -1.0, 1.0))
        w = np.exp(-((ang / scene["spot_width"]) ** 2))
        color = color * (1 - w[:, None]) + scene["spot_color"][None, :] * w[:, None]
    shaded = color * lambert[:, None]

    yy = np.linspace(1.0, 0.0, n)
    bg = scene["bg_top"][None, :] * yy[:, None] + scene["bg_bot"][None, :] * (1 - yy[:, None])
    bg = np.repeat(bg[:, None, :], n, axis=1).reshape(-1, 3)

    img = np.where(hit[:, None], shaded, bg).reshape(n, n, 3)
    if s > 1:
        img = img.reshape(img_size, s, img_size, s, 3).mean(axis=(1, 3))
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def make_blob_dataset(
    path: str,
    num_images: int,
    img_size: int = 64,
    seed: int = 0,
    h_stddev: float = 0.3,
    v_stddev: float = 0.155,
) -> str:
    """Render ``num_images`` independent (identity, pose) draws into a
    StyleGAN-format zip readable by `ZipImageDataset`."""
    from cips3d_tpu_torch.data.zip_dataset import write_stylegan_zip

    rng = np.random.default_rng(seed)

    def gen():
        for _ in range(num_images):
            scene = sample_scene(rng)
            yaw = math.pi / 2 + rng.normal() * h_stddev
            pitch = np.clip(math.pi / 2 + rng.normal() * v_stddev, 1e-5, math.pi - 1e-5)
            yield render_scene(scene, yaw, pitch, img_size)

    write_stylegan_zip(path, gen())
    return path


def make_blob_pyramid(
    path_template: str,
    num_images: int,
    sizes: tuple = (32, 64, 128, 256),
    seed: int = 0,
    h_stddev: float = 0.3,
    v_stddev: float = 0.155,
) -> list:
    """Render each (identity, pose) draw ONCE at ``max(sizes)`` and write one
    StyleGAN zip per size via box downsampling — the progressive-training
    counterpart of the reference's per-resolution `downsample_ffhq_*.zip`
    files (`README.md:150-160`).  ``path_template`` must contain ``{size}``.
    All zips share identities/poses, so per-stage FID trends are comparable.
    """
    import contextlib
    import zipfile

    from cips3d_tpu_torch.utils.image_io import encode_png

    sizes = sorted(sizes)
    top = sizes[-1]
    rng = np.random.default_rng(seed)

    def downs(img, size):
        f = top // size
        if f == 1:
            return img
        return (
            img.reshape(size, f, size, f, 3).astype(np.float32).mean(axis=(1, 3))
        ).round().astype(np.uint8)

    paths = [path_template.format(size=s) for s in sizes]
    with contextlib.ExitStack() as stack:
        writers = {
            s: stack.enter_context(zipfile.ZipFile(p, "w", zipfile.ZIP_STORED))
            for s, p in zip(sizes, paths)
        }
        for i in range(num_images):
            scene = sample_scene(rng)
            yaw = math.pi / 2 + rng.normal() * h_stddev
            pitch = np.clip(math.pi / 2 + rng.normal() * v_stddev, 1e-5, math.pi - 1e-5)
            img = render_scene(scene, yaw, pitch, top)
            for s in sizes:
                writers[s].writestr(f"img{i:08d}.png", encode_png(downs(img, s)))
            if (i + 1) % 500 == 0:
                print(f"  rendered {i + 1}/{num_images}")
    return paths


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out", help="output zip path (use {size} with --sizes)")
    p.add_argument("--num", type=int, default=2000)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--sizes", default=None,
                   help="comma list, e.g. 32,64,128,256: render once at the "
                        "max size, write one zip per size ({size} template)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.sizes:
        sizes = tuple(int(s) for s in args.sizes.split(","))
        paths = make_blob_pyramid(args.out, args.num, sizes, args.seed)
        print(f"wrote {args.num} images to {', '.join(paths)}")
    else:
        make_blob_dataset(args.out, args.num, args.size, args.seed)
        print(f"wrote {args.num} images to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
