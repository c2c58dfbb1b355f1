"""Latent (style) interpolation video.  Counterpart of
`cips3d_tpu/apps/z_interpolation.py` (`render_video_interpolation_web` and
`FrequencyInterpolator`, `exp/cips3d/models/st_web.py:49-64,933-1035`): for
a list of seeds, lerp the style vectors between consecutive seeds while the
camera follows a 'front' (bobbing) or 'orbit' path with a breathing fov,
one frame per t.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence

import numpy as np

from cips3d_tpu_torch.apps.render import Draws, render_frame, seed_styles
from cips3d_tpu_torch.models.generator import GeneratorNerfINR, RenderOptions
from cips3d_tpu_torch.utils import image_io
from cips3d_tpu_torch.utils.video import write_video


def build_camera_path(mode: str, num_frames: int, base_fov: float):
    """(t, pitch, yaw, fov) tuples (`st_web.py:978-995`)."""
    traj = []
    for t in np.linspace(0, 1, num_frames):
        if mode == "front":
            pitch = 0.2 * math.cos(t * 2 * math.pi) + math.pi / 2
            yaw = 0.4 * math.sin(t * 2 * math.pi) + math.pi / 2
            fov = base_fov + 5 + math.sin(t * 2 * math.pi) * 5
        elif mode == "orbit":
            pitch = 0.2 * math.cos(t * 2 * math.pi) + math.pi / 4
            yaw = t * 2 * math.pi
            fov = base_fov
        else:
            raise ValueError(f"unknown camera mode {mode!r} (front|orbit)")
        traj.append((float(t), float(pitch), float(yaw), float(fov)))
    return traj


def style_lerp(styles_a, styles_b, t: float):
    """FrequencyInterpolator.forward analogue (`st_web.py:49-64`)."""
    return {k: styles_a[k] * (1 - t) + styles_b[k] * t for k in styles_a}


def render_z_interpolation_video(model: GeneratorNerfINR, out_dir: str,
                                 seeds: Sequence[int] = (0, 1, 2), num_frames: int = 24,
                                 img_size: int = 64, num_steps: int = 12,
                                 ray_step_multiplier: int = 1, psi: float = 0.7,
                                 camera_mode: str = "front", fov: float = 12.0, fps: int = 24,
                                 lock_view_dependence: bool = False,
                                 draws: Optional[Draws] = None) -> List[str]:
    """The seed-to-seed style interpolation video: PNG frames
    ``frame_{idx:05d}.png`` and their MJPEG-AVI; returns the frame paths."""
    draws = draws or Draws(model.device)
    os.makedirs(out_dir, exist_ok=True)
    traj = build_camera_path(camera_mode, num_frames, fov)
    all_styles = [seed_styles(model, seed, psi, draws) for seed in seeds]
    paths, frames = [], []
    for i in range(len(seeds)):
        s_cur, s_next = all_styles[i], all_styles[(i + 1) % len(seeds)]
        for t, pitch, yaw, frame_fov in traj:
            opts = RenderOptions(img_size=img_size, num_steps=num_steps * ray_step_multiplier,
                                 fov=frame_fov, h_stddev=0.0, v_stddev=0.0, h_mean=yaw,
                                 v_mean=pitch, lock_view_dependence=lock_view_dependence, psi=psi)
            img = render_frame(model, style_lerp(s_cur, s_next, t), opts, len(paths), draws)
            frames.append(image_io.to_uint8(img[0].float().cpu().numpy()))
            paths.append(os.path.join(out_dir, f"frame_{len(paths):05d}.png"))
            image_io.write_png(paths[-1], frames[-1])
    write_video(frames, os.path.join(out_dir, "interp.mp4"), fps)
    return paths
