"""Camera trajectory builders for demo and video rendering: a copy of
`cips3d_tpu/core/trajectories.py` (numpy only, the same arithmetic in the
same order, so both packages build the same paths bit for bit).

NumPy counterparts of `exp/comm/comm_utils.py:82-237`; the positions, view
directions and up vectors feed the explicit-camera render
(`apps/render.py::render_chunked`).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def get_yaw_pitch_by_xyz(x: float, y: float, z: float) -> Tuple[float, float]:
    """(`comm_utils.py:82-85`)"""
    yaw = math.atan2(z, x)
    pitch = math.atan2(math.sqrt(x * x + z * z), y)
    return yaw, pitch


def _yaws_pitchs(xyz: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    yaws = np.zeros(len(xyz))
    pitchs = np.zeros(len(xyz))
    for i, (x, y, z) in enumerate(xyz):
        yaws[i], pitchs[i] = get_yaw_pitch_by_xyz(x, y, z)
    return yaws, pitchs


def get_circle_camera_pos_and_lookup(r=1.0, alpha=math.pi / 6, num_samples=36, periods=2):
    """Camera circles the z-axis while looking at the origin
    (`comm_utils.py:87-110`)."""
    n = num_samples * periods
    xyz = np.zeros((n, 3), dtype=np.float32)
    xyz[:, 2] = r * math.cos(alpha)
    z_sin = r * math.sin(alpha)
    for idx, t in enumerate(np.linspace(1, 0, n)):
        beta = t * 2 * math.pi * periods
        xyz[idx, 0] = z_sin * math.cos(beta)
        xyz[idx, 1] = z_sin * math.sin(beta)
    lookup = -xyz
    yaws, pitchs = _yaws_pitchs(xyz)
    return xyz, lookup, yaws, pitchs


def _get_translate_distance(num_samples, translate_dist):
    """Triangle-wave lateral offsets (`comm_utils.py:112-121`)."""
    q = num_samples // 4
    return np.concatenate(
        [
            np.linspace(0, translate_dist, q),
            np.linspace(translate_dist, 0, q),
            np.linspace(0, -translate_dist, q),
            np.linspace(-translate_dist, 0, q),
        ],
        axis=0,
    )


def get_translate_circle_camera_pos_and_lookup(
    r=1.0, num_samples_translate=36, translate_dist=0.5, alpha=math.pi / 6, num_samples=36, periods=2
):
    """Translate along X, then Y, then circle (`comm_utils.py:123-166`)."""
    trans = _get_translate_distance(num_samples_translate, translate_dist)
    nt = len(trans)

    tx = np.zeros((nt, 3), dtype=np.float32)
    tx_lookup = np.zeros((nt, 3), dtype=np.float32)
    tx_lookup[:, 2] = -1
    tx[:, 0] = trans
    tx[:, 2] = r * math.cos(alpha)

    ty = np.zeros((nt, 3), dtype=np.float32)
    ty[:, 1] = tx[:, 0]
    ty[:, 2] = tx[:, 2]

    circle_xyz, circle_lookup, _, _ = get_circle_camera_pos_and_lookup(
        r=r, alpha=alpha, num_samples=num_samples, periods=periods
    )

    xyz = np.concatenate([tx, ty, circle_xyz], axis=0)
    lookup = np.concatenate([tx_lookup, tx_lookup, circle_lookup], axis=0)
    yaws, pitchs = _yaws_pitchs(xyz)
    return xyz, lookup, yaws, pitchs, nt


def get_translate_rotate(
    r=1.0, num_samples_translate=36, translate_dist=0.5, alpha=math.pi / 6, num_samples=36, periods=1
):
    """Translate X/Y then roll the camera's up-vector (`comm_utils.py:169-215`).

    Returns (xyz, lookup, up, yaws, pitchs, num_samples_translate).
    """
    trans = _get_translate_distance(num_samples_translate, translate_dist)
    nt = len(trans)

    tx = np.zeros((nt, 3), dtype=np.float32)
    tx[:, 0] = trans
    tx[:, 2] = r * math.cos(alpha)
    tx_lookup = np.zeros((nt, 3), dtype=np.float32)
    tx_lookup[:, 2] = -1
    tx_up = np.zeros((nt, 3), dtype=np.float32)
    tx_up[:, 1] = 1

    ty = np.zeros((nt, 3), dtype=np.float32)
    ty[:, 1] = tx[:, 0]
    ty[:, 2] = tx[:, 2]

    n = num_samples * periods
    rot_xyz = np.zeros((n, 3), dtype=np.float32)
    rot_xyz[:, 2] = r * math.cos(alpha)
    rot_lookup = -rot_xyz
    rot_up = np.zeros((n, 3), dtype=np.float32)
    for idx, beta in enumerate(np.linspace(0, 2 * math.pi * periods, n)):
        rot_up[idx, 0] = -math.sin(beta)
        rot_up[idx, 1] = math.cos(beta)

    xyz = np.concatenate([tx, ty, rot_xyz], axis=0)
    lookup = np.concatenate([tx_lookup, tx_lookup, rot_lookup], axis=0)
    up = np.concatenate([tx_up, tx_up, rot_up], axis=0)
    yaws, pitchs = _yaws_pitchs(xyz)
    return xyz, lookup, up, yaws, pitchs, nt


def get_yaw_camera_pos_and_lookup(r=1.0, num_samples=36):
    """Equatorial yaw sweep theta ∈ [1, pi-1] (`comm_utils.py:218-237`)."""
    xyz = np.zeros((num_samples, 3), dtype=np.float32)
    for idx, theta in enumerate(np.linspace(1, math.pi - 1, num_samples)):
        xyz[idx, 0] = r * math.cos(theta)
        xyz[idx, 2] = r * math.sin(theta)
    lookup = -xyz
    yaws, pitchs = _yaws_pitchs(xyz)
    return xyz, lookup, yaws, pitchs
