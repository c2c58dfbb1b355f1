"""Training schedules: counterpart of `cips3d_tpu/train/schedules.py`."""

from __future__ import annotations


def nerf_noise_schedule(step: int, disable: bool = False) -> float:
    """max(0, 1 - step / 5000): the NeRF density noise."""
    if disable:
        return 0.0
    return max(0.0, 1.0 - step / 5000.0)


def alpha_schedule(step: int, warmup_d: bool, fade_steps: int = 10000) -> float:
    """min(1, step / fade_steps) under warmup_d, else 1: the D fade-in."""
    if not warmup_d:
        return 1.0
    return min(1.0, step / float(fade_steps))
