"""Plain-text metric logger: counterpart of `cips3d_tpu/utils/textlogger.py`.

Every scalar gets one append-only file ``textdir/<prefix>.<group>.<name>.log``
of ``step: value`` lines, in the JAX package's format, so either package's
`read_log` reads the other's logs.  `plot_logs` draws the curves with numpy
(the card's machine has no matplotlib) and writes a PNG without text.
"""

from __future__ import annotations

import collections
import os
from typing import Dict, Mapping, Tuple

import numpy as np


class TextLogger:
    def __init__(self, textdir: str):
        self.textdir = textdir
        os.makedirs(textdir, exist_ok=True)
        self._files = {}

    def _file(self, name: str):
        if name not in self._files:
            self._files[name] = open(os.path.join(self.textdir, f"{name}.log"), "a", buffering=1)
        return self._files[name]

    def log_scalar(self, name: str, step: int, value: float):
        self._file(name).write(f"{step}: {float(value):.6g}\n")

    def log_dict(self, summary: Mapping[str, Mapping[str, float]], prefix: str, step: int):
        """Nested {group: {name: value}} -> one file per metric."""
        for group, metrics in summary.items():
            for name, value in metrics.items():
                self.log_scalar(f"{prefix}.{group}.{name}", step, value)

    def close(self):
        for f in self._files.values():
            f.close()
        self._files.clear()


def read_log(path: str) -> Tuple[list, list]:
    """A log file -> (steps, values)."""
    steps, values = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            s, v = line.split(":")
            steps.append(int(s))
            values.append(float(v))
    return steps, values


# matplotlib's tab10 cycle
_COLOURS = np.array([(31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
                     (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
                     (188, 189, 34), (23, 190, 207)], np.uint8)


def _draw_line(canvas: np.ndarray, x: np.ndarray, y: np.ndarray, colour) -> None:
    """Join the points (x, y) in pixel coordinates, two pixels thick."""
    if len(x) == 1:
        x, y = np.repeat(x, 2), np.repeat(y, 2)
    for x0, y0, x1, y1 in zip(x[:-1], y[:-1], x[1:], y[1:]):
        n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
        xs = np.rint(np.linspace(x0, x1, n)).astype(int)
        ys = np.rint(np.linspace(y0, y1, n)).astype(int)
        for dy in (0, 1):
            canvas[np.clip(ys + dy, 0, canvas.shape[0] - 1), xs] = colour


def plot_logs(textdir: str, out_png: str, pattern: str = "", width: int = 960,
              height: int = 600) -> int:
    """Plot every (matching) metric file into one PNG: one colour per
    curve (matplotlib's cycle, in file order), steps on x, values on y, a
    shared axes box on white; no text.  Returns the number of files, 0 (and
    no PNG) when none match."""
    from cips3d_tpu_torch.utils.image_io import write_png

    files = sorted(f for f in os.listdir(textdir) if f.endswith(".log") and pattern in f)
    if not files:
        return 0
    curves = [read_log(os.path.join(textdir, f)) for f in files]
    steps = np.concatenate([np.asarray(s, np.float64) for s, _ in curves] + [np.zeros(0)])
    values = np.concatenate([np.asarray(v, np.float64) for _, v in curves] + [np.zeros(0)])
    canvas = np.full((height, width, 3), 255, np.uint8)
    left, top, right, bottom = 40, 20, width - 20, height - 40
    canvas[top:bottom + 1, [left, right]] = 0
    canvas[[top, bottom], left:right + 1] = 0
    finite = np.isfinite(values)
    if finite.any():
        x_lo, x_hi = steps.min(), steps.max()
        y_lo, y_hi = values[finite].min(), values[finite].max()
        x_span, y_span = (x_hi - x_lo) or 1.0, (y_hi - y_lo) or 1.0
        for i, (s, v) in enumerate(curves):
            s, v = np.asarray(s, np.float64), np.asarray(v, np.float64)
            keep = np.isfinite(v)
            if keep.any():
                px = left + 2 + (s[keep] - x_lo) / x_span * (right - left - 4)
                py = bottom - 2 - (v[keep] - y_lo) / y_span * (bottom - top - 4)
                _draw_line(canvas, px, py, _COLOURS[i % len(_COLOURS)])
    write_png(out_png, canvas)
    return len(files)


def summary_defaultdict() -> Dict[str, Dict[str, float]]:
    return collections.defaultdict(dict)
