"""Plain-text metric logger: counterpart of `cips3d_tpu/utils/textlogger.py`.

Every scalar gets one append-only file ``textdir/<prefix>.<group>.<name>.log``
of ``step: value`` lines, in the JAX package's format, so either package's
`read_log` reads the other's logs.  Plotting (`plot_logs`, which needs
matplotlib) is not ported.
"""

from __future__ import annotations

import collections
import os
from typing import Dict, Mapping, Tuple


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


def summary_defaultdict() -> Dict[str, Dict[str, float]]:
    return collections.defaultdict(dict)
