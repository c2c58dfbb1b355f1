"""Read the JAX package's snapshots with numpy only.

Counterpart of `cips3d_tpu/utils/checkpoint.py::load_pytree`: a snapshot
directory holds one ``<module>.npz`` per module, whose keys are flattened
key paths (``['params']['siren']['film_0']['linear']['kernel']``); the
same regex rebuilds the nested dict, so a snapshot written by the JAX
package loads in the port.
"""

from __future__ import annotations

import os
import re
from typing import Any, List

import numpy as np

_KEY_RE = re.compile(r"\['([^']+)'\]|\.([A-Za-z_][A-Za-z0-9_]*)|\[(\d+)\]")


def _parse_keystr(s: str) -> List[str]:
    return [m.group(1) or m.group(2) or m.group(3) for m in _KEY_RE.finditer(s)]


def load_pytree(path: str) -> Any:
    """Read an .npz back into nested dicts of numpy arrays."""
    nested: dict = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            keys = _parse_keystr(key)
            cur = nested
            for k in keys[:-1]:
                cur = cur.setdefault(k, {})
            cur[keys[-1]] = data[key]
    return nested


def load_snapshot_module(snapshot_dir: str, module: str = "G_ema") -> Any:
    """One module's tree from a snapshot directory (``<dir>/<module>.npz``)."""
    return load_pytree(os.path.join(snapshot_dir, f"{module}.npz"))
