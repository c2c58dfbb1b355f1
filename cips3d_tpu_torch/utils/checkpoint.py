"""Snapshots in the JAX package's layout, with numpy only: counterpart of
`cips3d_tpu/utils/checkpoint.py`.

A snapshot directory holds one ``<module>.npz`` per module, whose keys are
the JAX key paths (``['params']['siren']['film_0']['linear']['kernel']``,
``[0].mu['params']...`` for an optax state), plus ``state.json``,
``info.txt`` and optionally ``config_command.yaml``.  `CheckpointManager`
keeps the trees ``best_fid/``, numbered backups ``ckpt_{n:08d}/`` (the
newest ``max_to_keep``) and ``resume/``.  A snapshot the port writes loads
through the JAX package's ``CheckpointManager.load_snapshot``, and the
JAX package's snapshots load here (`utils/convert.py` maps the trees).
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

_KEY_RE = re.compile(r"\['([^']+)'\]|\.([A-Za-z_][A-Za-z0-9_]*)|\[(\d+)\]")


def _parse_keystr(s: str) -> List[str]:
    return [m.group(1) or m.group(2) or m.group(3) for m in _KEY_RE.finditer(s)]


def _keystr(keys: List[str]) -> str:
    """A key path as JAX's ``keystr`` prints it: dict keys in ``['...']``,
    tuple indices ``[i]``, and the fields of optax's state (``count``,
    ``mu``, ``nu`` under an index) as attributes."""
    out, prev_index = [], False
    for k in keys:
        if k.isdigit():
            out.append(f"[{k}]")
            prev_index = True
        elif prev_index and k in ("count", "mu", "nu"):
            out.append(f".{k}")
            prev_index = False
        else:
            out.append(f"['{k}']")
            prev_index = False
    return "".join(out)


def flatten(tree: Mapping, prefix: Optional[List[str]] = None) -> Dict[str, np.ndarray]:
    """Nested dicts of arrays -> {key path: array}."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        keys = (prefix or []) + [str(k)]
        if isinstance(v, Mapping):
            out.update(flatten(v, keys))
        else:
            out[_keystr(keys)] = np.asarray(v)
    return out


def save_pytree(path: str, tree: Mapping) -> None:
    """Write nested dicts of arrays as one .npz of key paths."""
    np.savez(path, **flatten(tree))


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


def load_pytree_like(path: str, reference: Mapping) -> Dict[str, Any]:
    """Read an .npz and graft its values onto the structure of
    ``reference``: nested dicts whose leaves have a shape and a dtype
    (numpy arrays, torch tensors), where a dotted key (a state dict's
    ``siren.network.0.weight``) is a path of nested keys.  Each value comes
    back as a numpy array in its leaf's dtype (float32 for bfloat16, which
    numpy lacks).  A key the file lacks raises `KeyError`
    naming it; a shape that differs raises `ValueError`."""
    loaded = load_pytree(path)

    def pick(keys):
        cur = loaded
        for i, k in enumerate(keys):
            if not isinstance(cur, Mapping) or k not in cur:
                raise KeyError(f"{path} has no {_keystr(keys[:i + 1])} (the reference's "
                               f"{'.'.join(keys)})")
            cur = cur[k]
        return cur

    def graft(ref, keys):
        out = {}
        for k, v in ref.items():
            sub = keys + str(k).split(".")
            if isinstance(v, Mapping):
                out[k] = graft(v, sub)
                continue
            val = np.asarray(pick(sub))
            if val.shape != tuple(v.shape):
                raise ValueError(f"shape mismatch at {'.'.join(sub)}: ckpt {val.shape} vs "
                                 f"model {tuple(v.shape)}")
            name = str(v.dtype).replace("torch.", "")
            out[k] = val.astype(np.float32 if name == "bfloat16" else np.dtype(name))
        return out

    return graft(reference, [])


def load_snapshot_module(snapshot_dir: str, module: str = "G_ema") -> Any:
    """One module's tree from a snapshot directory (``<dir>/<module>.npz``)."""
    return load_pytree(os.path.join(snapshot_dir, f"{module}.npz"))


class CheckpointManager:
    """best/backup/resume snapshot trees, numbered backups kept to the
    newest ``max_to_keep``."""

    def __init__(self, ckpt_dir: str, max_to_keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.max_to_keep = max_to_keep
        os.makedirs(ckpt_dir, exist_ok=True)

    def save_snapshot(self, name: str, modules: Dict[str, Mapping],
                      state: Optional[Dict[str, Any]] = None, info_msg: str = "",
                      config_text: Optional[str] = None) -> str:
        """Write one snapshot directory (atomically: a temporary directory
        renamed into place)."""
        path = os.path.join(self.ckpt_dir, name)
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for mod_name, tree in modules.items():
            save_pytree(os.path.join(tmp, f"{mod_name}.npz"), tree)
        if state is not None:
            with open(os.path.join(tmp, "state.json"), "w") as f:
                json.dump(state, f, indent=2)
        if info_msg:
            with open(os.path.join(tmp, "info.txt"), "w") as f:
                f.write(info_msg)
        if config_text:
            with open(os.path.join(tmp, "config_command.yaml"), "w") as f:
                f.write(config_text)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
        return path

    def save_backup(self, modules, state=None, info_msg="", config_text=None) -> str:
        """A numbered backup; the oldest beyond ``max_to_keep`` are removed."""
        existing = sorted(int(d.split("_")[1]) for d in os.listdir(self.ckpt_dir)
                          if d.startswith("ckpt_") and d.split("_")[1].isdigit())
        nxt = (existing[-1] + 1) if existing else 0
        path = self.save_snapshot(f"ckpt_{nxt:08d}", modules, state, info_msg, config_text)
        for old in existing[: max(0, len(existing) + 1 - self.max_to_keep)]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"ckpt_{old:08d}"), ignore_errors=True)
        return path

    def load_snapshot(self, name: str, modules) -> Dict[str, Any]:
        """{module: nested dict of arrays} of the named modules."""
        path = os.path.join(self.ckpt_dir, name)
        return {m: load_pytree(os.path.join(path, f"{m}.npz")) for m in modules}

    def load_state(self, name: str) -> Dict[str, Any]:
        with open(os.path.join(self.ckpt_dir, name, "state.json")) as f:
            return json.load(f)

    def has_snapshot(self, name: str) -> bool:
        return os.path.isdir(os.path.join(self.ckpt_dir, name))
