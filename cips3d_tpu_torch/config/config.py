"""Layered YAML configs and the component registry: counterpart of
`cips3d_tpu/config/config.py`, reading YAML with the port's own reader
(`config/yaml_lite.py`).

  * one YAML file holds many named "command" nodes; ``--command`` picks one;
  * ``base: other_node`` inherits (deep-merged, the child wins);
  * ``--opts key.subkey value ...`` applies dotted overrides;
  * model nodes carry a ``name`` that the registry resolves to a builder.
"""

from __future__ import annotations

import argparse
import copy
from typing import Any, Callable, Dict, List, Optional

from cips3d_tpu_torch.config import yaml_lite


class Config(dict):
    """Dict with attribute access, recursively."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return Config(v) if isinstance(v, dict) and not isinstance(v, Config) else v

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def wrap(obj):
        if isinstance(obj, dict):
            return Config({k: Config.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config.wrap(v) for v in obj]
        return obj

    def to_dict(self) -> dict:
        def unwrap(o):
            if isinstance(o, dict):
                return {k: unwrap(v) for k, v in o.items()}
            if isinstance(o, list):
                return [unwrap(v) for v in o]
            return o

        return unwrap(self)


def deep_merge(base: dict, override: dict) -> dict:
    """Recursive merge; override wins; dicts merge, everything else replaces."""
    out = copy.deepcopy(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _parse_value(s: str) -> Any:
    """A CLI override value as YAML reads it ('true' -> True, '8' -> 8), and
    a number-like string that YAML 1.1 leaves a string ('1e-5') as a float."""
    try:
        out = yaml_lite.safe_load(s)
    except yaml_lite.YAMLError:
        return s
    if isinstance(out, str):
        try:
            return float(out)
        except ValueError:
            return out
    return out


def apply_dotted_overrides(node: dict, opts: List[str]) -> dict:
    """Apply ``key.sub value`` pairs."""
    if len(opts) % 2 != 0:
        raise ValueError("--opts expects key value pairs")
    node = copy.deepcopy(node)
    for i in range(0, len(opts), 2):
        keys = opts[i].split(".")
        value = _parse_value(opts[i + 1])
        cur = node
        for k in keys[:-1]:
            if k not in cur or not isinstance(cur[k], dict):
                cur[k] = {}
            cur = cur[k]
        cur[keys[-1]] = value
    return node


def resolve_command(config_file: str, command: str, opts: Optional[List[str]] = None) -> Config:
    """Load a YAML file, resolve ``command`` with its ``base:`` chain, apply
    dotted overrides, and return the resolved Config."""
    with open(config_file) as f:
        doc = yaml_lite.safe_load(f.read()) or {}

    def resolve(name: str, seen=()) -> dict:
        if name in seen:
            raise ValueError(f"base: cycle at {name}")
        if name not in doc:
            raise KeyError(f"command node {name!r} not in {config_file}")
        node = copy.deepcopy(doc[name]) or {}
        base_name = node.pop("base", None)
        if base_name:
            node = deep_merge(resolve(base_name, seen + (name,)), node)
        return node

    node = resolve(command)
    if opts:
        node = apply_dotted_overrides(node, opts)
    node["command"] = command
    node["config_file"] = config_file
    return Config.wrap(node)


def dump_config(cfg: Config) -> str:
    return yaml_lite.safe_dump(cfg.to_dict())


# --------------------------------------------------------------------- #
# registry

_REGISTRY: Dict[str, Callable] = {}


def register(name: Optional[str] = None):
    """Decorator: register a builder under ``name`` (default: its qualname)."""

    def deco(fn):
        _REGISTRY[name or f"{fn.__module__}.{fn.__qualname__}"] = fn
        return fn

    return deco


def registry_get(name: str) -> Callable:
    if name not in _REGISTRY:
        raise KeyError(f"{name!r} not registered; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def build_model(cfg, **kwargs_priority):
    """Instantiate a registered component from a config node with ``name``
    (extra kwargs win)."""
    node = cfg.to_dict() if isinstance(cfg, Config) else dict(cfg)
    name = node.pop("name")
    node.pop("register_modules", None)
    node.update(kwargs_priority)
    return registry_get(name)(**node)


def parse_args(argv=None) -> argparse.Namespace:
    """The launcher's flags; ``--device`` picks where the port runs."""
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True, help="YAML config file")
    p.add_argument("--command", required=True, help="command node to run")
    p.add_argument("--opts", nargs="*", default=[], help="dotted overrides: key value ...")
    p.add_argument("--outdir", default="results", help="output root")
    p.add_argument("--debug", action="store_true", help="tiny smoke-run mode")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu on request)")
    return p.parse_args(argv)
