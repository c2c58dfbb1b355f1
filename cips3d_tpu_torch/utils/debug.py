"""Shape-tracing debug mode: counterpart of `cips3d_tpu/utils/debug.py`.

With it on, the generator and the discriminator print each traced
tensor's shape and dtype at the JAX package's points (`mapping`,
`points_forward.*`, `disc.*`), as ``[shape] name: (dims):dtype`` lines with
torch's dtype names.  PyTorch runs eagerly, so a line prints at every call,
where JAX prints once per compiled variant.

Usage:
    from cips3d_tpu_torch.utils import debug
    debug.enable(True)                    # or --opts debug_shapes true
    with debug.shape_debug():             # scoped
        gen(...)
"""

from __future__ import annotations

import contextlib

_ENABLED = False


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


def enabled() -> bool:
    return _ENABLED


@contextlib.contextmanager
def shape_debug():
    global _ENABLED
    prev = _ENABLED
    _ENABLED = True
    try:
        yield
    finally:
        _ENABLED = prev


def trace(name: str, *arrays, **named) -> None:
    """Print ``name: shape:dtype`` for each tensor (nothing when disabled)."""
    if not _ENABLED:
        return
    parts = [_fmt(a) for a in arrays] + [f"{k}={_fmt(a)}" for k, a in named.items()]
    print(f"[shape] {name}: {', '.join(parts)}", flush=True)


def _fmt(a) -> str:
    shape = getattr(a, "shape", None)
    if shape is None:
        return repr(a)
    return f"{tuple(shape)}:{getattr(a, 'dtype', None)}"
