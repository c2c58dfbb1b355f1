"""What the per-layer metrics read of the program's own counters
(`cips3d_tpu_torch/utils/trace.py`)."""

from __future__ import annotations

from typing import Optional


def counters() -> Optional[dict]:
    """The program's counters by family; None where the program has none."""
    try:
        from cips3d_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.COUNTERS
