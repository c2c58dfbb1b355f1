"""Products of one whole training step: the reference step
(`reference/step.py`, forward and backward of both phases, R1's double
backward, no recomputed operation) run once while every matrix product and
convolution it dispatches is counted from its shapes, by the formulas of
`torch.utils.flop_counter` (2 FLOP a multiply-add)."""

from __future__ import annotations

from typing import Callable


def step_flops(run_step: Callable[[], object]) -> int:
    """FLOP of the products that ``run_step`` (one reference step) runs."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class Products(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            count = flop_registry.get(func._overloadpacket)
            if count is not None:
                Products.total += int(count(*args, **kwargs, out_val=out))
            return out

    with Products():
        run_step()
    return Products.total
