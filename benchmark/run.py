"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell's configuration, traffic mix and
metrics are found by name from ``BENCHMARK.json`` (`harness.py`).  The run
needs as many CUDA cards as the cell asks for and exits non-zero without a
result line otherwise.  ``--control bf16`` runs the cell's correctness
control instead: the program built in bfloat16, whose readings the check
has to refuse (the benchmark's own runs never pass it).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _environment() -> None:
    """Keep every cache inside the checkout, and keep libraries from
    loading JAX."""
    cache = os.path.join(ROOT, "benchmark", ".cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (ROOT, HERE):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("bf16",), default=None)
    args = p.parse_args(argv)
    _environment()

    import harness

    c = harness.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        harness.log(f"refused: the cell needs {c.chips} CUDA card(s); "
                    f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    drv = harness.driver(c.traffic["driver"])
    run = drv.run(c, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                  device="cuda", t_start=T_START, control=args.control)
    return harness.finish(c, run, bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())
