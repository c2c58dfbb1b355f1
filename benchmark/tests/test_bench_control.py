"""The correctness control on the card: each cell run in the nearest
precision below the one its configuration states (``control`` in the
configuration's file: bfloat16) has to come out not correct.  Run on the card with

    python -m pytest benchmark/tests/test_bench_control.py -m gpu

It skips without a CUDA card."""

import json
import os
import subprocess
import sys

import pytest

import harness

CELLS = [w["name"] for w in harness.benchmark_spec()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_is_refused(card, name):
    control = harness.cell(name).config["control"]
    out = subprocess.run([sys.executable, os.path.join(harness.HERE, "run.py"),
                          "--workload", name, "--seed", str(2 ** 31 + 101), "--seconds", "3",
                          "--trace", "0", "--control", control],
                         capture_output=True, text=True, timeout=900, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is False, result["checks"]
