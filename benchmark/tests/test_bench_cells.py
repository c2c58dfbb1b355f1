"""Each cell's path rehearsed end to end on the CPU at tiny widths: the
program's run, the reference's check, and the check failing under each
fault the cell can have (`faults.py`)."""

import time

import numpy as np
import pytest

import faults
import harness
import tiny

TRAIN = [n for n in tiny.CELLS if harness.cell(n).traffic["driver"] == "train"]


def _run(name, fault=None, seed=2 ** 31 + 11):
    c = tiny.tiny_cell(name)
    drv = harness.driver(c.traffic["driver"])
    if fault is not None and c.traffic["driver"] == "train_ranks":
        fault = "faults:" + fault.__name__   # imported by name in each rank's process
    return drv.run(c, seed=seed, seconds=1.0, trace=False, device="cpu",
                   t_start=time.perf_counter(), sizes=tiny.sizes(c), fault=fault)


@pytest.mark.parametrize("name", tiny.CELLS + [tiny.RANKS])
def test_cell_runs_and_is_correct(name):
    run = _run(name)
    assert run.attempted > 0 and run.failed == 0
    assert harness.passed(run.checks), run.checks
    assert all(np.isfinite(v) and v > 0 for v in run.values.values())


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", [faults.unchanged, faults.half_batch, faults.no_ema],
                         ids=["unchanged", "half_batch", "no_ema"])
def test_train_check_fails_under_a_fault(name, fault):
    run = _run(name, fault)
    assert not harness.passed(run.checks), run.checks


@pytest.mark.parametrize("fault", [faults.unchanged, faults.half_batch, faults.no_ema,
                                   faults.no_exchange],
                         ids=["unchanged", "half_batch", "no_ema", "no_exchange"])
def test_ranks_check_fails_under_a_fault(fault):
    run = _run(tiny.RANKS, fault)
    assert not harness.passed(run.checks), run.checks


def test_serve_check_fails_on_an_altered_frame():
    run = _run("serve_r256", faults.altered_frame)
    assert not harness.passed(run.checks), run.checks
