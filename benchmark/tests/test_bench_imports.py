"""A tiny run of each driver loads no module whose top-level name is jax,
jaxlib, flax or cips3d_tpu (cips3d_tpu_torch is another name), checked in a
fresh process and, for the data-parallel driver, in each rank's process."""

import os
import subprocess
import sys
import time

import harness
import tiny

SCRIPT = """
import sys, time
sys.path[:0] = [{root!r}, {here!r}, {tests!r}]
import harness, tiny
loaded = []
for name in ("train_r64_exact", "serve_r256", tiny.RANKS):
    c = tiny.tiny_cell(name)
    run = harness.driver(c.traffic["driver"]).run(c, seed=3, seconds=0.5, trace=False,
                                                  device="cpu", t_start=time.perf_counter(),
                                                  sizes=tiny.sizes(c))
    loaded += run.loaded
assert "cips3d_tpu_torch" in sys.modules
print("FORBIDDEN", harness.forbidden_modules(), loaded)
"""


def test_no_jax_or_jax_package_is_loaded():
    tests = os.path.dirname(os.path.abspath(__file__))
    code = SCRIPT.format(root=harness.ROOT, here=harness.HERE, tests=tests)
    env = dict(os.environ, USE_FLAX="0")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN [] []" in out.stdout


def test_a_rank_that_loads_jax_gives_no_result(capfd):
    c = tiny.tiny_cell(tiny.RANKS)
    run = harness.driver("train_ranks").run(c, seed=5, seconds=0.5, trace=False, device="cpu",
                                            t_start=time.perf_counter(), sizes=tiny.sizes(c),
                                            fault="faults:loads_jax")
    assert run.loaded == ["jax"]
    assert harness.finish(c, run, False) != 0
    assert capfd.readouterr().out == ""


def test_the_check_compares_whole_top_level_names():
    sys.modules.setdefault("cips3d_tpu_torch_probe", sys)
    try:
        assert "cips3d_tpu_torch_probe" not in harness.forbidden_modules()
    finally:
        del sys.modules["cips3d_tpu_torch_probe"]
