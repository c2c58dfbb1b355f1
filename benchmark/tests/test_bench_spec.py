"""BENCHMARK.json against the benchmark's contract: names, units, keys,
files found by name, and the check's length."""

import json
import os
import re

import harness

SPEC = harness.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATH.match(p) for p in SPEC["paths"])
    assert len(SPEC["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in SPEC["command"])
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        names.append(w["name"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                    "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_it_must():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for name in cells:
        c = harness.cell(name)
        mine = {m["name"] for m in c.end_to_end}
        assert "setup_s" in mine and len(mine) >= 2 and c.per_layer
        for m in c.per_layer:
            assert m["moves"] in mine and m["moves"] in e2e
            assert os.path.exists(os.path.join(harness.HERE, "metrics", m["name"] + ".py"))
        assert os.path.exists(os.path.join(harness.HERE, "drivers",
                                           c.traffic["driver"] + ".py"))
        assert c.limits


def test_configs_are_files_under_paths():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"]
        used = [w for w in SPEC["workloads"] if w["config"] == c["name"]]
        assert used


def test_a_full_check_fits():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
