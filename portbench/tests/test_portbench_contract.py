"""``BENCHMARK.json``'s form (keys, names, units, bounds), and every cell's files found by name."""

from __future__ import annotations

import json
import re

import pytest
from conftest import REPO

from portbench import harness

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and (REPO / "portbench").is_dir()
    assert 1 <= len(BENCH["command"]) <= 32 and all(TEXT.match(w) for w in BENCH["command"])
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_texts():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and TEXT.match(c["why"]) and TEXT.match(c["source"])
        assert c["file"].startswith("portbench/") and all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert TEXT.match(w["why"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"} and TEXT.match(m["layer"])


def test_bounds_and_what_each_cell_reports():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and harness._applies(e2e[m["moves"]], cell)
    for cell in cells:
        reported = [n for n, m in e2e.items() if harness._applies(m, cell)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(harness._applies(m, cell) for m in BENCH["per_layer"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(cells) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cells_files_are_found_by_name(cell):
    run = harness.resolve(cell)
    assert run.config["reduced"] == [] and run.config["model"] == run.workload["config"]
    assert callable(run.entry.setup) and callable(run.entry.check)
    assert run.limits and all(isinstance(v, float) for v in run.limits.values())
    assert {m["name"] for m in run.end_to_end} >= {"setup_s"} and run.per_layer
    assert all(callable(m["read"]) for m in run.per_layer)
