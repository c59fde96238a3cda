"""A traced run in which a per-layer metric that ``BENCHMARK.json`` lists for
the cell finds nothing to read fails: a kernel class that matches no device
time leaves its roofline unread, and ``run.py`` then exits 4 with no result."""

from __future__ import annotations

import json

import pytest
import torch
from conftest import run_tiny

from portbench import harness
from portbench.yardstick import trace

KERNELS = ["void gemm_bf16_kernel<4, false>(CUtensorMap_st)", "void attn_core_kernel<40>(float const*)"]


class FakeProfile:
    """A profiler whose trace holds the window's range and one copy and two kernels inside it."""

    def start(self):
        pass

    def stop(self):
        pass

    def export_chrome_trace(self, path):
        events = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW_RANGE, "ts": 0.0, "dur": 1000.0},
                  {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "ts": 10.0,
                   "dur": 50.0}]
        events += [{"ph": "X", "cat": "kernel", "name": name, "ts": 100.0 + 200.0 * i, "dur": 100.0}
                   for i, name in enumerate(KERNELS)]
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"traceEvents": events}, f)


@pytest.mark.parametrize("empty", [None, "gemm", "attention"])
def test_a_kernel_class_that_matches_nothing_leaves_its_roofline_unread(tiny, tmp_path, monkeypatch, empty):
    classes = json.loads(trace.CLASSES.read_text())
    if empty is not None:
        classes[empty] = ["no_kernel_has_this_name"]
    path = tmp_path / "kernel_classes.json"
    path.write_text(json.dumps(classes))
    monkeypatch.setattr(trace, "CLASSES", path)
    monkeypatch.setattr(trace, "profiler", FakeProfile)
    run = tiny("imagebert_a.score_staged")
    run.trace = True
    out = run_tiny(run)
    assert out["unread"] == ([] if empty is None else [f"{empty}_roofline.score"])
    assert set(out["metrics"]) == {m["name"] for m in run.per_layer} - set(out["unread"])


def test_run_exits_4_with_no_result_when_a_listed_metric_is_unread(monkeypatch, capsys):
    from portbench import run as entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda: None)
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    monkeypatch.setattr(harness, "run_cell", lambda run, started: {
        "correct": True, "attempted": 1, "failed": 0, "memory_peak_bytes": 1, "busy_s": 1.0, "window_s": 2.0,
        "metrics": {}, "checks": [], "unread": ["gemm_roofline.score"]})
    code = entry.main(["--workload", "imagebert_a.score_staged", "--seed", "5", "--seconds", "1", "--trace", "1"])
    captured = capsys.readouterr()
    assert code == 4 and captured.out == "" and "gemm_roofline.score" in captured.err
