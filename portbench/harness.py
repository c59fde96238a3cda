"""The benchmark's harness, driven by ``BENCHMARK.json``: a cell's configuration,
traffic, limits, entry and per-layer readers are files found by name.

* configuration: the ``file`` its entry in ``BENCHMARK.json`` names;
* traffic: ``portbench/traffic/<traffic>.json``, whose ``entry`` names the
  module in ``portbench/entries/`` that drives the program;
* limits of the numbers that decide ``correct``: ``portbench/limits/<cell>.json``;
* per-layer metric ``<name>``: ``portbench/metrics/<name>.py``, a ``read(ctx)``
  that returns a number or None.

An entry module has ``setup(run)`` -> state, ``window(run, state, seconds)`` ->
(end-to-end values by metric name, counts), ``work(run, state, counts)`` -> the
yardstick's work of the window, ``after_trace(run, state)`` -> more numbers
for the readers, and ``check(run, state)`` -> [(name, value, limit)].
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# top-level module names that no run may load (the JAX package is the port's name without its suffix)
FORBIDDEN = ("jax", "jaxlib", "flax", "kddcup_2020_multimodalitiesrecall_2nd_place_tpu")
# a traced run traces this much of its window at most: a whole window of training at full length would
# leave a trace of ~1 GB to write and read back
TRACE_WINDOW_S = 12.0


@dataclass
class Run:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    entry: object
    end_to_end: list[dict]
    per_layer: list[dict]
    seed: int = 0
    seconds: float = 10.0
    trace: bool = False
    device: object = None
    tmpdir: str | None = None


def load_benchmark(repo: Path = REPO) -> dict:
    return json.loads((repo / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_reader(name: str, root: Path = ROOT):
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def resolve(cell: str, bench: dict | None = None, repo: Path = REPO) -> Run:
    """The cell's files, found by the names in ``BENCHMARK.json``."""
    bench = bench if bench is not None else load_benchmark(repo)
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[cell]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((repo / configs[w["config"]]["file"]).read_text())
    root = repo / "portbench"
    traffic = json.loads((root / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / "limits" / f"{cell}.json").read_text())
    entry = importlib.import_module(f"portbench.entries.{traffic['entry']}")
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell)]
    per_layer = [{**m, "read": load_reader(m["name"], root)} for m in bench["per_layer"] if _applies(m, cell)]
    return Run(w, config, traffic, limits, entry, e2e, per_layer)


def process_start() -> float:
    """This process's start on the ``time.perf_counter`` clock (from /proc; the import time otherwise)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.perf_counter() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.perf_counter()


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def judge(checks: list[tuple[str, float, float]]) -> bool:
    return all(math.isfinite(v) and v <= limit for _, v, limit in checks)


def metric(value: float, unit: str) -> dict:
    return {"value": value, "unit": unit}


def run_cell(run: Run, started: float) -> dict:
    """Set-up, the measured window (traced with ``run.trace``), the check; -> the result line's fields
    (``device`` filled by the caller)."""
    import torch

    from .yardstick import steady
    from .yardstick import trace as tracing

    state = run.entry.setup(run)
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    steady.quiesce()
    setup_s = time.perf_counter() - started
    print(f"[portbench] set-up {setup_s:.3f} s", file=sys.stderr)
    prof = tracing.profiler() if run.trace else None
    if prof is not None:
        prof.start()
    with torch.profiler.record_function(tracing.WINDOW_RANGE):
        values, counts = run.entry.window(run, state, min(run.seconds, TRACE_WINDOW_S) if run.trace else run.seconds)
    if prof is not None:
        prof.stop()
    steady.release()
    peak = torch.cuda.max_memory_allocated() if run.device.type == "cuda" else 0
    out = {"attempted": counts["attempted"], "failed": counts["failed"], "memory_peak_bytes": peak}
    if prof is not None:
        reduced = tracing.reduce(prof)
        del prof
        ctx = {"trace": reduced, "counts": counts, "work": run.entry.work(run, state, counts),
               "extras": run.entry.after_trace(run, state), "config": run.config}
        metrics = {}
        for m in run.per_layer:
            value = m["read"](ctx)
            if value is None:
                print(f"[portbench] per-layer metric {m['name']} found nothing to read", file=sys.stderr)
                continue
            metrics[m["name"]] = metric(value, m["unit"])
        # a metric listed for this cell reads something in every traced run: one that reads nothing (a kernel
        # renamed, say) fails the run, after the check has cleaned up
        out["unread"] = [m["name"] for m in run.per_layer if m["name"] not in metrics]
        out.update(metrics=metrics, busy_s=reduced["busy_s"], window_s=reduced["window_s"],
                   breakdown={"device_ops": reduced["device_ops"], "idle_gaps": reduced["idle_gaps"]})
    else:
        values = {**values, "setup_s": setup_s}
        out["metrics"] = {m["name"]: metric(values[m["name"]], m["unit"]) for m in run.end_to_end}
    out["checks"] = run.entry.check(run, state)
    out["correct"] = judge(out["checks"]) and counts["failed"] == 0
    return out
