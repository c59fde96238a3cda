"""The reduction of a ``torch.profiler`` trace of the measured window to the
numbers the per-layer metrics read: the window's length, the time the device
was busy (the union of its kernels, copies and fills), each kernel class's
device time (classes by name, ``kernel_classes.json``), the host-to-device
copies' time, the device operations that took most time, and the longest
idle gaps, each named by the innermost host range and operation around its
middle."""

from __future__ import annotations

import json
import os
import re
import tempfile
from collections import defaultdict
from pathlib import Path

WINDOW_RANGE = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CLASSES = Path(__file__).resolve().parent / "kernel_classes.json"
TOP = 10


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=False,
                   with_stack=False, profile_memory=False)


def ranged(fn, name: str):
    """``fn`` inside a profiler range named ``name`` (the traced runs' spans around the program's calls)."""
    import torch

    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapper


def _events(prof) -> list[dict]:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    finally:
        os.unlink(path)


def _merge(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _around(host: list[tuple[float, float, str]], t: float) -> str:
    inside = [(b - a, name) for a, b, name in host if a <= t < b]
    return min(inside)[1] if inside else ""


def reduce(prof) -> dict:
    """-> {"window_s", "busy_s", "class_s": {class: s}, "h2d_s", "kernels", "device_ops", "idle_gaps"}."""
    classes = {k: [re.compile(p, re.I) for p in v] for k, v in json.loads(CLASSES.read_text()).items()}
    events = _events(prof)
    windows = [e for e in events if e.get("name") == WINDOW_RANGE and e.get("cat") == "user_annotation"]
    if not windows:
        raise RuntimeError(f"the trace holds no {WINDOW_RANGE} range")
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    dev, by_name = [], defaultdict(float)
    class_us, h2d_us, kernels = defaultdict(float), 0.0, 0
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        name = e["name"]
        dev.append((a, b))
        by_name[name] += b - a
        if e["cat"] == "kernel":
            kernels += 1
            for cls, pats in classes.items():
                if any(p.search(name) for p in pats):
                    class_us[cls] += b - a
        elif e["cat"] == "gpu_memcpy" and "HtoD" in name:
            h2d_us += b - a
    busy = _merge(dev)
    edges = [w0, *[x for span in busy for x in span], w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)), reverse=True)[:TOP]
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
              if e.get("cat") == "user_annotation" and e.get("name") != WINDOW_RANGE]
    ops = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events if e.get("cat") == "cpu_op"]
    idle = []
    for length, start in gaps:
        mid = start + length / 2
        name = " > ".join(n for n in (_around(ranges, mid), _around(ops, mid)) if n) or "no host range"
        idle.append([name, length * 1e-6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "class_s": {k: v * 1e-6 for k, v in class_us.items()},
        "h2d_s": h2d_us * 1e-6,
        "kernels": kernels,
        "device_ops": [[n, s * 1e-6] for n, s in top],
        "idle_gaps": idle,
    }
