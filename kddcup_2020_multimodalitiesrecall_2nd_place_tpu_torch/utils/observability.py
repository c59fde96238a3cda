"""Structured metrics, timing and profiling hooks, the port of the JAX
package's ``utils/observability.py``: one structured-metrics sink with
per-stage wall time and pairs/sec counters, ``torch.profiler`` annotations
per pipeline stage (where the JAX package opens ``jax.profiler``'s), a
device-trace scope, and the program's own spans and counters.

Spans and counters. ``span(name)`` marks the hot path's layers where the
work happens: the entry (``score.files``, ``train.step``), the host loader
(``loader.read``, ``loader.parse``, ``loader.featurize``, one set a byte span
on its pool's threads, and ``loader.batch`` on its prefetch thread) and the
main thread's wait on it (``loader.wait``), the packed gather
(``packed.gather``), the copies (``engine.h2d``,
``engine.d2h``, ``train.h2d``), the model step (``engine.forward``,
``train.forward_backward``, ``train.optimizer`` and its ``optim.*``) and the
blocks (``block.*``); ``count(name, n)`` adds to a named counter (the scoring
engine's ``h2d.bytes``, ``h2d.pinned_bytes`` for those through its pinned
ring, and ``engine.graph_captures`` and ``engine.graph_replays`` for the ring
slots' CUDA graphs, whose replays run inside ``engine.forward``). The switch
is a running ``torch.profiler`` session (the benchmark's traced window,
``device_profile``, an operator's own profiler): with none running, a span or a count reads one flag and does
nothing else (no clock, no range, no record). With one running, a span
records its name, thread, start and end (``time.perf_counter_ns``) and the
index of its parent span on the same thread into one process-wide ``Meter``,
and opens a ``record_function`` range of its name, so the main thread's spans
appear in the device trace. The profiler keeps the ranges of the thread that
started it (and of autograd's) only, so the loader threads' spans live in the
record alone; ``device_profile`` writes every span into its trace file on the
trace's clock. Each profiler session starts a fresh record; ``recorded()``
reads the current or last one.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import sys
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import NamedTuple


def _clock_pair() -> tuple[int, int]:
    """(``perf_counter_ns``, ``time_ns``) read together: the anchor that puts a span on the Unix clock of a
    profiler trace."""
    return time.perf_counter_ns(), time.time_ns()


@dataclass
class Meter:
    """Accumulates per-stage wall time and item counts; the process-wide one
    also keeps the spans of the running (or last) profiler session, each
    ``[name, thread, parent row, start_ns, end_ns]``, and the clock anchor
    taken at its start."""

    seconds: dict[str, float] = field(default_factory=lambda: defaultdict(float))
    counts: dict[str, int] = field(default_factory=lambda: defaultdict(int))
    spans: list[list] = field(default_factory=list)
    anchor: tuple[int, int] = field(default_factory=_clock_pair)

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0):
        """Time the block as stage ``name`` (``items`` more of it), whether or
        not a profiler runs; while one runs (``tracing()``), the block is also
        a ``torch.profiler.record_function`` range of that name."""
        import torch

        t0 = time.perf_counter()
        with torch.profiler.record_function(name) if tracing() else contextlib.nullcontext():
            yield
        self.seconds[name] += time.perf_counter() - t0
        self.counts[name] += items

    def rate(self, name: str) -> float:
        s = self.seconds.get(name, 0.0)
        return self.counts.get(name, 0) / s if s > 0 else 0.0

    def summary(self) -> dict:
        return {
            name: {
                "seconds": round(self.seconds[name], 4),
                "count": self.counts.get(name, 0),
                "per_second": round(self.rate(name), 2),
            }
            for name in self.seconds
        }

    def restart(self) -> None:
        """A fresh record: no spans, no counts, a new clock anchor."""
        self.seconds = defaultdict(float)
        self.counts = defaultdict(int)
        self.spans = []
        self.anchor = _clock_pair()


_METER = Meter()
_LOCK = threading.Lock()  # the counters' read-modify-write: ``count`` may run on any thread
_THREAD = threading.local()  # each thread's open spans' rows and its OS thread id
_profiler = None  # torch.autograd.profiler, once this process has imported torch


def _torch_profiler():
    """torch's profiler module where this process has imported torch, the
    record's restart hooked onto the start of its sessions (at the first call
    that finds it: this module imports no torch, so the data package stays
    free of it); None where torch is not imported."""
    global _profiler
    mod = sys.modules.get("torch.autograd.profiler")
    if mod is None:
        return None
    start = mod._run_on_profiler_start
    if not getattr(start, "restarts_the_record", False):
        # every profiler session starts through this module-level hook of torch's, before it raises the flag
        def restart_then_start():
            _METER.restart()
            start()

        restart_then_start.restarts_the_record = True
        mod._run_on_profiler_start = restart_then_start
    _METER.restart()
    _profiler = mod
    return mod


def tracing() -> bool:
    """Whether a ``torch.profiler`` session is running: the switch of ``span``, ``count`` and ``Meter.stage``'s
    range."""
    p = _profiler or _torch_profiler()
    return p is not None and p._is_profiler_enabled


class Span(NamedTuple):
    name: str
    thread: int  # the OS thread id, as the profiler's trace gives ``tid``
    parent: int  # index in the record of the enclosing span on the same thread, -1 at the top
    start_ns: int  # time.perf_counter_ns
    end_ns: int | None  # None while the span is open


class _Off:
    """What ``span`` returns with no profiler running: enters and leaves, nothing else."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("_name", "_row", "_range")

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        stack = getattr(_THREAD, "rows", None)
        if stack is None:
            # the OS thread id once a thread: it is a system call, and one took ~0.5 ms under the profiler on
            # the H100 host that PERF.md measures
            _THREAD.id = threading.get_native_id()
            stack = _THREAD.rows = []
        self._row = row = [self._name, _THREAD.id, stack[-1] if stack else None, 0, None]
        _METER.spans.append(row)
        stack.append(row)
        self._range = _profiler.record_function(self._name)  # torch.profiler.record_function
        self._range.__enter__()
        # the clock last in, first out: the span lies inside its range, with no Python call between them in
        # which another thread could take the interpreter
        row[3] = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        self._row[4] = time.perf_counter_ns()
        self._range.__exit__(*exc)
        _THREAD.rows.pop()
        return False


def span(name: str):
    """A context manager: the block as span ``name`` while a profiler session
    runs; nothing but one flag read while none does."""
    p = _profiler or _torch_profiler()
    if p is None or not p._is_profiler_enabled:
        return _OFF
    return _On(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a profiler session runs."""
    p = _profiler or _torch_profiler()
    if p is None or not p._is_profiler_enabled:
        return
    with _LOCK:
        _METER.counts[name] += n


def recorded() -> dict:
    """The record of the running or last profiler session: ``spans`` (``Span``
    each, in the order they opened), ``counters`` and ``anchor``
    (``perf_counter_ns``, ``time_ns``) taken at the session's start."""
    rows = list(_METER.spans)
    index = {id(row): i for i, row in enumerate(rows)}
    spans = [Span(n, t, -1 if p is None else index.get(id(p), -1), s, e) for n, t, p, s, e in rows]
    with _LOCK:
        counters = dict(_METER.counts)
    return {"spans": spans, "counters": counters, "anchor": _METER.anchor}


def _add_spans_to_trace(path: str) -> None:
    """Append the record's closed spans, as complete events of ``cat``
    ``program_span`` on their own thread's row, to the chrome trace at
    ``path``, on the trace's
    clock: Unix time from the anchor, less ``baseTimeNanoseconds``, then
    shifted by the median gap between the spans the profiler also recorded
    as ``record_function`` ranges and those ranges (the profiler converts
    its own clock to Unix time, which can sit some hundred microseconds off
    ``time_ns``)."""
    with open(path, encoding="utf-8") as f:
        trace = json.load(f)
    rec = recorded()
    perf0, unix0 = rec["anchor"]
    shift = unix0 - perf0 - int(trace.get("baseTimeNanoseconds", 0))
    events = [{"ph": "X", "cat": "program_span", "name": s.name, "pid": os.getpid(), "tid": s.thread,
               "ts": (s.start_ns + shift) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3, "args": {"parent": s.parent}}
              for s in rec["spans"] if s.end_ns is not None]
    twins, ours = defaultdict(list), defaultdict(list)
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation":
            twins[(e["name"], e["tid"])].append(float(e["ts"]))
    for e in events:
        ours[(e["name"], e["tid"])].append(e)
    gaps = sorted(t - e["ts"] for key, spans in ours.items() if len(twins[key]) == len(spans)
                  for e, t in zip(spans, sorted(twins[key])))
    if gaps:
        for e in events:
            e["ts"] += gaps[len(gaps) // 2]
    trace["traceEvents"].extend(events)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(trace, f)


def log_metrics(step: int, metrics: dict, stream=None) -> None:
    """One JSON line per step: greppable, machine-parsable (the JAX
    function's bytes for the same input; a 0-d tensor is a number)."""
    stream = stream or sys.stdout
    payload = {"step": step}
    for k, v in metrics.items():
        try:
            payload[k] = float(v)
        except (TypeError, ValueError):
            payload[k] = str(v)
    stream.write(json.dumps(payload) + "\n")
    stream.flush()


@contextlib.contextmanager
def device_profile(log_dir: str | None):
    """A ``torch.profiler`` trace of the block (the CPU, and CUDA where a card
    is present) written into ``log_dir`` as a ``*.pt.trace.json`` that
    TensorBoard and Perfetto read, with the program's spans of the block
    (the loader thread's too, on their own rows) added on the trace's clock; nothing when ``log_dir`` is None."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    def ready(prof) -> None:
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns() // 1_000_000}"
                                     f".pt.trace.json")
        prof.export_chrome_trace(path)
        _add_spans_to_trace(path)

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    tracing()  # the record's restart hooked on before the session starts
    with profile(activities=activities, on_trace_ready=ready):
        yield
