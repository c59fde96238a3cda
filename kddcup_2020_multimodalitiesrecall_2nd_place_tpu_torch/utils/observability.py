"""Structured metrics, timing and profiling hooks, the port of the JAX
package's ``utils/observability.py``: one structured-metrics sink with
per-stage wall time and pairs/sec counters, ``torch.profiler`` annotations
per pipeline stage (where the JAX package opens ``jax.profiler``'s), and a
device-trace scope.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class Meter:
    """Accumulates per-stage wall time and item counts."""

    seconds: dict[str, float] = field(default_factory=lambda: defaultdict(float))
    counts: dict[str, int] = field(default_factory=lambda: defaultdict(int))

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0):
        """Time the block as stage ``name`` (``items`` more of it), inside a
        ``torch.profiler.record_function`` range of that name."""
        import torch

        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
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
    TensorBoard and Perfetto read; nothing when ``log_dir`` is None."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield
