"""What the per-layer metric readers share: each takes the reduced trace, the
window's counts, the yardstick's work of the window and the entry's extras
(``harness.run_cell``'s ``ctx``) and returns a number, or None where the
window holds nothing to read."""

from __future__ import annotations

from . import peaks


def roofline_pct(ctx: dict, cls: str) -> float | None:
    """100 x the least time the class's counted work needs over its kernels' device time."""
    seconds = ctx["trace"]["class_s"].get(cls, 0.0)
    ops = ctx["work"].get(cls)
    if not seconds or not ops:
        return None
    return 100.0 * peaks.least_seconds(ops) / seconds


def mfu_pct(ctx: dict) -> float | None:
    """100 x the model FLOPs of the window's work over the window's wall time at the bf16 peak."""
    flops, seconds = ctx["work"].get("model_flops"), ctx["counts"]["seconds"]
    if not flops or not seconds:
        return None
    return 100.0 * flops / seconds / peaks.BF16_FLOPS


def idle_pct(ctx: dict) -> float | None:
    t = ctx["trace"]
    if not t["window_s"] or not t["kernels"]:
        return None
    return 100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"]
