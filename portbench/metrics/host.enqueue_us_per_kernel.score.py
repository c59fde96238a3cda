"""The host's time in the scoring model's forward (the program's ``engine.forward`` spans, which enqueue the
kernels and wait for nothing) in the traced window, over the device kernels the window ran, in microseconds.

The time holds the cost of the profiler's ranges opened inside the spans (the 24 ``block.*`` spans of a
forward), so the number compares two versions of the program only where both open the same spans there."""

from portbench.yardstick import spans


def read(ctx: dict) -> float | None:
    host, kernels = spans.total_s("engine.forward"), ctx["trace"]["kernels"]
    if host is None or not kernels:
        return None
    return 1e6 * host / kernels
