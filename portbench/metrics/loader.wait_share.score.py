"""The share of the traced scoring window that the main thread spent blocked on the host loader for its next
batch (the program's ``loader.wait`` spans, summed, over the window's length)."""

from portbench.yardstick import spans


def read(ctx: dict) -> float | None:
    wait, window = spans.total_s("loader.wait"), ctx["trace"]["window_s"]
    if wait is None or not window:
        return None
    return 100.0 * wait / window
