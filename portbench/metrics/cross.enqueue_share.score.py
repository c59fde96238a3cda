"""The share of the scoring forward's host time spent in the cross-attention blocks: the program's
``block.cross_attention`` spans over its ``engine.forward`` spans in the traced window, each summed, x 100.

Both hold the cost of the profiler's ranges opened inside them, so the number compares two versions of the
program only where both open the same spans there."""

from portbench.yardstick import spans


def read(ctx: dict) -> float | None:
    cross, forward = spans.total_s("block.cross_attention"), spans.total_s("engine.forward")
    if cross is None or not forward:
        return None
    return 100.0 * cross / forward
