"""Model FLOPs of the pairs scored in the traced window over its wall time at the bf16 peak."""

from portbench.yardstick import readers


def read(ctx: dict) -> float | None:
    return readers.mfu_pct(ctx)
