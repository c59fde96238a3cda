"""The share of the traced scoring window in which no kernel, copy or fill ran on the device."""

from portbench.yardstick import readers


def read(ctx: dict) -> float | None:
    return readers.idle_pct(ctx)
