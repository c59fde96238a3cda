"""The attention core's forward and backward of every training layer against the device time of the kernels classed as attention."""

from portbench.yardstick import readers


def read(ctx: dict) -> float | None:
    return readers.roofline_pct(ctx, "attention")
