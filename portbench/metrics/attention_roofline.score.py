"""The attention core (QK^T, softmax, PV) of every scoring layer against the device time of the kernels classed as attention."""

from portbench.yardstick import readers


def read(ctx: dict) -> float | None:
    return readers.roofline_pct(ctx, "attention")
