"""The forward, dx and weight-gradient products of a training step (encoder, label conv, feature and pooler denses) against the device time of the kernels classed as GEMM."""

from portbench.yardstick import readers


def read(ctx: dict) -> float | None:
    return readers.roofline_pct(ctx, "gemm")
