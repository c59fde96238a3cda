"""The model's matrix products (QKV, out-projection, FFN up and down, the feature dense, pooler and head) against the device time of the kernels classed as GEMM, in the scoring window."""

from portbench.yardstick import readers


def read(ctx: dict) -> float | None:
    return readers.roofline_pct(ctx, "gemm")
