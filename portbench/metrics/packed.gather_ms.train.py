"""The mean time of a training batch's gather from the packed shards and its f16 -> f32 cast, on the host (the
program's ``packed.gather`` spans in the traced window)."""

from portbench.yardstick import spans


def read(ctx: dict) -> float | None:
    mean = spans.mean_s("packed.gather")
    return None if mean is None else 1e3 * mean
