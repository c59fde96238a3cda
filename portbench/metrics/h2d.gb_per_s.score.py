"""The bytes the scoring engine copied to the device in the traced window (the program's ``h2d.bytes``
counter) over the device time of the window's host-to-device copies, in GB/s."""

from portbench.yardstick import spans


def read(ctx: dict) -> float | None:
    copied, seconds = spans.counter("h2d.bytes"), ctx["trace"]["h2d_s"]
    if not copied or not seconds:
        return None
    return copied / seconds / 1e9
