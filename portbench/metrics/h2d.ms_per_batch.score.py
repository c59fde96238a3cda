"""Device time of the host-to-device copies in the traced scoring window, per batch scored."""


def read(ctx: dict) -> float | None:
    batches, h2d = ctx["work"].get("batches"), ctx["trace"]["h2d_s"]
    if not batches or not h2d:
        return None
    return 1e3 * h2d / batches
