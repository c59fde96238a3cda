"""Rows a second of the host loader alone (the native parser and the featurizer, no model) over the
cell's own file, one pass after the traced window, on the host clock."""


def read(ctx: dict) -> float | None:
    return ctx["extras"].get("loader_rows_per_s")
