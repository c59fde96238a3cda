"""The numbers that decide ``correct``: each the gap between what the program
produced and what the reference works out, to be held under its limit."""

from __future__ import annotations

import math

import numpy as np

# an element whose reference gradient is under this share of the median leaf's RMS gradient moves by
# round-off alone (a key's bias under softmax, the rows of a table no input reads): it sits out of the
# change numbers
NEGLIGIBLE_GRAD = 1e-3


def widest_gap(program, reference) -> float:
    a, b = np.asarray(program, np.float64), np.asarray(reference, np.float64)
    if a.shape != b.shape or not np.all(np.isfinite(a)):
        return math.inf
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def loss_gap(program: list[float], reference: list[float]) -> float:
    """The largest relative gap of a step's loss."""
    if len(program) != len(reference) or not all(math.isfinite(x) for x in program):
        return math.inf
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))


def leaf_gaps(program: dict[str, float], reference: dict[str, float]) -> dict[str, float]:
    """Each leaf's |program norm - reference norm| / max(its reference norm, the median leaf's); a leaf
    the program lacks, or whose norm is not finite, reads inf."""
    median = float(np.median(list(reference.values())))
    out = {}
    for n, r in reference.items():
        p = program.get(n, math.nan)
        out[n] = abs(p - r) / max(r, median) if math.isfinite(p) and max(r, median) > 0 else math.inf
    return out


def moving(ref_grads: dict) -> dict:
    """Per leaf, the elements whose reference gradient is at least ``NEGLIGIBLE_GRAD`` of the median leaf's
    RMS gradient: the rest (a key's bias under softmax, a table's unread rows) move by round-off alone."""
    rms = [float(g.float().norm()) / max(g.numel(), 1) ** 0.5 for g in ref_grads.values()]
    floor = NEGLIGIBLE_GRAD * float(np.median(rms))
    return {n: g.abs() >= floor for n, g in ref_grads.items()}


def kept_norms(deltas: dict, keep: dict) -> dict[str, float]:
    """The norm of each leaf's change over its kept elements (leaves with none left out)."""
    return {n: float((deltas[n].float() * keep[n]).norm()) if n in deltas else math.nan
            for n in keep if bool(keep[n].any())}
