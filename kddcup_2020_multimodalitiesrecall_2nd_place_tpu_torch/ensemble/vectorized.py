"""Vectorised fusion + dedup rerank on a device (the port of the JAX package's
``ensemble/vectorized.py``).

The semantics of ``fusion.py`` (the dict-based reference), over dense pair
arrays: the fusion and the dedup filter run as a few segment reductions on
the device (``torch.Tensor.scatter_reduce`` with ``amax``, ``amin`` and
``sum`` in place of JAX's ``segment_max``/``segment_min``/``segment_sum``).
IO (score-file parsing, id factorisation, CSV writing) and the top-5
extraction stay on the host.

Semantics (the reference's ``code/main.py:44-104``): merge = 0.2*B + 0.2*C +
0.3*A + 0.3*L over the LXMERT pair universe with LXMERT backfill; a product
whose two best merge scores (across all queries) differ by < 0.92 is dropped
everywhere; otherwise it survives only where |score - product_max| < 1e-5;
top-5 per query, falling back to the unfiltered ranking when < 5 products
survive.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.engine import resolve_device
from .fusion import ARGMAX_TOL, DEFAULT_WEIGHTS, GAP_THRESHOLD, ScoreTable


def tables_to_arrays(scores_b: ScoreTable, scores_c: ScoreTable, scores_a: ScoreTable,
                     scores_lxmert: ScoreTable):
    """Flatten the four tables over the LXMERT pair universe with backfill ->
    (qids, pids, qcodes, pcodes, num_products, scores [N, 4] f64 (B, C, A, L))."""
    qids: list[str] = []
    pids: list[str] = []
    cols = ([], [], [], [])
    for query_id in scores_b:
        rb = scores_b[query_id]
        rc = scores_c[query_id]
        ra = scores_a[query_id]
        for product_id, l_score in scores_lxmert[query_id].items():
            qids.append(query_id)
            pids.append(product_id)
            cols[0].append(rb.get(product_id, l_score))
            cols[1].append(rc.get(product_id, l_score))
            cols[2].append(ra.get(product_id, l_score))
            cols[3].append(l_score)
    scores = np.stack([np.asarray(c, np.float64) for c in cols], axis=1)
    _, qcodes = np.unique(np.asarray(qids), return_inverse=True)
    up, pcodes = np.unique(np.asarray(pids), return_inverse=True)
    return np.asarray(qids), np.asarray(pids), qcodes, pcodes, len(up), scores


def fusion_filter_device(scores: torch.Tensor, pcodes: torch.Tensor, num_products: int, weights=DEFAULT_WEIGHTS,
                         gap: float = GAP_THRESHOLD, tol: float = ARGMAX_TOL) -> tuple[torch.Tensor, torch.Tensor]:
    """scores [N, 4] (B, C, A, L) and pcodes [N] int64 on one device -> (merge
    [N], keep [N] bool), computed in scores' dtype. The weighted sum runs in
    the dict path's order (((B + C) + A) + L), so in f64 its merge scores are
    the dict path's, bit for bit."""
    w = [float(x) for x in weights]
    merge = scores[:, 0] * w[0] + scores[:, 1] * w[1] + scores[:, 2] * w[2] + scores[:, 3] * w[3]
    n = merge.shape[0]

    def segment(values, reduce: str, identity):
        out = torch.full((num_products,), identity, dtype=values.dtype, device=values.device)
        return out.scatter_reduce(0, pcodes, values, reduce, include_self=True)

    m1 = segment(merge, "amax", -torch.inf)
    counts = segment(torch.ones_like(merge), "sum", 0)
    # the index of ONE entry at the product's max (ties: the smallest index),
    # left out of the second-best score
    idx = torch.arange(n, device=merge.device)
    first_max = segment(torch.where(merge == m1[pcodes], idx, n), "amin", n)
    m2 = segment(torch.where(idx == first_max[pcodes], -torch.inf, merge), "amax", -torch.inf)
    drop_product = (counts >= 2) & ((m1 - m2) < gap)
    keep = ~drop_product[pcodes] & ((merge - m1[pcodes]).abs() < tol)
    return merge, keep


def top5_rows_vectorized(qids: np.ndarray, pids: np.ndarray, qcodes: np.ndarray, merge: np.ndarray,
                         keep: np.ndarray, k: int = 5) -> dict[str, list[str]]:
    """Host-side top-k with ``fusion.top5_rows``' rows: Python's ``sorted`` is
    stable on the insertion-ordered dict items, so ties keep their first
    appearance, and a lexsort on (appearance, -score) per query does the same.
    A query none of whose pairs is kept gets no row, as in ``top5_rows`` (the
    reference iterates the filtered table); the JAX package's version gives it
    the fallback row."""
    order = np.lexsort((np.arange(len(qids)), -merge, qcodes))
    rows: dict[str, list[str]] = {}
    fallback_rows: dict[str, list[str]] = {}
    boundaries = np.flatnonzero(np.diff(qcodes[order])) + 1
    for seg in np.split(order, boundaries):
        q = qids[seg[0]]
        kept = seg[keep[seg]]
        if len(kept) == 0:
            continue
        if len(kept) >= k:
            rows[q] = [pids[i] for i in kept[:k]]
        else:
            fallback_rows[q] = [pids[i] for i in seg[:k]]
    rows.update(fallback_rows)
    return rows


def build_submission_vectorized(scores_b: ScoreTable, scores_c: ScoreTable, scores_a: ScoreTable,
                                scores_lxmert: ScoreTable, device=None) -> dict[str, list[str]]:
    """Four score tables -> query -> top-5, the filter on ``device`` (the card
    unless the caller passes ``"cpu"``) in float64, the dict path's precision."""
    device = resolve_device(device)
    qids, pids, qcodes, pcodes, num_products, scores = tables_to_arrays(scores_b, scores_c, scores_a, scores_lxmert)
    merge, keep = fusion_filter_device(torch.from_numpy(scores).to(device, torch.float64),
                                       torch.from_numpy(pcodes).to(device, torch.int64), num_products)
    return top5_rows_vectorized(qids, pids, qcodes, merge.cpu().numpy(), keep.cpu().numpy())
