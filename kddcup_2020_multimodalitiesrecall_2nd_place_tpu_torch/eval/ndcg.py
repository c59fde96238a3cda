"""nDCG@5 evaluation against valid_answer.json.

One implementation replacing the reference's three copies
(``imagebert_lds/src/evaluation.py:4-38``, ``imagebert_zk/evaluate_function.py:5-45``,
``lxmert/src/utils.py:158-171``): per query, rank products by score desc,
binary relevance, dcg = r0 + sum(ri / log2(i+2)); idcg from the answer count;
queries missing from the predictions contribute 0 (zk tolerant variant).
"""

from __future__ import annotations

import json

import numpy as np


def dcg_at_k(rel, k: int) -> float:
    rel = np.asarray(rel, dtype=np.float64)[:k]
    if rel.size == 0:
        return 0.0
    return float(rel[0] + np.sum(rel[1:] / np.log2(np.arange(3, rel.size + 2))))


def ndcg_at_k(ranked_relevance, ideal_relevance, k: int = 5) -> float:
    idcg = dcg_at_k(ideal_relevance, k)
    if idcg == 0:
        return 0.0
    return dcg_at_k(ranked_relevance, k) / idcg


def evaluate_scores(
    scores: dict[str, dict[str, float]],
    answers: dict[str, list],
    k: int = 5,
) -> float:
    """Mean nDCG@k of per-query score tables vs ground-truth product lists."""
    total = 0.0
    n = 0
    for query_id, truth in answers.items():
        truth_set = {str(p) for p in truth}
        n += 1
        row = scores.get(str(query_id))
        if not row:
            continue
        ranked = sorted(row.items(), key=lambda kv: kv[1], reverse=True)
        rel = [1.0 if pid in truth_set else 0.0 for pid, _ in ranked[:k]]
        ideal = [1.0] * min(len(truth_set), k)
        total += ndcg_at_k(rel, ideal, k)
    return total / max(n, 1)


def evaluate_submission(
    rows: dict[str, list[str]], answers: dict[str, list], k: int = 5
) -> float:
    """Mean nDCG@k of fixed top-k rows (submission.csv form)."""
    total = 0.0
    n = 0
    for query_id, truth in answers.items():
        truth_set = {str(p) for p in truth}
        n += 1
        products = rows.get(str(query_id), [])
        rel = [1.0 if pid in truth_set else 0.0 for pid in products[:k]]
        ideal = [1.0] * min(len(truth_set), k)
        total += ndcg_at_k(rel, ideal, k)
    return total / max(n, 1)


def load_answers(path) -> dict[str, list]:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)
