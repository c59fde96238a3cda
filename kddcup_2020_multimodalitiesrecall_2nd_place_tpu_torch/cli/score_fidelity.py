"""Rank fidelity of one score file against a reference score file, the port
of the JAX package's ``scripts/score_fidelity.py``.

The product of the pipeline is a *ranking* (top-5 per query,
``code/main.py:67-101``), so a serving substitution (a distilled student for
its teacher, a bf16 scorer for the f32 one) is judged by rank agreement, not
by score deltas. One JSON line over the two files' shared queries:

  python -m kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli.score_fidelity \\
      --reference teacher.txt --candidate student.txt

Metrics (k = --k, default 5):
  kendall_tau_mean/min   per-query pairwise order agreement in [-1, 1]
  topk_overlap_mean/min  |top-k(ref) & top-k(cand)| / k
  ndcg_delta             1 - nDCG@k(candidate, truth = the reference's top-k)
  ndcg_ref/ndcg_cand     (only with --answers) nDCG@k of each file against
                         the ground truth

Both score formats are read (``qid\\tpid\\tscore`` and LXMERT's
``query-id,product-id,score`` CSV), as the fusion reads them.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..ensemble.fusion import ScoreTable, load_csv_scores, load_tsv_scores
from ..eval.ndcg import evaluate_scores


def _load(path: str) -> ScoreTable:
    return load_csv_scores(path) if path.endswith(".csv") else load_tsv_scores(path)


def compare(ref: ScoreTable, cand: ScoreTable, k: int = 5) -> dict:
    """Rank-fidelity metrics of ``cand`` against ``ref`` over their shared
    queries. Queries absent from either table, and pids absent from ``cand``
    within a shared query, are counted (``missing_*``) and left out of the rank
    metrics: a coverage hole is a data fault, not a fidelity signal."""
    shared = sorted(set(ref) & set(cand))
    taus, overlaps = [], []
    answers = {}
    cand_shared = {}  # the pid universe of tau and overlap: shared pids only
    n_pairs = missing_pairs = 0
    for qid in shared:
        pids = sorted(set(ref[qid]) & set(cand[qid]))
        missing_pairs += len(ref[qid]) - len(pids)
        if len(pids) < 2:
            continue
        a = np.array([ref[qid][p] for p in pids])
        b = np.array([cand[qid][p] for p in pids])
        cand_shared[qid] = {p: cand[qid][p] for p in pids}
        n_pairs += len(pids)
        ii, jj = np.triu_indices(len(pids), 1)
        taus.append(float(np.mean(np.sign(a[ii] - a[jj]) * np.sign(b[ii] - b[jj]))))
        top_a = np.argsort(-a, kind="stable")[:k]
        top_b = np.argsort(-b, kind="stable")[:k]
        overlaps.append(len(set(top_a) & set(top_b)) / min(k, len(pids)))
        answers[qid] = [pids[i] for i in top_a]
    out = {"n_queries": len(shared), "n_pairs": n_pairs, "missing_queries": len(set(ref) - set(cand)),
           "missing_pairs": missing_pairs, "k": k}
    if taus:
        out.update(
            kendall_tau_mean=round(float(np.mean(taus)), 4),
            kendall_tau_min=round(float(np.min(taus)), 4),
            topk_overlap_mean=round(float(np.mean(overlaps)), 4),
            topk_overlap_min=round(float(np.min(overlaps)), 4),
            ndcg_delta=round(1.0 - evaluate_scores(cand_shared, answers, k), 4),
        )
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reference", required=True, help="reference score file (teacher / f32 scorer)")
    ap.add_argument("--candidate", required=True, help="candidate score file (student / bf16 scorer)")
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--answers", default=None,
                    help="optional valid_answer.json: also report each file's nDCG@k against the ground truth")
    args = ap.parse_args(argv)

    ref, cand = _load(args.reference), _load(args.candidate)
    out = compare(ref, cand, args.k)
    if args.answers:
        answers = json.loads(Path(args.answers).read_text())
        out["ndcg_ref"] = round(evaluate_scores(ref, answers, args.k), 4)
        out["ndcg_cand"] = round(evaluate_scores(cand, answers, args.k), 4)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
