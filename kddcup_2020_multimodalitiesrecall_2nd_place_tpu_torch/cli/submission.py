"""Fuse four score files into the top-5 submission (the port of the JAX
package's ``scripts/submission.py``, the reference's ``code/main.py``):

  python -m kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli.submission \\
      --scores-b testB_score_b.txt --scores-c testB_score_c.txt \\
      --scores-a testB_score_a.txt --scores-lxmert testB_score_lxmert.csv \\
      --out submission.csv

Single-scorer mode (the testA direct-submission flow,
``run_pretraining_predict.py:585-598``: top-5 straight from one score file,
no fusion and no dedup filter):

  python -m kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli.submission \\
      --single testAscore_imagebert.txt --out sub.csv

The fusion runs on the host (``ensemble/fusion.py``); it is a few
milliseconds at testB's 29k pairs.
"""

from __future__ import annotations

import argparse

from ..ensemble import build_submission, load_csv_scores, load_tsv_scores, single_model_top5, write_submission
from ..eval import evaluate_submission, load_answers


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--single", default=None, metavar="SCORES",
                    help="one score file (.csv with a header, or qid\\tpid\\tscore tsv) -> direct top-5, no fusion")
    ap.add_argument("--scores-b")
    ap.add_argument("--scores-c")
    ap.add_argument("--scores-a")
    ap.add_argument("--scores-lxmert")
    ap.add_argument("--out", required=True)
    ap.add_argument("--answers", default=None, help="valid_answer.json: also report nDCG@5")
    args = ap.parse_args(argv)

    if args.single:
        load = load_csv_scores if args.single.endswith(".csv") else load_tsv_scores
        rows = single_model_top5(load(args.single))
        write_submission(rows, args.out)
    else:
        missing = [n for n in ("scores_b", "scores_c", "scores_a", "scores_lxmert") if getattr(args, n) is None]
        if missing:
            ap.error(f"either --single or all four --scores-* files are required (missing: {', '.join(missing)})")
        rows = build_submission(args.scores_b, args.scores_c, args.scores_a, args.scores_lxmert,
                                out_path=args.out)
    print(f"wrote {len(rows)} queries -> {args.out}")
    if args.answers:
        print(f"nDCG@5 = {evaluate_submission(rows, load_answers(args.answers)):.4f}")


if __name__ == "__main__":
    main()
