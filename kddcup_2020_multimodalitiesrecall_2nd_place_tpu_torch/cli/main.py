"""The one-shot run: four scorers over a testB TSV, fused into ``submission.csv``
(the port of the JAX package's ``scripts/main.py``, the reference's
``code/main.py``):

  python -m kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli.main \\
      --tsv testB.tsv --labels multimodal_labels.txt \\
      --checkpoint-a ImageBertKDD.ckpt-85002 \\
      --checkpoint-b model_attention_kdd_am_word_match_finetune_valid.ckpt-251 \\
      --checkpoint-lxmert BEST.pth --workdir prediction_result

Each scorer is a ``cli.score`` subprocess: ImageBERT-B, then ImageBERT-C as a
delta of B's file (``--delta-from``: only the sen2forest rows are scored;
``--full-c`` scores them all), ImageBERT-A, and LXMERT (a CSV). C shares B's
checkpoint. ``cli.submission`` then fuses the four files, and the last line
of the output is a JSON summary: each scorer's wall and engine seconds, the
fusion's seconds and the total. Each ``--checkpoint-*`` goes to its scorer as
it is, in any format ``cli.score`` reads: an npz tree or flat-variable npz, a
TF1 bundle prefix (A's ``ImageBertKDD.ckpt-85002``; B's
``…finetune_valid.ckpt-251``, read through its EMA shadows) or a torch
``.pth`` (LXMERT's ``BEST.pth``). A checkpoint left out means random weights
(seed 0), as the scorers do.

The flags are the JAX script's, with one difference: ``--precision`` defaults
to the scorer's own choice, bf16 on the card (where the kernels run) and f32
on the CPU; the JAX script defaults to f32, which on the card would run the
plain f32 route and no kernel. ``--device cuda|cpu`` (default ``cuda``) goes
to every scorer.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from .. import REPO_ROOT

PKG = __package__.rsplit(".", 1)[0]
SCORERS = (
    ("imagebert_b", "testB_score_b.txt", "checkpoint_b"),
    ("imagebert_c", "testB_score_c.txt", "checkpoint_b"),
    ("imagebert_a", "testB_score_a.txt", "checkpoint_a"),
    ("lxmert", "testB_score_lxmert.csv", "checkpoint_lxmert"),
)


def _run(cmd: list[str], what: str) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [str(REPO_ROOT), os.environ.get("PYTHONPATH")]))}
    r = subprocess.run(cmd, text=True, capture_output=True, env=env)
    if r.returncode != 0:
        print(r.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"{what} failed (rc={r.returncode})")
    return r


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tsv", required=True, nargs="+")
    ap.add_argument("--labels", required=True)
    ap.add_argument("--checkpoint-a", default=None, help="ImageBERT-A: npz, or a TF1 bundle prefix")
    ap.add_argument("--checkpoint-b", default=None,
                    help="ImageBERT-B and -C: npz, or a TF1 bundle prefix (its EMA shadows are read)")
    ap.add_argument("--checkpoint-lxmert", default=None, help="LXMERT: npz, or a torch .pth/.pt/.bin")
    ap.add_argument("--workdir", default="prediction_result")
    ap.add_argument("--out", default=None, help="the submission csv (default <workdir>/submission.csv)")
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--precision", choices=["f32", "bf16"], default=None,
                    help="default: the scorer's own, bf16 on cuda (the kernels), f32 on cpu")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--expect-pairs", type=int, default=None,
                    help="fail unless each scorer emits exactly N pairs (testB: 29,005)")
    ap.add_argument("--full-c", action="store_true",
                    help="score the whole TSV for imagebert_c instead of the delta pass over the sen2forest rows "
                         "(the same file; the delta pass runs ~10%% of the rows)")
    ap.add_argument("--answers", default=None, help="valid_answer.json: also report the ensemble's nDCG@5")
    args = ap.parse_args(argv)

    workdir = Path(args.workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    out = Path(args.out) if args.out else workdir / "submission.csv"
    t_start = time.perf_counter()
    breakdown: dict[str, dict] = {}
    score_files: dict[str, Path] = {}
    for model, fname, ckpt_attr in SCORERS:
        dest = workdir / fname
        cmd = [sys.executable, "-m", f"{PKG}.cli.score", "--model", model, "--tsv", *args.tsv,
               "--labels", args.labels, "--out", str(dest), "--batch-size", str(args.batch_size),
               "--device", args.device]
        if args.precision:
            cmd += ["--precision", args.precision]
        ckpt = getattr(args, ckpt_attr)
        if ckpt:
            cmd += ["--checkpoint", ckpt]
        if model == "imagebert_c" and not args.full_c:
            cmd += ["--delta-from", str(score_files["imagebert_b"])]
        if args.expect_pairs is not None:
            cmd += ["--expect-pairs", str(args.expect_pairs)]
        print(f"[main] scoring {model} -> {dest}", file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        r = _run(cmd, f"scorer {model}")
        wall = time.perf_counter() - t0
        report_line = r.stdout.strip().splitlines()[-1]
        print(report_line, flush=True)
        rep = json.loads(report_line)
        # engine seconds: the overlapped loader + device window of score_files,
        # over the pairs the model ran (the delta pass copies the rest from B);
        # wall - engine is process start, checkpoint load and the kernels' load
        scored = rep.get("scored_pairs", rep["pairs"])
        engine_s = scored / rep["pairs_per_second"] if rep["pairs_per_second"] else None
        breakdown[model] = {"wall_s": round(wall, 2), "engine_s": None if engine_s is None else round(engine_s, 2),
                            "pairs_per_second": rep["pairs_per_second"], "scored_pairs": scored,
                            "loader": rep["loader"]}
        score_files[model] = dest

    fuse = [sys.executable, "-m", f"{PKG}.cli.submission", "--scores-b", str(score_files["imagebert_b"]),
            "--scores-c", str(score_files["imagebert_c"]), "--scores-a", str(score_files["imagebert_a"]),
            "--scores-lxmert", str(score_files["lxmert"]), "--out", str(out)]
    if args.answers:
        fuse += ["--answers", args.answers]
    t0 = time.perf_counter()
    r = _run(fuse, "fusion")
    breakdown["fusion"] = {"wall_s": round(time.perf_counter() - t0, 2)}
    if r.stdout.strip():
        print(r.stdout.strip(), flush=True)
    with open(out, encoding="utf-8") as f:
        queries = sum(1 for _ in f) - 1
    print(json.dumps({"submission": str(out), "queries": queries,
                      "total_wall_s": round(time.perf_counter() - t_start, 2), "breakdown": breakdown}), flush=True)


if __name__ == "__main__":
    main()
