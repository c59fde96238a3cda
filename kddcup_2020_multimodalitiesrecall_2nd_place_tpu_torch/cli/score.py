"""Score query-product TSV pairs with one model of the ensemble (the port of
the JAX package's ``scripts/score.py``, same flags and same output:
``qid\\tpid\\tscore`` rows for ``--model imagebert_a``, ``imagebert_b`` and
``imagebert_c``; for ``--model lxmert``, which tokenizes HF-style, a
``query-id,product-id,score`` CSV). ImageBERT-C is ImageBERT-B with the
sen2forest query rewrite; ``--delta-from B.tsv`` scores only the rows the
rewrite changes and copies every other score from ImageBERT-B's file.
``KMR_DUAL_CROSS=1`` runs LXMERT's two cross directions as one dual block;
``KMR_FUSED_LAYER=1`` runs each ImageBERT layer, and each LXMERT x-layer's
self-attention + FFN, as one fused encoder layer.

Runs on the card by default (bf16, through the CUDA kernels of the
"pallas_packed" attention backend); ``--precision f32`` runs the plain f32
route there ("xla", TF32 off), as the JAX engine does; ``--device cpu`` runs
the plain versions (f32 by default). The host loader is the native parser
(``data/native``, built with g++ into ``build/native/`` at first use), on a
prefetch thread. Example:

  python -m kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli.score \\
      --model imagebert_a --tsv testB.tsv --labels multimodal_labels.txt \\
      --checkpoint a.npz --out testBscore_imagebert.txt

``--checkpoint`` takes what the JAX script takes (``checkpoint.load_checkpoint``):
an npz param tree (the JAX package's, or the port's ``step_<N>.npz``,
``best.npz``, ``student_final.npz``), an npz of flat variables, a torch
``.pth``/``.pt``/``.bin`` (LXMERT's ``BEST.pth``), or a TF1 bundle prefix
(ImageBERT-A's ``ImageBertKDD.ckpt-85002``; ImageBERT-B/C's
``…finetune_valid.ckpt-251``, read through its EMA shadows); an orbax
directory raises. Without one the parameters are random (seed 0). A
distilled student's shape comes from the ``student_config.json`` beside the
checkpoint (in it or in its parent directory); ``--config-overrides`` wins
over it.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

from .. import VOCAB_PATH
from ..checkpoint import load_checkpoint
from ..data import Featurizer, load_multimodal_labels
from ..data.tsv import SEN2FOREST_SRC, is_header
from ..ensemble import load_tsv_scores
from ..eval import evaluate_scores, load_answers
from ..models import Precision, get_model
from ..parallel import (
    ScoringEngine,
    ScoringStats,
    resolve_device,
    write_scores_csv,
    write_scores_tsv,
)
from ..tokenization import FullTokenizer


def load_student_overrides(checkpoint: str | None) -> dict | None:
    """The model-config overrides a distilled or depth-changed run saved
    beside its weights (``cli/distill.py`` and ``cli/train.py --layers`` write
    ``student_config.json`` in the run directory): probed in ``<ckpt>/`` and
    in ``<ckpt>/..``, so ``<out>/best.npz`` finds ``<out>/student_config.json``."""
    if not checkpoint:
        return None
    for probe in (Path(checkpoint) / "student_config.json", Path(checkpoint).parent / "student_config.json"):
        if probe.is_file():
            overrides = json.loads(probe.read_text()).get("overrides")
            print(f"[student] config overrides from {probe}: {overrides}", file=sys.stderr)
            return overrides
    return None


def _pair_row(line: str) -> bool:
    """A row both parsers get past their field checks: nine tab-separated
    fields, integer ids, and a positive height, width and box count. A row
    that fails them is a parse error on either loader, never a pair."""
    arr = line.rstrip("\n").split("\t")
    if len(arr) < 9:
        return False
    try:
        _, h, w, n, _ = (int(arr[i]) for i in (0, 1, 2, 3, 8))
    except ValueError:
        return False
    return min(h, w, n) > 0


def rewritten_rows(tsv_paths, out_path) -> tuple[int, int]:
    """Copy the rows the sen2forest rewrite changes into out_path -> (rows
    copied, pair rows seen). The trigger holds spaces, which the base64
    columns cannot, so a substring test on the raw line is exact."""
    matched = tsv_rows = 0
    with open(out_path, "w", encoding="utf-8") as tmp:
        for path in tsv_paths:
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    if is_header(line) or not _pair_row(line):
                        continue
                    tsv_rows += 1
                    if SEN2FOREST_SRC in line:
                        tmp.write(line if line.endswith("\n") else line + "\n")
                        matched += 1
    return matched, tsv_rows


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", required=True,
                    choices=["imagebert_a", "imagebert_b", "imagebert_c", "lxmert"])
    ap.add_argument("--tsv", required=True, nargs="+")
    ap.add_argument("--labels", required=True, help="multimodal_labels.txt")
    ap.add_argument("--checkpoint", default=None,
                    help="npz param tree or flat-variable npz, torch .pth/.pt/.bin, or a TF1 bundle prefix")
    ap.add_argument("--config-overrides", default=None,
                    help='JSON model-config overrides, e.g. a distilled student\'s shape \'{"num_hidden_layers": 4}\' '
                         '(read from student_config.json beside --checkpoint when absent)')
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--precision", choices=["f32", "bf16"], default=None,
                    help="default: bf16 on cuda (the kernels), f32 on cpu; f32 on cuda runs plain f32 products")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--answers", default=None,
                    help="valid_answer.json: report nDCG@5 of this scorer")
    ap.add_argument("--expect-pairs", type=int, default=None,
                    help="fail unless exactly N pairs were scored")
    ap.add_argument("--delta-from", default=None,
                    help="ImageBERT-C as a delta: the ImageBERT-B score file of the SAME tsv and "
                         "checkpoint; only rows containing 'sen department of' are scored, every "
                         "other score is copied from it. Only with --model imagebert_c.")
    args = ap.parse_args(argv)
    if args.delta_from is not None and args.model != "imagebert_c":
        ap.error("--delta-from is only meaningful for --model imagebert_c (C == B + sen2forest rewrite)")

    device = resolve_device(args.device)
    stats = ScoringStats()
    tsv_paths = list(args.tsv)
    delta_base = delta_tmp = None
    matched = 0
    if args.delta_from is not None:
        delta_base = load_tsv_scores(args.delta_from)
        base_pairs = sum(len(r) for r in delta_base.values())
        with tempfile.NamedTemporaryFile("w", suffix=".tsv", delete=False, encoding="utf-8") as tmp:
            delta_tmp = tmp.name
        matched, tsv_rows = rewritten_rows(tsv_paths, delta_tmp)
        if base_pairs != tsv_rows:
            Path(delta_tmp).unlink(missing_ok=True)
            print(f"ERROR: --delta-from file has {base_pairs} pairs but the tsv has {tsv_rows} rows; "
                  f"the B score file must come from the SAME tsv", file=sys.stderr)
            raise SystemExit(4)
        print(f"[delta] {matched} rewritten rows to rescore; {base_pairs} pairs copied from B", file=sys.stderr)
        tsv_paths = [delta_tmp]

    try:
        if delta_base is not None and matched == 0:
            # no query holds the trigger: C's score file IS B's, bit for bit
            result = delta_base
        else:
            overrides = (json.loads(args.config_overrides) if args.config_overrides
                         else load_student_overrides(args.checkpoint))
            spec = get_model(args.model, overrides=overrides)
            tok = (FullTokenizer.hf_style(VOCAB_PATH) if args.model == "lxmert"
                   else FullTokenizer.google_style(VOCAB_PATH))
            featurizer = Featurizer(tok, load_multimodal_labels(args.labels), sen2forest=spec.sen2forest)
            params = load_checkpoint(args.model, args.checkpoint, spec)
            prec = None if args.precision is None else (
                Precision.f32() if args.precision == "f32" else Precision.bf16())
            engine = ScoringEngine(spec, params, device=device, precision=prec)
            result = engine.score_files(tsv_paths, featurizer, args.batch_size, stats=stats)
            if delta_base is not None:
                for qid, row in result.items():
                    for pid, s in row.items():
                        if qid not in delta_base or pid not in delta_base[qid]:
                            print(f"ERROR: rewritten pair ({qid}, {pid}) absent from --delta-from file; "
                                  f"the B score file must come from the SAME tsv", file=sys.stderr)
                            raise SystemExit(4)
                        delta_base[qid][pid] = s
                result = delta_base
    finally:
        if delta_tmp is not None:
            Path(delta_tmp).unlink(missing_ok=True)

    total_pairs = sum(len(r) for r in result.values()) if delta_base is not None else stats.pairs
    if args.expect_pairs is not None and total_pairs != args.expect_pairs:
        print(
            f"ERROR: scored {total_pairs} pairs, expected {args.expect_pairs} "
            f"({stats.pipeline.errors} parse errors) -- refusing to write a short score file",
            file=sys.stderr,
        )
        raise SystemExit(3)
    writer = write_scores_csv if args.model == "lxmert" else write_scores_tsv
    writer(result, args.out)
    if args.answers:
        ndcg = evaluate_scores(result, load_answers(args.answers))
        print(json.dumps({"ndcg_at_5": round(ndcg, 6)}))
    report = {
        "pairs": total_pairs,
        "pairs_per_second": round(stats.pairs_per_second, 1),
        "parse_errors": stats.pipeline.errors,
        "loader": "native",
        "device": str(device),
        "out": args.out,
    }
    if delta_base is not None:
        report["scored_pairs"] = stats.pairs  # rows run through the model
    print(json.dumps(report))


if __name__ == "__main__":
    main()
