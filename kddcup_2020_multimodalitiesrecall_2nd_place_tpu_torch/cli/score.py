"""Score query-product TSV pairs with one model of the ensemble (the port of
the JAX package's ``scripts/score.py``, same flags for ``--model imagebert_a``
and ``--model lxmert``, same output: ``qid\\tpid\\tscore`` rows for
ImageBERT-A; for LXMERT, which tokenizes HF-style, a ``query-id,product-id,score``
CSV). ``KMR_DUAL_CROSS=1`` runs LXMERT's two cross directions as one dual block.

Runs on the card by default (bf16, through the CUDA kernels); ``--device
cpu`` runs the plain versions (f32 by default). Example:

  python -m kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli.score \\
      --model imagebert_a --tsv testB.tsv --labels multimodal_labels.txt \\
      --checkpoint a.npz --out testBscore_imagebert.txt

``--checkpoint`` takes an npz of the JAX package's param tree; without one
the parameters are random (seed 0).
"""

from __future__ import annotations

import argparse
import json
import sys

from .. import VOCAB_PATH
from ..checkpoint import load_npz, params_from_jax
from ..data import Featurizer, load_multimodal_labels
from ..eval import evaluate_scores, load_answers
from ..models import Precision, get_model
from ..parallel import ScoringEngine, ScoringStats, resolve_device, write_scores_csv, write_scores_tsv
from ..tokenization import FullTokenizer


def load_params(path: str | None, spec):
    if path is None:
        print("WARNING: no checkpoint given; using random init (seed 0)", file=sys.stderr)
        return spec.init_params(0)
    if not path.endswith(".npz"):
        raise NotImplementedError(
            "only npz param trees are ported; TF/torch checkpoint import is not yet ported, "
            "see ROADMAP.md"
        )
    tree = load_npz(path)
    if "bert" not in tree:
        raise NotImplementedError("flat TF-variable npz import is not yet ported, see ROADMAP.md")
    return params_from_jax(tree)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", required=True,
                    choices=["imagebert_a", "imagebert_b", "imagebert_c", "lxmert"])
    ap.add_argument("--tsv", required=True, nargs="+")
    ap.add_argument("--labels", required=True, help="multimodal_labels.txt")
    ap.add_argument("--checkpoint", default=None, help="npz of a JAX-package param tree")
    ap.add_argument("--config-overrides", default=None,
                    help='JSON model-config overrides, e.g. \'{"num_hidden_layers": 4}\'')
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--precision", choices=["f32", "bf16"], default=None,
                    help="default: bf16 on cuda, f32 on cpu (f32 on cuda is not yet ported)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--answers", default=None,
                    help="valid_answer.json: report nDCG@5 of this scorer")
    ap.add_argument("--expect-pairs", type=int, default=None,
                    help="fail unless exactly N pairs were scored")
    ap.add_argument("--workers", type=int, default=0,
                    help="host loader worker processes; only 0 (a prefetch thread) is ported")
    args = ap.parse_args(argv)
    if args.workers:
        ap.error("--workers > 0 (multi-process loading) is not yet ported, see ROADMAP.md")

    device = resolve_device(args.device)
    spec = get_model(args.model, overrides=json.loads(args.config_overrides) if args.config_overrides else None)
    tok = FullTokenizer.hf_style(VOCAB_PATH) if args.model == "lxmert" else FullTokenizer.google_style(VOCAB_PATH)
    featurizer = Featurizer(tok, load_multimodal_labels(args.labels))
    params = load_params(args.checkpoint, spec)
    prec = None if args.precision is None else (Precision.f32() if args.precision == "f32" else Precision.bf16())
    engine = ScoringEngine(spec, params, device=device, precision=prec)
    stats = ScoringStats()
    result = engine.score_files(args.tsv, featurizer, args.batch_size, stats=stats)
    if args.expect_pairs is not None and stats.pairs != args.expect_pairs:
        print(
            f"ERROR: scored {stats.pairs} pairs, expected {args.expect_pairs} "
            f"({stats.pipeline.errors} parse errors) -- refusing to write a short score file",
            file=sys.stderr,
        )
        raise SystemExit(3)
    writer = write_scores_csv if args.model == "lxmert" else write_scores_tsv
    writer(result, args.out)
    if args.answers:
        ndcg = evaluate_scores(result, load_answers(args.answers))
        print(json.dumps({"ndcg_at_5": round(ndcg, 6)}))
    print(json.dumps({
        "pairs": stats.pairs,
        "pairs_per_second": round(stats.pairs_per_second, 1),
        "parse_errors": stats.pipeline.errors,
        "device": str(device),
        "out": args.out,
    }))


if __name__ == "__main__":
    main()
