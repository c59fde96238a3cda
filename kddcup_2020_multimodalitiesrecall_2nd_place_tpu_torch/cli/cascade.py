"""Recall -> cross-encoder cascade, the two-stage retrieval pipeline (the port
of the JAX package's ``scripts/cascade.py``, the same flags and outputs):

  1. embed every catalog product with the two-tower product tower,
  2. embed each distinct query with the query tower,
  3. exact top-K MIPS recall on the device (``models/two_tower.py``),
  4. rescore the K candidates of each query with a cross-encoder of the
     ensemble (``ScoringEngine``) and write the top 5 per query.

With ``--answers`` it also reports recall@K of stage 1 and nDCG@5 of the
cascade's output, as its last line.

  python -m kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli.cascade \\
      --queries valid.tsv --catalog catalog.tsv --labels multimodal_labels.txt \\
      --tower-checkpoint tower/step_1000.npz --cross-model imagebert_b --cross-checkpoint b.npz \\
      --k-recall 50 --out cascade.csv --answers valid_answer.json

A TSV catalog is held in memory for the rerank stage (~85 KB a product, fine
to ~100k products). At the 3M-product scale pass one packed catalog directory
(``cli/recall.py build --packed --store-features``): no re-embedding, the
recall one memmapped chunk at a time on the device
(``data/catalog.py:recall_chunked``, ``--chunk-rows``), and only the recalled
candidates' features gathered from the memmap (``CatalogDataset.rows`` and
``rerank_batch``); a catalog whose stored ``label_ids`` come from another
WordPiece lineage than the cross-encoder's is scored with a warning.

Runs on the card by default (the towers and the cross-encoder in bf16 on the
kernels); ``--precision f32`` runs the cross-encoder in f32, and ``--device
cpu`` runs the plain versions in f32. ``--tower-checkpoint`` is a two-tower
npz tree; ``--cross-checkpoint`` any format ``cli/score.py`` reads; each is
random (seed 0) when omitted.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

from .. import VOCAB_PATH
from ..checkpoint import load_checkpoint
from ..data import CatalogDataset, Featurizer, load_multimodal_labels, pad_batch, recall_chunked, rerank_batch
from ..data import stack_examples
from ..data.pipeline import iter_examples
from ..eval import evaluate_scores, load_answers
from ..models import Precision, get_model
from ..models.two_tower import top_k_products
from ..parallel import ScoringEngine, resolve_device
from ..tokenization import FullTokenizer
from .recall import tower_engine


def _examples(paths):
    for path in paths:
        with open(path, "r", encoding="utf-8") as f:
            yield from iter_examples(f)


def main(argv: list[str] | None = None) -> dict:
    """Run the cascade -> its report: the metrics line's numbers (with
    ``--answers``), the query and pair counts, and the rerank scores
    ({query id: {product id: score}})."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--queries", required=True, nargs="+",
                    help="TSV(s) whose rows give the query set (deduplicated by query_id) and, with --answers, "
                         "the evaluation")
    ap.add_argument("--catalog", required=True, nargs="+",
                    help="TSV(s) whose rows give the product catalog (deduplicated by product_id), or one packed "
                         "catalog directory of `cli/recall.py build --packed --store-features` (memmapped, no "
                         "re-embedding)")
    ap.add_argument("--chunk-rows", type=int, default=262_144, help="recall chunk size for packed catalogs")
    ap.add_argument("--labels", required=True)
    ap.add_argument("--tower-checkpoint", default=None)
    ap.add_argument("--cross-model", default="imagebert_b",
                    choices=["imagebert_a", "imagebert_b", "imagebert_c", "lxmert"])
    ap.add_argument("--cross-checkpoint", default=None,
                    help="the cross-encoder's checkpoint (random init if omitted: smoke tests only)")
    ap.add_argument("--k-recall", type=int, default=50)
    ap.add_argument("--k-out", type=int, default=5)
    ap.add_argument("--out", required=True)
    ap.add_argument("--answers", default=None, help="valid_answer.json: report recall@K and the cascade's nDCG@5")
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--precision", choices=["f32", "bf16"], default=None,
                    help="the cross-encoder's rerank precision (default: bf16 on cuda, f32 on cpu)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    packed_dir = Path(args.catalog[0]) if len(args.catalog) == 1 and Path(args.catalog[0]).is_dir() else None
    towers = tower_engine(args.tower_checkpoint, device)
    cross_spec = get_model(args.cross_model)
    tok = (FullTokenizer.hf_style(VOCAB_PATH) if args.cross_model == "lxmert"
           else FullTokenizer.google_style(VOCAB_PATH))
    labels = load_multimodal_labels(args.labels)
    fz = Featurizer(tok, labels, sen2forest=cross_spec.sen2forest)
    tower_fz = Featurizer(FullTokenizer.google_style(VOCAB_PATH), labels)

    def embed_all(side: str, exs) -> np.ndarray:
        """The unit embeddings of ``exs``, in batches of --batch-size (the tail padded)."""
        out = []
        for i in range(0, len(exs), args.batch_size):
            chunk = [tower_fz.imagebert_b(ex) for ex in exs[i:i + args.batch_size]]
            b = pad_batch(stack_examples(chunk), args.batch_size)
            out.append(towers.embed(side, b).cpu().numpy()[:len(chunk)])
        return np.concatenate(out, axis=0)

    # ---- stage 1a: the catalog's embeddings (the product tower) -------------
    if packed_dir is not None:
        ds = CatalogDataset(packed_dir)
        if "features" not in ds.fields:
            raise SystemExit(f"{packed_dir} has no rerank features; rebuild with "
                             "`cli/recall.py build --packed --store-features`")
        want_lineage = "hf" if args.cross_model == "lxmert" else "google"
        have_lineage = ds.manifest.get("label_tokenizer", "google")
        if have_lineage != want_lineage:
            # the lineages differ on never-split literals ('[UNK]' etc.) and >100-char words in label text
            print(f"WARNING: catalog label_ids use the {have_lineage!r} tokenizer lineage but {args.cross_model} "
                  f"featurizes with {want_lineage!r}; scores may differ from the TSV path for labels containing "
                  "never-split tokens or >100-char words", file=sys.stderr)
        product_ids = ds.product_ids()
        n_catalog = len(ds)
        print(f"catalog: {n_catalog} products (memmapped)", file=sys.stderr)
    else:
        products: dict[int, object] = {}
        for ex in _examples(args.catalog):
            products.setdefault(ex.product_id, ex)
        product_exs = list(products.values())
        product_ids = np.array([ex.product_id for ex in product_exs])
        catalog = torch.from_numpy(embed_all("product", product_exs)).to(device).to(torch.bfloat16)
        n_catalog = catalog.shape[0]
        print(f"catalog: {n_catalog} products", file=sys.stderr)

    # ---- stage 1b: the query embeddings and the recall ----------------------
    queries: dict[int, object] = {}
    for ex in _examples(args.queries):
        queries.setdefault(ex.query_id, ex)
    query_exs = list(queries.values())
    query_ids = np.array([ex.query_id for ex in query_exs])
    q_emb = embed_all("query", query_exs)
    k = min(args.k_recall, n_catalog)
    if packed_dir is not None:
        _, top_idx = recall_chunked(q_emb, ds, k=k, chunk_rows=args.chunk_rows, device=device)
    else:
        top_idx = top_k_products(torch.from_numpy(q_emb).to(device), catalog, k=k)[1].cpu().numpy()
    print(f"recalled top-{k} for {len(query_exs)} queries", file=sys.stderr)

    # ---- stage 2: the cross-encoder's rerank --------------------------------
    prec = None if args.precision is None else (Precision.f32() if args.precision == "f32" else Precision.bf16())
    engine = ScoringEngine(cross_spec, load_checkpoint(args.cross_model, args.cross_checkpoint, cross_spec),
                           device=device, precision=prec)
    scores: dict[str, dict[str, float]] = {}
    pairs = 0
    if packed_dir is not None:
        # the memmap path: only the recalled candidates' features, the layout rebuilt in bulk
        pair_qrows, pair_cols = np.nonzero(top_idx >= 0)
        pair_idx = top_idx[pair_qrows, pair_cols]
        q_ids_cache = {int(r): fz.query_token_ids(query_exs[int(r)]) for r in np.unique(pair_qrows)}
        for i in range(0, len(pair_idx), args.batch_size):
            qrows = pair_qrows[i:i + args.batch_size]
            rows = ds.rows(pair_idx[i:i + args.batch_size])
            batch = pad_batch(rerank_batch(args.cross_model, [q_ids_cache[r] for r in qrows], query_ids[qrows], rows),
                              args.batch_size)
            s = engine.score_batch(batch).float().cpu().numpy()[:len(qrows)]
            for j, sc in enumerate(s):
                scores.setdefault(str(query_ids[qrows[j]]), {})[str(int(rows["product_id"][j]))] = float(sc)
            pairs += len(qrows)
    else:
        featurize = fz.for_model(args.cross_model)
        pair_exs, pair_qids, pair_pids = [], [], []
        for row, qex in enumerate(query_exs):
            for idx in top_idx[row]:
                if idx < 0:
                    continue
                pex = product_exs[int(idx)]
                pair_exs.append(dataclasses.replace(pex, query=qex.query, query_id=qex.query_id))
                pair_qids.append(qex.query_id)
                pair_pids.append(pex.product_id)
        for i in range(0, len(pair_exs), args.batch_size):
            chunk = pair_exs[i:i + args.batch_size]
            batch = pad_batch(stack_examples([featurize(ex) for ex in chunk]), args.batch_size)
            s = engine.score_batch(batch).float().cpu().numpy()[:len(chunk)]
            for j, sc in enumerate(s):
                scores.setdefault(str(pair_qids[i + j]), {})[str(pair_pids[i + j])] = float(sc)
        pairs = len(pair_exs)

    # ---- the top k-out a query, and the metrics -----------------------------
    with open(args.out, "w", encoding="utf-8") as f:
        f.write("query-id,product1,product2,product3,product4,product5\n")
        for qid in map(str, query_ids):
            row = sorted(scores.get(qid, {}).items(), key=lambda kv: -kv[1])
            tops = [pid for pid, _ in row[:args.k_out]]
            tops += [""] * (args.k_out - len(tops))  # always k-out product columns, as the header says
            f.write(f"{qid},{','.join(tops)}\n")
    print(f"wrote {args.out}", file=sys.stderr)

    report = {"queries": len(query_exs), "catalog": n_catalog, "pairs": pairs, "scores": scores}
    if args.answers:
        answers = load_answers(args.answers)
        hits = total = 0
        for row, qid in enumerate(query_ids):
            truth = {str(p) for p in answers.get(str(qid), [])}
            if not truth:
                continue
            got = {str(product_ids[i]) for i in top_idx[row] if i >= 0}
            hits += len(truth & got)
            total += len(truth)
        line = {"recall_at_k": round(hits / max(total, 1), 4), "k": k,
                "cascade_ndcg5": round(evaluate_scores(scores, answers), 4)}
        print(json.dumps(line))
        report.update(line)
    return report


if __name__ == "__main__":
    main(sys.argv[1:])
