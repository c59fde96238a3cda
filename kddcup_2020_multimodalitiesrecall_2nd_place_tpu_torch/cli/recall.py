"""Two-tower retrieval: build a product catalog and run exact top-k recall (the
port of the JAX package's ``scripts/recall.py``, the same subcommands, flags
and outputs).

  # build the catalog (small: one .npz of float16 embeddings and product ids)
  python -m kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli.recall build \\
      --tsv catalog.tsv --labels labels.txt --checkpoint tower.npz --out catalog.npz
  # at 3M-product scale: memmapped packed shards, one shard held at a time (with
  # --store-features, the rerank features beside the embeddings, for cli/cascade.py)
  ... build --tsv catalog.tsv --labels labels.txt --checkpoint tower.npz --out catalog_dir/ --packed
  # top-5 products per query row (--catalog: the .npz or the packed directory,
  # which streams through the device one chunk at a time)
  ... query --tsv queries.tsv --labels labels.txt --checkpoint tower.npz --catalog catalog.npz --out recall.tsv
  # the recall@K curve against valid_answer.json
  ... curve --tsv queries.tsv --labels labels.txt --checkpoint tower.npz --catalog catalog_dir/ \\
      --answers valid_answer.json --ks 5,20,100,500

``--checkpoint``: a two-tower npz param tree (the JAX package's, or the port's
``step_<N>.npz`` of ``cli/train.py --model two_tower``); without one the
towers are random (seed 0). Runs on the card by default: the towers in bf16
on the fused blocks' kernels (``TowerEngine``), the catalog scored in bf16
with f32 sums; ``--device cpu`` runs the plain versions in f32. The tower's
shape follows ``KMR_TOWER_CONFIG_OVERRIDES``, as in the JAX script.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from .. import VOCAB_PATH
from ..checkpoint import load_checkpoint
from ..data import CatalogDataset, Featurizer, batches_from_files, build_catalog, load_multimodal_labels
from ..data import recall_at_k, recall_chunked
from ..eval import load_answers
from ..models import get_model
from ..models.two_tower import top_k_products
from ..parallel import TowerEngine, resolve_device
from ..tokenization import FullTokenizer

BATCH = 512
# the product fields a catalog built with --store-features keeps for the rerank stage
RERANK_FIELDS = ("boxes", "features", "label_ids", "label_lens", "num_boxes")


def tower_engine(checkpoint, device) -> TowerEngine:
    """The towers of ``checkpoint`` (None: random, seed 0) on ``device``, in
    its default precision (bf16 on the card, f32 on the CPU)."""
    spec = get_model("two_tower")
    return TowerEngine(spec, load_checkpoint("two_tower", checkpoint, spec), device=device)


def _setup(args) -> tuple[TowerEngine, Featurizer]:
    engine = tower_engine(args.checkpoint, resolve_device(args.device))
    return engine, Featurizer(FullTokenizer.google_style(VOCAB_PATH), load_multimodal_labels(args.labels))


def _batches(args, fz):
    return batches_from_files([args.tsv], fz.imagebert_b, BATCH)


def cmd_build(args) -> dict:
    engine, fz = _setup(args)

    def entries():
        seen = 0
        for batch in _batches(args, fz):
            e = engine.embed("product", batch).cpu().numpy()
            for row in range(int(batch["valid"].sum())):
                entry = {"product_id": np.int64(batch["product_id"][row]), "embedding": e[row]}
                if args.store_features:
                    entry.update({f: batch[f][row] for f in RERANK_FIELDS})
                yield entry
                seen += 1
                if seen % 100_000 == 0:
                    print(f"  {seen} products embedded", file=sys.stderr)

    if args.packed:
        manifest = build_catalog(entries(), args.out, shard_size=args.shard_size)
        print(f"wrote {args.out}: {manifest['num_instances']} products (packed)")
        return {"products": manifest["num_instances"], "out": args.out}
    embs, pids = [], []
    for entry in entries():
        embs.append(entry["embedding"])
        pids.append(entry["product_id"])
    catalog = np.stack(embs, axis=0).astype(np.float16)
    np.savez(args.out, catalog=catalog, product_ids=np.asarray(pids))
    print(f"wrote {args.out}: {catalog.shape[0]} products x {catalog.shape[1]} dims")
    return {"products": catalog.shape[0], "out": args.out}


def query_embeddings(engine: TowerEngine, batches) -> tuple[np.ndarray, np.ndarray]:
    """(query ids, f32 embeddings) of every valid row of ``batches``."""
    qids, qembs = [], []
    for batch in batches:
        n = int(batch["valid"].sum())
        qembs.append(engine.embed("query", batch).cpu().numpy()[:n])
        qids.extend(batch["query_id"][:n])
    return np.asarray(qids), np.concatenate(qembs, axis=0)


def retrieve(catalog, q_emb: np.ndarray, k: int, chunk_rows: int, device) -> tuple[np.ndarray, np.ndarray,
                                                                                    np.ndarray]:
    """Top-k of ``q_emb`` over a packed directory or an npz catalog -> (scores, rows, the catalog's product ids)."""
    if Path(catalog).is_dir():
        ds = CatalogDataset(catalog)
        scores, idx = recall_chunked(q_emb, ds, k=k, chunk_rows=chunk_rows, device=device)
        return scores, idx, ds.product_ids()
    with np.load(catalog) as data:
        cat = torch.from_numpy(data["catalog"]).to(device).to(torch.bfloat16)
        product_ids = data["product_ids"]
    s, i = top_k_products(torch.from_numpy(q_emb).to(device), cat, k=k)
    return s.cpu().numpy(), i.cpu().numpy(), product_ids


def cmd_query(args) -> dict:
    engine, fz = _setup(args)
    qids, q_emb = query_embeddings(engine, _batches(args, fz))
    _, idx, product_ids = retrieve(args.catalog, q_emb, args.k, args.chunk_rows, engine.device)
    with open(args.out, "w", encoding="utf-8") as out:
        for row, qid in enumerate(qids):
            tops = ",".join(str(product_ids[i]) for i in idx[row] if i >= 0)
            out.write(f"{qid}\t{tops}\n")
    print(f"wrote {args.out}")
    return {"queries": len(qids), "out": args.out}


def cmd_curve(args) -> dict:
    engine, fz = _setup(args)
    qids, q_emb = query_embeddings(engine, _batches(args, fz))
    ks = sorted(int(k) for k in args.ks.split(","))
    _, idx, product_ids = retrieve(args.catalog, q_emb, max(ks), args.chunk_rows, engine.device)
    retrieved = np.where(idx >= 0, product_ids[np.maximum(idx, 0)], -1)
    answers = load_answers(args.answers)
    truth = {row: [int(p) for p in answers.get(str(qid), [])] for row, qid in enumerate(qids)}
    curve = recall_at_k(retrieved, truth, ks)
    line = {"recall_at_k": {str(k): round(v, 4) for k, v in curve.items()}}
    print(json.dumps(line))
    return line


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn in (("build", cmd_build), ("query", cmd_query), ("curve", cmd_curve)):
        sp = sub.add_parser(name)
        sp.add_argument("--tsv", required=True)
        sp.add_argument("--labels", required=True)
        sp.add_argument("--checkpoint", default=None)
        sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
        sp.set_defaults(fn=fn)
        if name == "build":
            sp.add_argument("--out", required=True)
            sp.add_argument("--packed", action="store_true",
                            help="write memmapped packed shards (streaming, bounded RSS) instead of one .npz")
            sp.add_argument("--store-features", action="store_true",
                            help="also store boxes/features/label_ids/label_lens/num_boxes per product "
                                 "(the rerank stage)")
            sp.add_argument("--shard-size", type=int, default=262_144)
        else:
            sp.add_argument("--catalog", required=True, help=".npz file or packed-shard directory")
            sp.add_argument("--chunk-rows", type=int, default=262_144)
            if name == "query":
                sp.add_argument("--out", required=True)
                sp.add_argument("--k", type=int, default=5)
            else:
                sp.add_argument("--answers", required=True)
                sp.add_argument("--ks", default="5,10,50,100")
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
