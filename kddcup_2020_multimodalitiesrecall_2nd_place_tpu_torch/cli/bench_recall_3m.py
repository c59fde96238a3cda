"""Catalog-scale recall benchmark: 3M products, memmapped shards, chunked
exact MIPS on one device (the port of the JAX package's
``scripts/bench_recall_3m.py``, the same flags and last line).

A synthetic catalog of unit embeddings is streamed into packed shards one
shard at a time (bounded RSS), each query is a noisy copy of one planted
product, and ``recall_chunked`` scores the whole catalog one [chunk, D] slab
at a time. The last line reports the build and recall seconds, peak RSS and
the recall@K curve against the planted neighbours. ``--check-queries N``
also holds the device's top-K of the first N queries against a float64
numpy oracle on the same bf16 values: every product whose oracle score clears
the K+1-th by more than the f32 sums' error bound must be found, every product
found must score within that bound of the K-th, and each found score within
the bound of its oracle value (``check`` on the last line).

  python -m kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli.bench_recall_3m \\
      --products 3000000 --queries 512 --out-dir /tmp/cat3m --check-queries 64
"""

from __future__ import annotations

import argparse
import json
import resource
import sys
import time
from pathlib import Path

import numpy as np

from ..data import CatalogDataset, recall_at_k, recall_chunked
from ..data.packed import MANIFEST
from ..parallel import resolve_device


def _rss_mb() -> float:
    """This process's peak resident MB (``ru_maxrss``; Linux carries a parent's peak across fork and exec,
    which ``start_rss_mb`` on the last line shows)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def _bf16_values(x: np.ndarray) -> np.ndarray:
    """x rounded to bfloat16 (round to nearest even), as float64."""
    import torch

    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).double().numpy()


def oracle_check(ds: CatalogDataset, queries: np.ndarray, idx: np.ndarray, scores: np.ndarray,
                 chunk_rows: int) -> dict:
    """The device's top-K (``idx``, ``scores`` [Q, K]) of ``queries`` against
    float64 products of the same bf16 values, over the whole catalog. An f32
    sum of D exact bf16 products is within ``D * 2^-24 * |q| |c|`` of the
    exact one; ``eps`` is twice that at the largest norms, a margin for the
    order of the tensor cores' sums."""
    k = idx.shape[1]
    q64 = _bf16_values(queries)  # the device casts the query to the catalog's dtype
    cand_s, cand_i, c_norm = [], [], 0.0
    for start, slab in ds.embedding_chunks(chunk_rows):
        c64 = _bf16_values(slab)
        c_norm = max(c_norm, float(np.linalg.norm(c64, axis=1).max()))
        s = q64 @ c64.T
        keep = min(k + 1, s.shape[1])
        part = np.argpartition(-s, keep - 1, axis=1)[:, :keep]
        cand_s.append(np.take_along_axis(s, part, axis=1))
        cand_i.append(part + start)
    eps = 2.0 * q64.shape[1] * 2.0**-24 * float(np.linalg.norm(q64, axis=1).max()) * c_norm
    cand_s, cand_i = np.concatenate(cand_s, axis=1), np.concatenate(cand_i, axis=1)
    order = np.argsort(-cand_s, axis=1, kind="stable")[:, :k + 1]
    top_s, top_i = np.take_along_axis(cand_s, order, axis=1), np.take_along_axis(cand_i, order, axis=1)
    missed = wrong = off = 0
    worst = 0.0
    for r in range(len(queries)):
        found = {int(i) for i in idx[r]}
        kth, next_ = float(top_s[r, k - 1]), float(top_s[r, k])
        # clear of the K+1-th by more than both sums' errors: the device must rank it in
        missed += sum(int(i) not in found for i, s in zip(top_i[r, :k].tolist(), top_s[r, :k].tolist())
                      if s > next_ + 2 * eps)
        exact = dict(zip(top_i[r].tolist(), top_s[r].tolist()))
        for i, s in zip(idx[r].tolist(), scores[r].tolist()):
            ref = exact.get(i)
            if ref is None:  # outside the oracle's top K+1: its own exact score
                ref = float(q64[r] @ _bf16_values(ds.rows(np.array([i]))["embedding"])[0])
            wrong += int(ref < kth - 2 * eps)
            off += int(abs(s - ref) > eps)
            worst = max(worst, abs(s - ref))
    return {"queries": len(queries), "k": k, "eps": eps, "missed": missed, "wrong": wrong,
            "scores_off_by_more_than_eps": off, "max_abs_score_err": worst,
            "ok": missed == 0 and wrong == 0 and off == 0}


def run(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--products", type=int, default=3_000_000)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--noise", type=float, default=0.18,
                    help="query = normalize(product + noise * gaussian); at d=128 the planted cosine is "
                         "~1/sqrt(1 + noise^2 d): 0.18 puts it ~5 sigma above the random-cosine noise floor")
    ap.add_argument("--ks", default="1,5,20,100,500")
    ap.add_argument("--chunk-rows", type=int, default=262_144)
    ap.add_argument("--shard-size", type=int, default=262_144)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check-queries", type=int, default=0,
                    help="hold the top-K of the first N queries against a float64 oracle (0: no check)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    start_rss = _rss_mb()

    n, d = args.products, args.dim
    rng = np.random.default_rng(args.seed)
    planted_rows = rng.choice(n, size=args.queries, replace=False)

    # ---- build: shard-sized slabs of unit vectors, written whole (np.save of the packed format) ----
    t0 = time.perf_counter()
    queries = np.zeros((args.queries, d), np.float32)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    shard_sizes = []
    row = 0
    while row < n:
        m = min(args.shard_size, n - row)
        slab = rng.standard_normal((m, d)).astype(np.float32)
        slab /= np.linalg.norm(slab, axis=1, keepdims=True)
        hit = (planted_rows >= row) & (planted_rows < row + m)
        queries[hit] = slab[planted_rows[hit] - row]
        i = len(shard_sizes)
        np.save(out / f"shard_{i:05d}.embedding.npy", slab.astype(np.float16))
        np.save(out / f"shard_{i:05d}.product_id.npy", np.arange(row, row + m, dtype=np.int64))
        shard_sizes.append(m)
        row += m
        if len(shard_sizes) % 4 == 0:
            print(f"  built {row}/{n}", file=sys.stderr)
    (out / MANIFEST).write_text(json.dumps({
        "version": 1, "num_instances": n, "shard_sizes": shard_sizes,
        "fields": {"embedding": {"dtype": "float16", "shape": [d]}, "product_id": {"dtype": "int64", "shape": []}},
        "feature_dtype": None,
    }, indent=1))
    build_s = time.perf_counter() - t0
    build_rss = _rss_mb()

    queries += args.noise * rng.standard_normal(queries.shape).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)

    # ---- recall: chunked exact MIPS over the memmap ----
    ds = CatalogDataset(args.out_dir)
    if len(ds) != n:
        raise RuntimeError(f"the catalog holds {len(ds)} products, expected {n}")
    ks = sorted(int(k) for k in args.ks.split(","))
    t0 = time.perf_counter()
    scores, idx = recall_chunked(queries, ds, k=max(ks), chunk_rows=args.chunk_rows, device=device)
    recall_s = time.perf_counter() - t0

    truth = {q: [int(planted_rows[q])] for q in range(args.queries)}  # product_id == row by construction
    curve = recall_at_k(np.where(idx >= 0, idx, -1), truth, ks)
    line = {
        "products": n, "queries": args.queries, "dim": d, "noise": args.noise, "device": str(device),
        "build_s": build_s, "recall_s": recall_s, "scored_pairs_per_s": n * args.queries / recall_s,
        "peak_rss_mb": _rss_mb(), "build_rss_mb": build_rss, "start_rss_mb": start_rss,
        "recall_at_k": {str(k): round(v, 4) for k, v in curve.items()},
    }
    if args.check_queries:
        c = args.check_queries
        t0 = time.perf_counter()
        line["check"] = {**oracle_check(ds, queries[:c], idx[:c], scores[:c], args.chunk_rows),
                         "seconds": time.perf_counter() - t0}
    return line


def main(argv: list[str] | None = None) -> int:
    line = run(argv)
    print(json.dumps(line))
    return 0 if line.get("check", {}).get("ok", True) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
