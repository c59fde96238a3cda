"""Memmapped product catalogs, the port of the JAX package's ``data/catalog.py``
(numpy on the host, the exact top-k on a torch device).

A catalog is stored as ``data/packed.py`` stores training instances: one
``.npy`` per (shard, field), memory-mapped at read time, so recall
(embeddings, ~0.8 GB at 3M x 128 in float16) and the rerank stage (the
products' features) stream from disk with bounded RSS. The format is the JAX
package's byte for byte:

* ``build_catalog``: drain a (product_id, embedding[, features]) stream into
  shards, one shard buffered at a time;
* ``CatalogDataset``: the memmapped reader; ``embedding_chunks()`` yields
  [C, D] slabs for the device, ``rows()`` gathers the rerank features;
* ``recall_chunked``: exact top-k over the catalog, one chunk on the device
  at a time (``models/two_tower.py:top_k_products``), merged into a running
  top-k on the host;
* ``rerank_batch``: a cross-encoder batch in any of the four layouts from
  tokenized queries and catalog rows; ``recall_at_k``: the recall curve.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np

from .featurize import SEGMENT_IDS_B
from .packed import PackedDataset, write_packed_shards
from .tsv import MAX_BOXES, MAX_QUERY_LEN_AB, MAX_QUERY_LEN_L, pad_1d, row_mask

__all__ = ["build_catalog", "CatalogDataset", "recall_chunked", "recall_at_k", "rerank_batch"]


def build_catalog(entries: Iterable[dict], out_dir, shard_size: int = 262_144, embedding_dtype=np.float16,
                  label_tokenizer: str = "google") -> dict:
    """Stream ``{"product_id", "embedding", ...}`` dicts into packed shards ->
    the manifest. Other keys (the rerank features ``boxes/features/label_ids/
    label_lens/num_boxes``) become fields of their own, ``features`` halved to
    float16 by the writer. ``label_tokenizer`` records the WordPiece lineage
    of the stored ``label_ids`` ("google": ImageBERT's, "hf": LXMERT's), which
    the cascade holds against its cross-encoder's."""

    def cast(ex):
        ex = dict(ex)
        ex["embedding"] = np.asarray(ex["embedding"], embedding_dtype)
        return ex

    return write_packed_shards((cast(e) for e in entries), out_dir, shard_size=shard_size,
                               meta={"label_tokenizer": label_tokenizer})


class CatalogDataset(PackedDataset):
    """Memmapped catalog reader (a PackedDataset with embedding helpers)."""

    @property
    def dim(self) -> int:
        return int(self.manifest["fields"]["embedding"]["shape"][0])

    def product_ids(self) -> np.ndarray:
        return np.concatenate([m["product_id"][:] for m in self._maps])

    def embedding_chunks(self, chunk_rows: int = 262_144) -> Iterator[tuple[int, np.ndarray]]:
        """(global start row, [C, D] slab) in order: copies of at most
        ``chunk_rows`` rows, shards split and never joined, so the host holds
        one slab beside the mapped pages."""
        start = 0
        for m in self._maps:
            emb = m["embedding"]
            for lo in range(0, emb.shape[0], chunk_rows):
                yield start + lo, np.array(emb[lo:lo + chunk_rows])
            start += emb.shape[0]

    def rows(self, idx: np.ndarray) -> dict:
        """Arbitrary global rows of every field (the rerank stage's fetch): one
        searchsorted splits them by shard, then one gather per (shard, field)
        in ascending row order; ``features`` come back float32."""
        bounds = np.cumsum([0] + list(self.shard_sizes))
        flat = np.asarray(idx, np.int64).reshape(-1)
        shard_of = np.searchsorted(bounds, flat, side="right") - 1
        local = flat - bounds[shard_of]
        batch: dict[str, np.ndarray] = {}
        for f in self.fields:
            m0 = self._maps[0][f]
            dest = np.empty((flat.shape[0], *m0.shape[1:]), m0.dtype)
            for s, m in enumerate(self._maps):
                sel = np.nonzero(shard_of == s)[0]
                if sel.size:
                    sel = sel[np.argsort(local[sel], kind="stable")]
                    dest[sel] = m[f][local[sel]]
            batch[f] = dest
        if "features" in batch and batch["features"].dtype != np.float32:
            batch["features"] = batch["features"].astype(np.float32)
        return batch


def recall_chunked(q_emb: np.ndarray, catalog: CatalogDataset, k: int = 5, chunk_rows: int = 262_144,
                   device=None) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k MIPS of q_emb [Q, D] over a memmapped catalog -> (f32 scores
    [Q, k], int64 global rows [Q, k], -1 where the catalog has fewer rows).

    Each float16 [C, D] slab goes to ``device`` (default CUDA), is cast to
    bf16 there and scored by ``top_k_products``; its top-k is merged into the
    host's running [Q, k] by a stable
    argsort, the running one first, so ties go to the lower row. The device
    holds one slab, the host [Q, 2k]."""
    import torch

    from ..models.two_tower import top_k_products
    from ..parallel.engine import resolve_device

    device = resolve_device(device)
    qd = torch.from_numpy(np.asarray(q_emb, np.float32)).to(device)
    best_s = np.full((q_emb.shape[0], k), -np.inf, np.float32)
    best_i = np.full((q_emb.shape[0], k), -1, np.int64)
    for start, slab in catalog.embedding_chunks(chunk_rows):
        c = torch.from_numpy(slab).to(device).to(torch.bfloat16)
        s, i = top_k_products(qd, c, k=min(k, slab.shape[0]), chunk=slab.shape[0])
        merged_s = np.concatenate([best_s, s.float().cpu().numpy()], axis=1)
        merged_i = np.concatenate([best_i, i.cpu().numpy().astype(np.int64) + start], axis=1)
        top = np.argsort(-merged_s, axis=1, kind="stable")[:, :k]
        best_s = np.take_along_axis(merged_s, top, axis=1)
        best_i = np.take_along_axis(merged_i, top, axis=1)
    return best_s, best_i


def rerank_batch(model_name: str, q_ids_list: list, query_ids: np.ndarray, rows: dict) -> dict:
    """A cross-encoder batch from tokenized queries and catalog rows.

    ``q_ids_list``: per pair, the untruncated [CLS] + pieces + [SEP] ids
    (``Featurizer.query_token_ids``); ``query_ids`` [B]; ``rows``: the
    ``CatalogDataset.rows()`` gather of the same B pairs, a catalog built with
    ``cli/recall.py build --packed --store-features`` (ImageBERT-B's
    featurized boxes [10, 5], features [10, 2048], label_ids [10, 8],
    label_lens [10], num_boxes). Each layout is built as ``Featurizer`` builds
    it from a row, so the scores are those of the TSV path, but for the
    catalog's float16 features, provided the stored ``label_ids`` come from
    the cross-encoder's WordPiece lineage (``cli/cascade.py`` warns
    otherwise)."""
    b = len(q_ids_list)
    if query_ids.shape[0] != b or next(iter(rows.values())).shape[0] != b:
        raise ValueError("q_ids_list, query_ids and rows must agree on B")
    features = rows["features"]
    if features.dtype != np.float32:
        features = features.astype(np.float32)
    label_ids = np.ascontiguousarray(rows["label_ids"], dtype=np.int32)
    boxes = np.ascontiguousarray(rows["boxes"], dtype=np.float32)
    product_id = np.ascontiguousarray(rows["product_id"], dtype=np.int64)
    query_ids = np.asarray(query_ids, dtype=np.int64)

    if model_name == "lxmert":
        num_boxes = np.ascontiguousarray(rows["num_boxes"], dtype=np.int64)
        return {
            "input_ids": np.stack([pad_1d(q, MAX_QUERY_LEN_L) for q in q_ids_list]).astype(np.int32),
            "input_mask": np.stack([row_mask(min(len(q), MAX_QUERY_LEN_L), MAX_QUERY_LEN_L) for q in q_ids_list]),
            "label_ids": label_ids,
            # stored wordpiece ids are never 0 ([PAD]), so the id grid carries its own mask
            "label_mask": (label_ids != 0).astype(np.int32),
            "boxes": boxes[:, :, :4],  # column 4 is ImageBERT's area feature
            "features": features,
            "feats_mask": np.stack([row_mask(min(int(n), MAX_BOXES), MAX_BOXES) for n in num_boxes]).astype(np.float32),
            "labels": np.ones((b,), np.int32),
            "product_id": product_id,
            "query_id": query_ids,
        }

    input_ids = np.stack([pad_1d(q, MAX_QUERY_LEN_AB) for q in q_ids_list]).astype(np.int32)
    if model_name == "imagebert_a":
        return {
            "input_ids": input_ids,
            "segment_ids": np.zeros((b, MAX_QUERY_LEN_AB), np.int32),
            "boxes": boxes,
            "features": features,
            "label_ids": label_ids,
            "labels": np.zeros((b,), np.int32),
            "product_id": product_id,
            "query_id": query_ids,
        }
    if model_name in ("imagebert_b", "imagebert_c"):
        if "label_lens" in rows:
            label_lens = np.ascontiguousarray(rows["label_lens"], np.int32)
        else:
            # a catalog without label_lens: the id grid's lengths, capped at MAX_LABEL_TOKENS
            label_lens = (label_ids != 0).sum(axis=2).astype(np.int32)
        return {
            "input_ids": input_ids,
            "len_query": np.array([len(q) for q in q_ids_list], np.int32),
            "num_boxes": np.ascontiguousarray(rows["num_boxes"], np.int32),
            "segment_ids": np.tile(SEGMENT_IDS_B, (b, 1)),
            "boxes": boxes,
            "features": features,
            "label_ids": label_ids,
            "label_lens": label_lens,
            "labels": np.ones((b,), np.int32),
            "product_id": product_id,
            "query_id": query_ids,
        }
    raise ValueError(f"unknown model {model_name!r}")


def recall_at_k(retrieved_ids: np.ndarray, truth: dict, ks: Iterable[int]) -> dict[int, float]:
    """The recall@K curve: the share of the relevant products (``truth``: query
    row -> product ids) inside each row's top-K of ``retrieved_ids`` [Q, K]
    (-1 = empty)."""
    out = {}
    for k in ks:
        hits = total = 0
        for row, rel in truth.items():
            rel = {int(p) for p in rel}
            if not rel:
                continue
            got = {int(p) for p in retrieved_ids[row, :k] if p >= 0}
            hits += len(rel & got)
            total += len(rel)
        out[int(k)] = hits / max(total, 1)
    return out
