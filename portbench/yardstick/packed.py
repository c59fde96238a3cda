"""ImageBERT-B training instances drawn in bulk, and the benchmark's copy of
the packed-shard writer and of the epoch shuffle (the port's
``data/packed.py``: one ``.npy`` per (shard, field) and a ``manifest.json``;
an epoch's order is ``default_rng((seed, epoch))``'s permutation of the
shards, then of each shard's rows).

Instances come in pairs, as B's sampler yields them: a positive (a query
and the product it was shown with, label 1) and a negative (another query on
the same image, label 0). Every seed draws the same multiset of query lengths
and box counts, in another order, so every seed gives the same sizes.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .testb import FEATURE_DIM, LABEL_TEXTS

MAX_QUERY_LEN = 20
MAX_BOXES = 10
LABEL_TOKENS = 8
CLS_ID, SEP_ID, FIRST_PIECE_ID = 101, 102, 106
MANIFEST = "manifest.json"


def spread(n: int, lo: int, hi: int) -> np.ndarray:
    """n values covering lo..hi as evenly as n allows (a fixed multiset)."""
    return lo + (np.arange(n) * (hi - lo + 1)) // n


def label_lut(tokenize) -> tuple[np.ndarray, np.ndarray]:
    """-> (ids [labels, 8], uncapped lengths [labels]) of each label text under ``tokenize`` (text -> ids)."""
    ids = np.zeros((len(LABEL_TEXTS), LABEL_TOKENS), np.int32)
    lens = np.zeros((len(LABEL_TEXTS),), np.int32)
    for k, text in LABEL_TEXTS.items():
        tok = tokenize(text)
        ids[int(k), : min(len(tok), LABEL_TOKENS)] = tok[:LABEL_TOKENS]
        lens[int(k)] = len(tok)
    return ids, lens


def make_instances(traffic: dict, seed: int, vocab_size: int, lut: tuple[np.ndarray, np.ndarray]) -> dict:
    """-> the fields of B's packed shards for ``traffic["instances"]`` instances."""
    n = int(traffic["instances"])
    if n % 2:
        raise ValueError("instances come in positive/negative pairs")
    rng = np.random.default_rng(seed)
    n_prod = n // 2
    h, w = int(traffic["image_h"]), int(traffic["image_w"])
    q_len = rng.permutation(spread(n, int(traffic["min_query_len"]), int(traffic["max_query_len"])))
    n_box = rng.permutation(spread(n_prod, int(traffic["min_boxes"]), int(traffic["max_boxes"])))
    pos = np.arange(MAX_QUERY_LEN)[None, :]
    ids = rng.integers(FIRST_PIECE_ID, vocab_size, size=(n, MAX_QUERY_LEN)).astype(np.int32)
    ids[:, 0] = CLS_ID
    ids = np.where(pos == (q_len - 1)[:, None], SEP_ID, ids)
    ids = np.where(pos < q_len[:, None], ids, 0).astype(np.int32)
    valid = np.arange(MAX_BOXES)[None, :] < n_box[:, None]  # [products, 10]
    y1 = rng.uniform(0, h / 2, size=(n_prod, MAX_BOXES))
    x1 = rng.uniform(0, w / 2, size=(n_prod, MAX_BOXES))
    y2 = y1 + rng.uniform(1, h / 2, size=(n_prod, MAX_BOXES))
    x2 = x1 + rng.uniform(1, w / 2, size=(n_prod, MAX_BOXES))
    boxes = np.stack([y1 / h, x1 / w, y2 / h, x2 / w, (y2 - y1) * (x2 - x1) / (w * h)], axis=-1)
    boxes = (boxes * valid[..., None]).astype(np.float32)
    feats = rng.standard_normal((n_prod, MAX_BOXES, FEATURE_DIM), dtype=np.float32)
    feats = (feats * valid[..., None]).astype(np.dtype(traffic["feature_dtype"]))
    cls = rng.integers(0, len(LABEL_TEXTS), size=(n_prod, MAX_BOXES))
    lut_ids, lut_lens = lut
    label_ids = (lut_ids[cls] * valid[..., None]).astype(np.int32)
    label_lens = (lut_lens[cls] * valid).astype(np.int32)
    prod = np.repeat(np.arange(n_prod), 2)  # a positive and a negative per product
    pieces = np.maximum(q_len - 2, 0)
    wm_w = (np.arange(MAX_QUERY_LEN - 2)[None, :] < pieces[:, None]).astype(np.float32)
    return {
        "input_ids": ids,
        "len_query": q_len.astype(np.int32),
        "num_boxes": n_box[prod].astype(np.int32),
        "segment_ids": np.broadcast_to(np.array([0] * MAX_QUERY_LEN + [1] * MAX_BOXES, np.int32),
                                       (n, MAX_QUERY_LEN + MAX_BOXES)).copy(),
        "boxes": boxes[prod],
        "features": feats[prod],
        "label_ids": label_ids[prod],
        "label_lens": label_lens[prod],
        "labels": np.tile(np.array([1, 0], np.int32), n_prod),
        "product_id": (300000 + prod).astype(np.int64),
        "query_id": rng.integers(0, 500, size=n).astype(np.int64),
        "word_match_labels": (rng.random((n, MAX_QUERY_LEN - 2)) < 0.5).astype(np.int32),
        "word_match_weights": wm_w,
    }


def write_shards(fields: dict, out_dir, shard_size: int) -> dict:
    """The fields as packed shards of ``shard_size`` rows; -> the manifest."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    n = len(fields["labels"])
    sizes = []
    for idx, start in enumerate(range(0, n, shard_size)):
        stop = min(start + shard_size, n)
        for key, arr in fields.items():
            np.save(out / f"shard_{idx:05d}.{key}.npy", arr[start:stop])
        sizes.append(stop - start)
    manifest = {
        "version": 1,
        "num_instances": n,
        "shard_sizes": sizes,
        "fields": {k: {"dtype": str(v.dtype), "shape": list(v.shape[1:])} for k, v in fields.items()},
        "feature_dtype": str(fields["features"].dtype),
    }
    (out / MANIFEST).write_text(json.dumps(manifest, indent=1))
    return manifest


def epoch_rows(shard_sizes: list[int], seed: int, epoch: int) -> np.ndarray:
    """Global row indices of one epoch in the order its batches take them."""
    rng = np.random.default_rng((seed, epoch))
    starts = np.concatenate([[0], np.cumsum(shard_sizes)])
    parts = []
    for si in rng.permutation(len(shard_sizes)):
        parts.append(starts[si] + rng.permutation(shard_sizes[si]))
    return np.concatenate(parts)
