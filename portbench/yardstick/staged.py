"""ImageBERT-A batches made in host memory, featurized already: the queries,
boxes and labels of the testB-like generator (``testb.py``) laid out as the
scorer reads them (20 query ids, 10 feature rows zero-padded, 10 x 8 label
ids), for the paths that score batches a caller holds (the cascade's rerank,
a live teacher). Every seed draws the same multiset of box counts and the
same queries, in another order."""

from __future__ import annotations

import numpy as np

from .packed import spread
from .testb import FEATURE_DIM, LABEL_TEXTS, query_text

MAX_QUERY_LEN, MAX_BOXES, LABEL_TOKENS = 20, 10, 8


def make_batches(traffic: dict, seed: int, query_ids, label_lut) -> list[dict]:
    """``query_ids``: text -> [CLS] + pieces + [SEP] ids; ``label_lut``: [labels, 8] ids."""
    n_batches, size = int(traffic["batches"]), int(traffic["batch_size"])
    n = n_batches * size
    rng = np.random.default_rng(seed)
    n_q = max(1, round(n / traffic["pairs_per_query"]))
    qid = rng.permutation(np.arange(n) * n_q // n)
    ids = np.zeros((n_q, MAX_QUERY_LEN), np.int32)
    for q in range(n_q):
        row = query_ids(query_text(q))[:MAX_QUERY_LEN]
        ids[q, : len(row)] = row
    boxes = rng.permutation(spread(n, int(traffic["min_boxes"]), int(traffic["max_boxes"])))
    valid = np.arange(MAX_BOXES)[None, :] < boxes[:, None]
    feats = rng.standard_normal((n, MAX_BOXES, FEATURE_DIM), dtype=np.float32)
    feats *= valid[..., None]
    labels = rng.integers(0, len(LABEL_TEXTS), size=(n, MAX_BOXES))
    label_ids = (label_lut[labels] * valid[..., None]).astype(np.int32)
    pid = 400000 + rng.permutation(n)
    out = []
    for b in range(n_batches):
        s = slice(b * size, (b + 1) * size)
        out.append({"input_ids": ids[qid[s]], "segment_ids": np.zeros((size, MAX_QUERY_LEN), np.int32),
                    "features": feats[s], "label_ids": label_ids[s], "labels": np.zeros(size, np.int32),
                    "product_id": pid[s].astype(np.int64), "query_id": qid[s].astype(np.int64),
                    "valid": np.ones(size, np.bool_)})
    return out
