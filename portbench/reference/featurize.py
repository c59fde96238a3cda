"""TSV rows to ImageBERT-A's inputs, a frozen copy of the reference's
``imagebert_lds/src/load_data_pred.py:94-121``: base64 f32 boxes and features
and i64 class labels; 20 query ids ([CLS] + pieces + [SEP], cut at 20, zero
padded); 10 feature rows, zero padded; each box's label text as at most 8
wordpiece ids, zero rows past the boxes. A row that does not parse is a parse
error, not a pair."""

from __future__ import annotations

import base64

import numpy as np

MAX_QUERY_LEN = 20
MAX_BOXES = 10
LABEL_TOKENS = 8
FEATURE_DIM = 2048


def parse(line: str) -> dict | None:
    arr = line.rstrip("\n").split("\t")
    try:
        pid, h, w, n, qid = int(arr[0]), int(arr[1]), int(arr[2]), int(arr[3]), int(arr[8])
        if min(h, w, n) <= 0:
            return None
        feats = np.frombuffer(base64.b64decode(arr[5]), np.float32).reshape(n, FEATURE_DIM)
        labels = np.frombuffer(base64.b64decode(arr[6]), np.int64).reshape(n)
    except (ValueError, IndexError):
        return None
    return {"product_id": pid, "query_id": qid, "query": arr[7], "features": feats, "class_labels": labels}


def imagebert_a_inputs(rows: list[dict], tokenizer, label_texts: dict[str, str]) -> dict[str, np.ndarray]:
    b = len(rows)
    ids = np.zeros((b, MAX_QUERY_LEN), np.int64)
    feats = np.zeros((b, MAX_BOXES, FEATURE_DIM), np.float32)
    label_ids = np.zeros((b, MAX_BOXES, LABEL_TOKENS), np.int64)
    for i, r in enumerate(rows):
        q = tokenizer.query_ids(r["query"])[:MAX_QUERY_LEN]
        ids[i, : len(q)] = q
        n = min(len(r["features"]), MAX_BOXES)
        feats[i, :n] = r["features"][:n]
        for j, c in enumerate(r["class_labels"][:MAX_BOXES]):
            tok = tokenizer.pieces(label_texts[str(int(c))])[:LABEL_TOKENS]
            label_ids[i, j, : len(tok)] = tok
    return {"input_ids": ids, "features": feats, "label_ids": label_ids}
