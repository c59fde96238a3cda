"""A testB-like TSV written in bulk: the benchmark's own copy of the port's
``data/synthetic.py:make_testb_tsv`` and ``make_row``, with the payloads drawn
in a few large numpy calls.

The shape of the file (which rows share a product, each product's box count,
each query's block of rows) comes from a fixed generator, so every seed
gives the same sizes; the seed orders the query blocks and draws every byte
of content (boxes, features, labels, product ids, where the malformed row
sits). A tenth of the query texts hold the sen2forest trigger.

Row format (the KDD Cup files): ``product_id \\t image_h \\t image_w \\t
num_boxes \\t b64(f32 boxes [n, 4]) \\t b64(f32 features [n, 2048]) \\t
b64(i64 labels [n]) \\t query \\t query_id``.
"""

from __future__ import annotations

import base64
from dataclasses import dataclass

import numpy as np

HEADER = "product_id\timage_h\timage_w\tnum_boxes\tboxes\tfeatures\tclass_labels\tquery\tquery_id"
FEATURE_DIM = 2048
STRUCTURE_SEED = 20200529  # fixes the sizes; the run's seed fixes the content and the order

LABEL_TEXTS = {
    "0": "others",
    "1": "dress",
    "2": "shoe  leather",
    "3": "hand bag",
    "4": "book",
    "5": "lamp chandelier",
    "6": "shirt",
    "7": "trousers",
    "8": "hat",
    "9": "watch strap",
}

QUERY_STEMS = [
    "red lace sling dress women summer",
    "sen department of sweet dress",
    "men leather shoe breathable",
    "student school bag large capacity",
    "chandelier living room lamp modern",
    "2019 new white shirt",
    "casual trousers loose",
    "fisherman hat sun protection",
    "watch strap stainless steel",
    "children book early education",
]


def query_text(qid: int) -> str:
    return f"{QUERY_STEMS[qid % len(QUERY_STEMS)]} {qid // len(QUERY_STEMS)}"


@dataclass
class TsvFile:
    path: str
    pairs: int  # rows that parse
    malformed: int  # rows that fail to parse
    offsets: np.ndarray  # [pairs] byte offset of each pair row


def _structure(traffic: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (row query [pairs], row product [pairs], product boxes [products]):
    make_testb_tsv's reuse rule under the fixed generator."""
    rng = np.random.default_rng(STRUCTURE_SEED)
    n_rows = int(traffic["pairs"])
    n_queries = max(1, round(n_rows / traffic["pairs_per_query"]))
    cap, reuse = int(traffic["max_queries_per_product"]), float(traffic["reuse"])
    draws = rng.random(n_rows)
    picks = rng.random(n_rows)
    row_q = np.arange(n_rows) * n_queries // n_rows
    row_p = np.empty(n_rows, np.int64)
    uses: list[int] = []
    last_q: list[int] = []
    shared: list[int] = []
    for i in range(n_rows):
        q = int(row_q[i])
        pid = -1
        if shared and draws[i] < reuse:
            j = int(picks[i] * len(shared))
            if uses[shared[j]] < cap and last_q[shared[j]] != q:
                pid = shared[j]
        if pid < 0:
            pid = len(uses)
            uses.append(0)
            last_q.append(q)
            shared.append(pid)
        uses[pid] += 1
        last_q[pid] = q
        if uses[pid] >= cap:
            shared.remove(pid)
        row_p[i] = pid
    lo, hi = int(traffic["min_boxes"]), int(traffic["max_boxes"])
    boxes = rng.integers(lo, hi + 1, size=len(uses))
    return row_q, row_p, boxes


def write_testb_tsv(path, traffic: dict, seed: int) -> TsvFile:
    row_q, row_p, n_boxes = _structure(traffic)
    rng = np.random.default_rng(seed)
    n_q = int(row_q.max()) + 1
    # the seed orders the query blocks; rows keep their order inside a block
    order = np.argsort(rng.permutation(n_q)[row_q], kind="stable")
    row_q, row_p = row_q[order], row_p[order]
    n_prod = len(n_boxes)
    h, w = int(traffic["image_h"]), int(traffic["image_w"])
    starts = np.concatenate([[0], np.cumsum(n_boxes)])
    total = int(starts[-1])
    y1 = rng.uniform(0, h / 2, size=total)
    x1 = rng.uniform(0, w / 2, size=total)
    boxes = np.stack([y1, x1, y1 + rng.uniform(1, h / 2, size=total), x1 + rng.uniform(1, w / 2, size=total)],
                     axis=1).astype(np.float32)
    feats = rng.standard_normal((total, FEATURE_DIM), dtype=np.float32)
    labels = rng.integers(0, len(LABEL_TEXTS), size=total).astype(np.int64)
    pid_base = 200000 + int(rng.integers(0, 1_000_000))
    payload = []
    for k in range(n_prod):
        a, b = starts[k], starts[k + 1]
        payload.append("\t".join([
            str(h), str(w), str(b - a),
            base64.b64encode(boxes[a:b].tobytes()).decode("ascii"),
            base64.b64encode(feats[a:b].tobytes()).decode("ascii"),
            base64.b64encode(labels[a:b].tobytes()).decode("ascii"),
        ]).encode("ascii"))
    del feats
    n_rows = len(row_q)
    n_bad = int(traffic["malformed"])
    bad_at = set(rng.choice(n_rows + 1, size=n_bad, replace=False).tolist()) if n_bad else set()
    offsets = np.empty(n_rows, np.int64)
    pos = 0
    with open(path, "wb") as f:
        chunk: list[bytes] = []

        def put(line: bytes) -> None:
            nonlocal pos
            chunk.append(line)
            pos += len(line)

        put(HEADER.encode() + b"\n")
        bad = 0
        for i in range(n_rows + 1):
            if i in bad_at:
                put(f"{900000 + bad}\tnot-a-height\t600\t1\tAAAA\tAAAA\tAAAA\tbroken row\t{bad}\n".encode())
                bad += 1
            if i == n_rows:
                break
            q, p = int(row_q[i]), int(row_p[i])
            offsets[i] = pos
            put(b"%d\t%s\t%s\t%d\n" % (pid_base + p, payload[p], query_text(q).encode(), q))
            if len(chunk) >= 256:
                f.write(b"".join(chunk))
                chunk.clear()
        f.write(b"".join(chunk))
    return TsvFile(str(path), n_rows, n_bad, offsets)


def read_rows(path, offsets: np.ndarray) -> list[str]:
    """The pair rows at ``offsets``, as text."""
    out = []
    with open(path, "rb") as f:
        for off in offsets:
            f.seek(int(off))
            out.append(f.readline().decode("utf-8"))
    return out
