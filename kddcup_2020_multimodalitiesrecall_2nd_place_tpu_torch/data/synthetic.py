"""Synthetic TSV rows + label dictionaries for tests and benchmarks.

The reference's real train/test TSVs are not redistributable, so tests and
the throughput benchmark fabricate rows with the exact on-disk format
(base64 float32/int64 payloads, see ``tsv.parse_line``).
"""

from __future__ import annotations

import base64
import zlib

import numpy as np

SYNTHETIC_LABELS = {
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

SYNTHETIC_QUERIES = [
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


def query_direction(query: str) -> np.ndarray:
    """Deterministic unit-norm feature direction keyed by the query TEXT
    (the planted signal of ``make_row(planted=...)``). Keyed by text, not
    query id, because the text is all a scorer sees — rows sharing a query
    string must carry the same direction for the signal to be learnable."""
    key = zlib.crc32(query.encode("utf-8"))
    v = np.random.default_rng(key).standard_normal(2048)
    return (v / np.linalg.norm(v)).astype(np.float32)


def make_row(
    rng: np.random.Generator,
    product_id: int,
    query_id: int,
    query: str | None = None,
    num_boxes: int | None = None,
    image_h: int = 800,
    image_w: int = 600,
    planted: float = 0.0,
    planted_query: str | None = None,
) -> str:
    n = int(num_boxes if num_boxes is not None else rng.integers(1, 11))
    y1 = rng.uniform(0, image_h / 2, size=n)
    x1 = rng.uniform(0, image_w / 2, size=n)
    y2 = y1 + rng.uniform(1, image_h / 2, size=n)
    x2 = x1 + rng.uniform(1, image_w / 2, size=n)
    boxes = np.stack([y1, x1, y2, x2], axis=1).astype(np.float32)
    feats = rng.standard_normal((n, 2048), dtype=np.float32)
    labels = rng.integers(0, len(SYNTHETIC_LABELS), size=n).astype(np.int64)
    if query is None:
        query = SYNTHETIC_QUERIES[int(rng.integers(0, len(SYNTHETIC_QUERIES)))]
    if planted:
        # plant a query-keyed direction into every box's features so a
        # trained scorer has REAL structure to learn (pure-noise features
        # make any learned teacher's score surface arbitrary — fine for
        # throughput benches, useless for fidelity demos). Added AFTER all
        # rng draws so planted rows share every other byte with their
        # planted=0 twins (same seed -> same boxes/labels/query).
        # planted_query plants a DIFFERENT query's direction: a mismatched
        # (negative) pair with known ground truth for eval sets.
        feats = feats + planted * query_direction(planted_query or query)[None, :]
    cols = [
        str(product_id),
        str(image_h),
        str(image_w),
        str(n),
        base64.b64encode(boxes.tobytes()).decode("ascii"),
        base64.b64encode(feats.tobytes()).decode("ascii"),
        base64.b64encode(labels.tobytes()).decode("ascii"),
        query,
        str(query_id),
    ]
    return "\t".join(cols)


def make_tsv(
    n_rows: int,
    seed: int = 0,
    header: bool = True,
    n_queries: int | None = None,
    planted: float = 0.0,
) -> list[str]:
    rng = np.random.default_rng(seed)
    lines = []
    if header:
        lines.append(
            "product_id\timage_h\timage_w\tnum_boxes\tboxes\tfeatures"
            "\tclass_labels\tquery\tquery_id"
        )
    n_queries = n_queries or max(1, n_rows // 3)
    for i in range(n_rows):
        qid = int(rng.integers(0, n_queries))
        lines.append(
            make_row(
                rng,
                product_id=100000 + i,
                query_id=qid,
                query=SYNTHETIC_QUERIES[qid % len(SYNTHETIC_QUERIES)],
                planted=planted,
            )
        )
    return lines


def make_eval_tsv(
    n_rows: int,
    seed: int = 0,
    planted: float = 6.0,
    mismatch_rate: float = 0.5,
) -> tuple[list[str], dict[str, list[int]]]:
    """Planted eval set with KNOWN ground truth for ranking metrics.

    Uses the 10 ``SYNTHETIC_QUERIES`` as both query ids and texts (1:1, so
    text-keyed directions never collide across qids). Each row pairs a
    query with features carrying either its OWN planted direction (a true
    match) or another query's (a mismatch), drawn at ``mismatch_rate``.
    Returns ``(tsv_lines, answers)`` where ``answers`` maps qid -> list of
    matching product ids, the same structure as the reference's
    ``valid_answer.json`` — so a scorer's nDCG@5 on this set measures
    whether it actually learned the planted query↔feature alignment.
    """
    rng = np.random.default_rng(seed)
    lines = [
        "product_id\timage_h\timage_w\tnum_boxes\tboxes\tfeatures"
        "\tclass_labels\tquery\tquery_id"
    ]
    answers: dict[str, list[int]] = {}
    n_q = len(SYNTHETIC_QUERIES)
    for i in range(n_rows):
        qid = int(rng.integers(0, n_q))
        query = SYNTHETIC_QUERIES[qid]
        pid = 100000 + i
        if rng.random() < mismatch_rate:
            other = int(rng.integers(0, n_q - 1))
            if other >= qid:
                other += 1  # uniform over queries != qid
            planted_query = SYNTHETIC_QUERIES[other]
        else:
            planted_query = None
            answers.setdefault(str(qid), []).append(pid)
        lines.append(
            make_row(
                rng,
                product_id=pid,
                query_id=qid,
                query=query,
                planted=planted,
                planted_query=planted_query,
            )
        )
    return lines, answers


def make_testb_tsv(n_rows: int, seed: int = 0, pairs_per_query: int = 58, max_queries_per_product: int = 3,
                   reuse: float = 0.4, malformed: int = 1, header: bool = True) -> list[str]:
    """A testB-like TSV: ~``pairs_per_query`` pairs a query (testB: 29,005
    pairs over ~500 queries), each product under 1..``max_queries_per_product``
    queries (with probability ``reuse`` a pair takes a product already shown
    under another query), so the fusion's dedup filter both drops products and
    keeps them at their argmax; a product's row has the same boxes, features
    and labels under every query. A tenth of the query texts hold the
    sen2forest trigger, and ``malformed`` rows fail to parse (a parse error
    to count, not to stop on). Row order: query after query."""
    rng = np.random.default_rng(seed)
    lines = []
    if header:
        lines.append("product_id\timage_h\timage_w\tnum_boxes\tboxes\tfeatures\tclass_labels\tquery\tquery_id")
    n_queries = max(1, round(n_rows / pairs_per_query))
    payload: dict[int, list[str]] = {}  # product -> its image columns (h, w, n, boxes, feats, labels)
    uses: dict[int, int] = {}
    shared: list[int] = []  # products that may be shown under one more query
    next_pid = 200000
    for i in range(n_rows):
        qid = i * n_queries // n_rows
        query = f"{SYNTHETIC_QUERIES[qid % len(SYNTHETIC_QUERIES)]} {qid // len(SYNTHETIC_QUERIES)}"
        pid = None
        if shared and rng.random() < reuse:
            j = int(rng.integers(0, len(shared)))
            if uses[shared[j]] < max_queries_per_product and payload[shared[j]][-1] != str(qid):
                pid = shared[j]
        if pid is None:
            pid = next_pid
            next_pid += 1
            row = make_row(rng, product_id=pid, query_id=qid, query=query).split("\t")
            payload[pid] = row[1:7] + [str(qid)]
            uses[pid] = 0
            shared.append(pid)
        uses[pid] += 1
        payload[pid][-1] = str(qid)  # the last query it went under
        if uses[pid] >= max_queries_per_product:
            shared.remove(pid)
        lines.append("\t".join([str(pid), *payload[pid][:6], query, str(qid)]))
    for k in range(malformed):
        at = int(rng.integers(1 if header else 0, len(lines) + 1))
        lines.insert(at, f"{900000 + k}\tnot-a-height\t600\t1\tAAAA\tAAAA\tAAAA\tbroken row\t{k}")
    return lines
