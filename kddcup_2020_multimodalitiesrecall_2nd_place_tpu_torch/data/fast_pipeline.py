"""Vectorised host pipeline: the native parser + numpy batch assembly (the
port of the JAX package's ``data/fast_pipeline.py``).

The per-example Python path (``pipeline.py``) is the readable reference;
this path feeds the card at a higher rate:

* the files are cut into line-aligned byte spans (``chunk_spans``), which a
  pool of threads reads, decodes with the C++ library into dense arrays
  (``native/preproc.cpp``) and featurizes, a bounded few spans ahead of the
  batches,
* box-label token ids come from a precomputed [num_label_ids, 8] lookup
  table (one gather instead of per-box tokenizer calls),
* queries are tokenized once per *unique* string of a span (testB has ~500
  unique queries across 29k rows), after the sen2forest rewrite where the
  featurizer has it (ImageBERT-C).

It yields the same fixed-shape batches as ``Featurizer``, bit for bit
(``tests/test_torch_native.py``), so an engine may take either.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import os
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np

from ..utils.observability import span
from .featurize import SEGMENT_IDS_B, Featurizer, pad_batch
from .native import parse_pairs_native
from .tsv import MAX_BOXES, MAX_LABEL_TOKENS, MAX_QUERY_LEN_AB, MAX_QUERY_LEN_L, rewrite_sen2forest

SPAN_BYTES = 8 << 20  # ~140 testB-sized rows; measured against 4-32 MB on the card's host (PERF.md §6)
LOADER_THREADS = max(1, min(8, os.cpu_count() or 1) - 1)  # the main thread, which drives the card, keeps a core


def build_label_lut(featurizer: Featurizer) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (ids [max_label+1, 8] i32, mask [.., 8] i32, lens [..] i32 uncapped)."""
    keys = [int(k) for k in featurizer.label_texts]
    size = max(keys) + 1
    ids = np.zeros((size, MAX_LABEL_TOKENS), np.int32)
    mask = np.zeros((size, MAX_LABEL_TOKENS), np.int32)
    lens = np.zeros((size,), np.int32)
    for k in keys:
        tok = featurizer.label_token_ids(k)
        n = min(len(tok), MAX_LABEL_TOKENS)
        ids[k, :n] = tok[:n]
        mask[k, :n] = 1
        lens[k] = len(tok)  # uncapped, like len_class_labels in the reference
    return ids, mask, lens


def _tokenize_queries(featurizer: Featurizer, queries: list[str], max_len: int) -> tuple[np.ndarray, np.ndarray]:
    """-> (ids [N, max_len] i32, lens [N] i32), one tokenize per unique query."""
    cache: dict[str, tuple[np.ndarray, int]] = {}
    out = np.zeros((len(queries), max_len), np.int32)
    lens = np.zeros((len(queries),), np.int32)
    for i, q in enumerate(queries):
        if featurizer.sen2forest:
            q = rewrite_sen2forest(q)
        hit = cache.get(q)
        if hit is None:
            ids = featurizer.tokenizer.encode_query(q)
            row = np.zeros((max_len,), np.int32)
            row[: min(len(ids), max_len)] = ids[:max_len]
            hit = cache[q] = (row, len(ids))
        out[i] = hit[0]
        lens[i] = hit[1]
    return out, lens


def featurize_raw(raw: dict, featurizer: Featurizer, layout: str, label_lut=None) -> dict[str, np.ndarray]:
    """Native-parser output -> the featurized arrays of a model layout (the
    fields of the per-example ``Featurizer`` path, unsliced), one per byte
    span; ``rebatch`` slices it. ``layout`` is the featurizer layout
    (``imagebert_c`` is ``imagebert_b``'s, its rewrite the featurizer's flag).
    ``label_lut`` is ``build_label_lut(featurizer)``, built here if not given
    (a caller that featurizes many spans builds it once)."""
    n = len(raw["product_id"])
    label_lut, label_mask_lut, label_lens_lut = label_lut if label_lut is not None else build_label_lut(featurizer)
    clipped = np.clip(raw["class_labels"], 0, len(label_lut) - 1)
    box_valid = np.arange(MAX_BOXES)[None, :] < np.minimum(raw["num_boxes"], MAX_BOXES)[:, None]  # [N, 10]
    # label rows past num_boxes are all-zero ids (the per-example path never
    # writes them; the parser's class_labels pad of 0 is a real label id)
    label_ids = label_lut[clipped] * box_valid[..., None]  # [N, 10, 8]
    max_len = MAX_QUERY_LEN_L if layout == "lxmert" else MAX_QUERY_LEN_AB
    q_ids, q_lens = _tokenize_queries(featurizer, raw["queries"], max_len)

    if layout in ("imagebert_a", "imagebert_b", "imagebert_c"):
        full: dict[str, np.ndarray] = {
            "input_ids": q_ids,
            "boxes": raw["boxes5"],
            "features": raw["features"],
            "label_ids": label_ids,
            "labels": np.zeros((n,), np.int32) if layout == "imagebert_a" else np.ones((n,), np.int32),
            "product_id": raw["product_id"],
            "query_id": raw["query_id"],
        }
        if layout == "imagebert_a":
            full["segment_ids"] = np.zeros((n, MAX_QUERY_LEN_AB), np.int32)
        else:
            full["segment_ids"] = np.broadcast_to(SEGMENT_IDS_B, (n, len(SEGMENT_IDS_B))).copy()
            full["len_query"] = q_lens
            full["num_boxes"] = raw["num_boxes"].astype(np.int32)
            full["label_lens"] = label_lens_lut[clipped] * box_valid
        return full
    if layout != "lxmert":
        raise ValueError(f"unknown featurizer layout {layout!r}")
    return {
        "input_ids": q_ids,
        "input_mask": (np.arange(max_len)[None, :] < np.minimum(q_lens, max_len)[:, None]).astype(np.int32),
        "label_ids": label_ids,
        "label_mask": label_mask_lut[clipped] * box_valid[..., None],
        "boxes": raw["boxes4"],
        "features": raw["features"],
        "feats_mask": box_valid.astype(np.float32),
        "labels": np.ones((n,), np.int32),
        "product_id": raw["product_id"],
        "query_id": raw["query_id"],
    }


def chunk_spans(paths, chunk_bytes: int) -> list[tuple[str, int, int]]:
    """Split files into (path, start, end) byte spans at line boundaries. The
    split is a function of (paths, chunk_bytes) alone, never of the worker
    count or the pool's size, which is what makes the loaders' output
    deterministic."""
    spans: list[tuple[str, int, int]] = []
    for path in paths:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            start = 0
            while start < size:
                target = start + chunk_bytes
                if target >= size:
                    end = size
                else:
                    f.seek(target)
                    f.readline()  # on to the next line boundary
                    end = f.tell()
                spans.append((str(Path(path)), start, end))
                start = end
    return spans


def _concat(parts: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    return {k: np.concatenate([p[k] for p in parts], axis=0) for k in parts[0]}


def rebatch(fulls: Iterable[dict], batch_size: int, stats=None) -> Iterator[dict[str, np.ndarray]]:
    """Featurized arrays of consecutive parts (files, or a file's byte spans)
    -> fixed-shape batches whose rows run on across the parts, with one padded
    tail: the batches of the per-example path over the same rows, whatever
    the parts. A batch inside one part is a view of it; a batch that straddles
    parts copies its own rows only. ``stats`` (a ``PipelineStats``) counts the
    batches; span ``loader.batch`` is the assembly of each."""
    carry: list[dict[str, np.ndarray]] = []  # the rows not yet batched, as views of their parts
    rows = 0
    for full in fulls:
        n = len(next(iter(full.values()))) if full else 0
        start = 0
        while n - start >= batch_size - rows:
            take = batch_size - rows
            with span("loader.batch"):
                head = {k: v[start : start + take] for k, v in full.items()}
                batch = pad_batch(_concat([*carry, head]) if carry else head, batch_size)
            carry, rows, start = [], 0, start + take
            if stats is not None:
                stats.batches += 1
            yield batch
        if start < n:
            carry.append({k: v[start:] for k, v in full.items()})
            rows += n - start
    if rows:
        if stats is not None:
            stats.batches += 1
        with span("loader.batch"):
            batch = pad_batch(_concat(carry), batch_size)
        yield batch


def assemble_batches(raw: dict, featurizer: Featurizer, layout: str,
                     batch_size: int) -> Iterator[dict[str, np.ndarray]]:
    """Native-parser output -> model-layout batches (the fields of ``Featurizer``)."""
    return rebatch([featurize_raw(raw, featurizer, layout)], batch_size)


def _load_span(path: str, start: int, end: int, featurizer: Featurizer, layout: str,
               label_lut) -> tuple[dict[str, np.ndarray], int, int]:
    """One byte span read, parsed on this thread and featurized -> (its arrays, rows parsed, parse errors)."""
    with span("loader.read"), open(path, "rb") as f:
        f.seek(start)
        buf = f.read(end - start)
    with span("loader.parse"):
        raw = parse_pairs_native(buf, n_threads=1)
    del buf
    with span("loader.featurize"):
        full = featurize_raw(raw, featurizer, layout, label_lut)
    return full, len(raw["product_id"]), raw["n_errors"]


def native_batches_from_files(paths, featurizer: Featurizer, layout: str, batch_size: int,
                              stats=None) -> Iterator[dict[str, np.ndarray]]:
    """The files cut into line-aligned byte spans of about ``SPAN_BYTES``
    (``chunk_spans``), each read, parsed by the native parser and featurized on
    one pool of ``LOADER_THREADS`` threads, and batched in file order as one
    stream: the batches of the whole files parsed at once, bit for bit. At most
    as many spans as the pool has threads are in flight (submitted and not yet
    handed to ``rebatch``), so a pass's first batch leaves after its first span,
    later spans parse while the caller uses it, and the host memory held is
    bounded by the pool, not by the files.

    ``stats`` (a ``PipelineStats``) counts parsed rows, parse errors and
    batches. Spans ``loader.read``, ``loader.parse`` and ``loader.featurize``
    for each byte span, on the pool's threads. A span's error is raised here;
    closing the generator cancels the spans not yet started and joins the
    pool's threads."""
    spans = iter(chunk_spans(paths, SPAN_BYTES))
    label_lut = build_label_lut(featurizer)
    pool = cf.ThreadPoolExecutor(LOADER_THREADS, thread_name_prefix="kmr-loader")
    ahead: collections.deque[cf.Future] = collections.deque()

    def submit_next() -> None:
        nxt = next(spans, None)
        if nxt is not None:
            ahead.append(pool.submit(_load_span, *nxt, featurizer, layout, label_lut))

    def fulls():
        for _ in range(LOADER_THREADS):
            submit_next()
        while ahead:
            full, parsed, errors = ahead.popleft().result()
            if stats is not None:
                stats.parsed += parsed
                stats.errors += errors
            yield full
            submit_next()

    try:
        yield from rebatch(fulls(), batch_size, stats)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
