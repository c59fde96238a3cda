"""Featurization of decoded TSV rows into fixed-shape numpy arrays.

The three layouts, each identical to the JAX package's ``data/featurize.py``:

* ImageBERT-A (``imagebert_lds``): 20 query ids + 10 box feature tokens +
  10 label tokens, segment ids over the 20 text positions, and **no**
  padding masks (``pixelmodel.py:189-195`` builds an all-ones mask).
* ImageBERT-B/C (``imagebert_zk``): 20 query ids + 10 image tokens; segment
  ids ``[0]*20 + [1]*10``; real length masks from ``len_query``/``num_boxes``
  (``model_triple.py:198-201``); C also rewrites the query text
  (``sen2forest``).
* LXMERT: 23 query ids (+mask), 10x8 label ids (+mask), 4-dim normalised
  boxes, features and a feature mask (``tasks/kdd_data.py:88-108``,
  ``utils.py:23-59``); its queries go through the HF-style tokenizer.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from ..tokenization import FullTokenizer
from .tsv import (
    MAX_BOXES,
    MAX_LABEL_TOKENS,
    MAX_QUERY_LEN_AB,
    MAX_QUERY_LEN_L,
    RawExample,
    pad_1d,
    pad_rows,
    rewrite_sen2forest,
    row_mask,
)

SEGMENT_IDS_B = np.array([0] * MAX_QUERY_LEN_AB + [1] * MAX_BOXES, dtype=np.int32)


class Featurizer:
    """Tokenizes queries and box-label texts into the model layouts;
    ``sen2forest`` rewrites every query first (ImageBERT-C)."""

    def __init__(self, tokenizer: FullTokenizer, label_texts: dict[str, str], sen2forest: bool = False):
        self.tokenizer = tokenizer
        self.label_texts = label_texts
        self.sen2forest = sen2forest
        self._label_ids_cache: dict[int, list[int]] = {}

    def _query_text(self, ex: RawExample) -> str:
        return rewrite_sen2forest(ex.query) if self.sen2forest else ex.query

    def query_token_ids(self, ex: RawExample) -> list[int]:
        """Untruncated [CLS] + pieces + [SEP] ids of the (rewritten, for C)
        query: the query half of every layout (``data/catalog.py:rerank_batch``)."""
        return self.tokenizer.encode_query(self._query_text(ex))

    def label_token_ids(self, class_label: int) -> list[int]:
        """WordPiece ids of a box label's text (no [CLS]/[SEP])."""
        ids = self._label_ids_cache.get(class_label)
        if ids is None:
            text = self.label_texts[str(class_label)]
            ids = self.tokenizer.convert_tokens_to_ids(self.tokenizer.tokenize(text))
            self._label_ids_cache[class_label] = ids
        return ids

    def _label_id_grid(self, ex: RawExample) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (ids [10, 8] i32 zero-padded per box and over boxes, mask [10, 8]
        i32, lens [10] i32 uncapped, like len_class_labels in the reference)."""
        ids = np.zeros((MAX_BOXES, MAX_LABEL_TOKENS), dtype=np.int32)
        mask = np.zeros((MAX_BOXES, MAX_LABEL_TOKENS), dtype=np.int32)
        lens = np.zeros((MAX_BOXES,), dtype=np.int32)
        for i, cl in enumerate(ex.class_labels[:MAX_BOXES]):
            tok = self.label_token_ids(int(cl))
            n = min(len(tok), MAX_LABEL_TOKENS)
            ids[i, :n] = tok[:n]
            mask[i, :n] = 1
            lens[i] = len(tok)
        return ids, mask, lens

    def imagebert_a(self, ex: RawExample, label: int = 0) -> dict[str, np.ndarray]:
        q_ids = self.query_token_ids(ex)
        return {
            "input_ids": pad_1d(q_ids, MAX_QUERY_LEN_AB).astype(np.int32),
            "segment_ids": np.zeros((MAX_QUERY_LEN_AB,), dtype=np.int32),
            "boxes": pad_rows(ex.boxes_5(), MAX_BOXES).astype(np.float32),
            "features": pad_rows(ex.features, MAX_BOXES).astype(np.float32),
            "label_ids": self._label_id_grid(ex)[0],
            "labels": np.int32(label),
            "product_id": np.int64(ex.product_id),
            "query_id": np.int64(ex.query_id),
        }

    def imagebert_b(self, ex: RawExample, label: int = 1) -> dict[str, np.ndarray]:
        """The fed label is 1, as the reference scores testB
        (``evaluate_normal.py:240-243``); the AM head's margin reads it."""
        q_ids = self.query_token_ids(ex)
        label_ids, _, label_lens = self._label_id_grid(ex)
        return {
            "input_ids": pad_1d(q_ids, MAX_QUERY_LEN_AB).astype(np.int32),
            "len_query": np.int32(len(q_ids)),
            "num_boxes": np.int32(ex.num_boxes),
            "segment_ids": SEGMENT_IDS_B.copy(),
            "boxes": pad_rows(ex.boxes_5(), MAX_BOXES).astype(np.float32),
            "features": pad_rows(ex.features, MAX_BOXES).astype(np.float32),
            "label_ids": label_ids,
            "label_lens": label_lens,
            "labels": np.int32(label),
            "product_id": np.int64(ex.product_id),
            "query_id": np.int64(ex.query_id),
        }

    def lxmert(self, ex: RawExample, label: int = 1) -> dict[str, np.ndarray]:
        q_ids = self.query_token_ids(ex)
        label_ids, label_mask, _ = self._label_id_grid(ex)
        return {
            "input_ids": pad_1d(q_ids, MAX_QUERY_LEN_L).astype(np.int32),
            "input_mask": row_mask(min(len(q_ids), MAX_QUERY_LEN_L), MAX_QUERY_LEN_L),
            "label_ids": label_ids,
            "label_mask": label_mask,
            "boxes": pad_rows(ex.boxes_normalized(), MAX_BOXES).astype(np.float32),
            "features": pad_rows(ex.features, MAX_BOXES).astype(np.float32),
            "feats_mask": row_mask(min(ex.num_boxes, MAX_BOXES), MAX_BOXES).astype(np.float32),
            "labels": np.int32(label),
            "product_id": np.int64(ex.product_id),
            "query_id": np.int64(ex.query_id),
        }

    def for_model(self, name: str) -> Callable[[RawExample], dict[str, np.ndarray]]:
        # imagebert_c is imagebert_b's layout; its rewrite is the sen2forest flag
        layouts = {"imagebert_a": self.imagebert_a, "imagebert_b": self.imagebert_b,
                   "imagebert_c": self.imagebert_b, "lxmert": self.lxmert}
        if name not in layouts:
            raise ValueError(f"unknown featurizer layout {name!r}, expected one of {sorted(layouts)}")
        return layouts[name]


def stack_examples(examples: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    keys = examples[0].keys()
    return {k: np.stack([e[k] for e in examples], axis=0) for k in keys}


def pad_batch(batch: dict[str, np.ndarray], batch_size: int) -> dict[str, np.ndarray]:
    """Pad a ragged tail batch to the fixed batch size with a 'valid' mask, so
    every batch has one shape (the reference dropped the tail instead:
    ``run_pretraining_predict_score.py:577-578``)."""
    n = next(iter(batch.values())).shape[0]
    valid = np.zeros((batch_size,), dtype=np.bool_)
    valid[:n] = True
    if n == batch_size:
        return {**batch, "valid": valid}
    out = {}
    for k, v in batch.items():
        pad_shape = (batch_size - n,) + v.shape[1:]
        out[k] = np.concatenate([v, np.zeros(pad_shape, dtype=v.dtype)], axis=0)
    out["valid"] = valid
    return out
