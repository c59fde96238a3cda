"""Hard-negative training samplers (the reference's train generators), the
port of the JAX package's ``data/sampling.py``: the same code over the port's
tokenizer and featurizer, so one seed draws the same ``random.Random`` stream
in the same order (negative mining, ``rand_query`` shuffles and A's MLM
masking share it) and yields the same example dicts.

Both TF stacks train on (positive pair, mined negative) at 1:1, with a
curriculum that ramps hard-negative probability over epochs and a strategy
mix over the ``query_labels.txt`` indices
(lds ``load_data_v4.py:245-295``, zk ``load_data_v4.py:510-560``):

* p < 0.5*r         same tail-word query (hardest)
* 0.5*r <= p <= 0.7*r  query sharing a box label
* 0.7*r < p <= 0.9*r   query sharing a non-"others" box label
* otherwise          uniform random query

where r = min(epoch / ramp_epochs, 1); ramp_epochs = 8 (A) or 3 (B).

Variant differences captured by ``SamplerConfig``:

* A keeps only 20% of "book" queries (``:212``), adds BERT MLM masking
  (15%, max 10 predictions, 80/10/10 -- ``:151-156, 391-465``).
* B filters positives to queries in query_labels ∪ extra_words
  (zk ``:240-248``), drops queries tokenizing past 20 ids, drops ALL "book"
  rows, applies ``rand_query`` shuffle augmentation to negatives
  (zk ``:114-131``), rejects negatives with the same word multiset
  (zk ``:313-315``), and emits per-token word-match labels
  (zk ``:362-377``).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

from ..tokenization import FullTokenizer
from .featurize import Featurizer
from .labels import QueryLabelIndex
from .tsv import MAX_QUERY_LEN_AB, RawExample, is_header, parse_line

EXTRA_WORDS_B = [
    "letters hooded", "hooded letters", "baby high waisted",
    "drop resistance cute cup", "school bag", "student bag", "cheongsam",
    "flower brooch", "chandelier", "handbag", "hand bag", "swimsuit",
]

MASK_PROB = 0.15
MAX_PRED = 10


@dataclass(frozen=True)
class SamplerConfig:
    variant: str = "a"  # "a" | "b"
    ramp_epochs: float = 8.0
    book_keep_prob: float = 0.2
    filter_to_query_labels: bool = False
    reject_same_word_count: bool = False
    shuffle_negative_query: bool = False
    mlm: bool = False
    word_match_labels: bool = False
    max_query_ids: int | None = None
    seed: int = 0

    @classmethod
    def imagebert_a(cls, seed: int = 0) -> "SamplerConfig":
        return cls(variant="a", ramp_epochs=8.0, book_keep_prob=0.2, mlm=True,
                   seed=seed)

    @classmethod
    def imagebert_b(cls, seed: int = 0) -> "SamplerConfig":
        return cls(
            variant="b",
            ramp_epochs=3.0,
            book_keep_prob=0.0,
            filter_to_query_labels=True,
            reject_same_word_count=True,
            shuffle_negative_query=True,
            word_match_labels=True,
            max_query_ids=MAX_QUERY_LEN_AB,
            seed=seed,
        )


def rand_query_shuffle(query: str, rng: random.Random) -> str:
    """zk load_data_v4.py:114-131: 10% shuffle all-but-last, 20% all-but-2."""
    words = query.split(" ")
    if len(words) <= 3:
        return query
    r = rng.random()
    if r < 0.7:
        return query
    if r < 0.8:
        head = words[:-1]
        rng.shuffle(head)
        return " ".join(head + words[-1:])
    head = words[:-2]
    rng.shuffle(head)
    return " ".join(head + words[-2:])


def same_word_count(q1: str, q2: str) -> int:
    c = 0
    for a in q1.split(" "):
        for b in q2.split(" "):
            if a == b:
                c += 1
    return c


def mask_query_tokens(
    tokens: list[str],
    tokenizer: FullTokenizer,
    rng: random.Random,
    vocab_words: list[str],
) -> tuple[list[str], list[int], list[int], list[float]]:
    """BERT MLM masking (lds load_data_v4.py:391-465, whole-word off)."""
    cand = [i for i, t in enumerate(tokens) if t not in ("[CLS]", "[SEP]")]
    rng.shuffle(cand)
    out = list(tokens)
    n_pred = min(MAX_PRED, max(1, int(round(len(tokens) * MASK_PROB))))
    positions: list[int] = []
    labels: list[str] = []
    for i in cand:
        if len(positions) >= n_pred:
            break
        if rng.random() < 0.8:
            out[i] = "[MASK]"
        elif rng.random() >= 0.5:
            out[i] = vocab_words[rng.randint(0, len(vocab_words) - 1)]
        positions.append(i)
        labels.append(tokens[i])
    order = np.argsort(positions, kind="stable")
    positions = [positions[i] for i in order]
    labels = [labels[i] for i in order]
    ids = tokenizer.convert_tokens_to_ids(labels)
    return out, positions, ids, [1.0] * len(ids)


@dataclass
class SamplerStats:
    positives: int = 0
    negatives: int = 0
    skipped: int = 0
    strategy_counts: dict = field(default_factory=lambda: {"tail": 0, "label": 0, "label_no_other": 0, "random": 0})


class HardNegativeSampler:
    """Streams (positive, mined-negative) featurized examples for training."""

    def __init__(
        self,
        featurizer: Featurizer,
        query_index: QueryLabelIndex,
        config: SamplerConfig,
    ):
        self.featurizer = featurizer
        self.index = query_index
        self.config = config
        self.rng = random.Random(config.seed)
        self.stats = SamplerStats()
        self._vocab_words = list(featurizer.tokenizer.vocab.keys())
        self._epoch = 0.0

    # -- negative mining -----------------------------------------------------

    def _pick_row(self, query_tag: str, labels: list[str], neg_ratio: float) -> tuple[int, str]:
        r = self.rng.random()
        idx = -1
        strategy = "random"
        if r < 0.5 * neg_ratio and query_tag in self.index.by_tail_word:
            idx = self.rng.choice(self.index.by_tail_word[query_tag])
            strategy = "tail"
        elif 0.5 * neg_ratio <= r <= 0.7 * neg_ratio and labels:
            lab = self.rng.choice(labels)
            rows = self.index.by_label.get(lab)
            if rows:
                idx = self.rng.choice(rows)
                strategy = "label"
        elif 0.7 * neg_ratio < r <= 0.9 * neg_ratio:
            non_other = [l for l in labels if l != "others"]
            if non_other:
                lab = self.rng.choice(non_other)
                rows = self.index.by_label.get(lab)
                if rows:
                    idx = self.rng.choice(rows)
                    strategy = "label_no_other"
        if idx == -1:
            idx = self.rng.randint(0, len(self.index.rows) - 1)
            strategy = "random"
        return idx, strategy

    def mine_negative(self, ex: RawExample, label_texts: list[str]) -> str | None:
        """-> a negative query for this positive row, or None if mining fails."""
        cfg = self.config
        neg_ratio = min(self._epoch / cfg.ramp_epochs, 1.0) if cfg.ramp_epochs else 1.0
        query_tag = ex.query.split(" ")[-1]
        search_count = 0
        strict = True
        while True:
            search_count += 1
            if search_count > 10:
                strict = False
            if search_count > 15:
                return None
            idx, strategy = self._pick_row(query_tag, label_texts, neg_ratio)
            row = self.index.rows[idx]
            pid2, query2, _, _ = QueryLabelIndex.parse_row(row)
            if cfg.shuffle_negative_query:
                query2 = rand_query_shuffle(query2, self.rng)
            if strict and (query2.strip() == ex.query.strip() or pid2 == ex.product_id):
                continue
            if cfg.reject_same_word_count and strict:
                c = same_word_count(ex.query, query2)
                if c == len(ex.query.split(" ")) or c == len(query2.split(" ")):
                    continue
            if cfg.max_query_ids is not None:
                n_ids = len(self.featurizer.tokenizer.encode_query(query2))
                if n_ids > cfg.max_query_ids:
                    if strict:
                        continue
                    # non-strict: hard truncate (zk :318-321)
            self.stats.strategy_counts[strategy] += 1
            return query2

    # -- word-match labels (B) ----------------------------------------------

    def word_match_targets(self, pos_ids: list[int], neg_ids: list[int]) -> tuple[np.ndarray, np.ndarray]:
        """zk load_data_v4.py:362-377: per-token membership of the negative
        query's tokens in the positive query, tail token handled specially."""
        T = MAX_QUERY_LEN_AB - 2
        labels = np.zeros(T, np.int32)
        weights = np.zeros(T, np.float32)
        if len(neg_ids) != 3 and len(neg_ids) >= 2 and len(pos_ids) >= 2 and neg_ids[-2] == pos_ids[-2]:
            for i in range(len(neg_ids) - 3):
                tok = neg_ids[i + 1]
                if tok in pos_ids:
                    labels[i] = 1
                weights[i] = 1.0
        tail_pos = len(neg_ids) - 3
        if 0 <= tail_pos < T:
            if len(neg_ids) >= 2 and len(pos_ids) >= 2 and neg_ids[-2] == pos_ids[-2]:
                labels[tail_pos] = 1
            weights[tail_pos] = 1.0
        return labels, weights

    # -- main stream ---------------------------------------------------------

    def _accept_positive(self, ex: RawExample) -> bool:
        cfg = self.config
        if "book" in ex.query and self.rng.random() > cfg.book_keep_prob:
            return False
        if cfg.filter_to_query_labels:
            q = ex.query.strip()
            if q not in self.index.query_set and not any(
                w in ex.query for w in EXTRA_WORDS_B
            ):
                return False
        if cfg.max_query_ids is not None:
            if len(self.featurizer.tokenizer.encode_query(ex.query)) > cfg.max_query_ids:
                return False
        return True

    def examples(self, lines) -> Iterator[dict[str, np.ndarray]]:
        """Yields featurized positive/negative examples (labels 1/0)."""
        cfg = self.config
        self._epoch += 1.0
        fz = (
            self.featurizer.imagebert_a
            if cfg.variant == "a"
            else self.featurizer.imagebert_b
        )
        tokenizer = self.featurizer.tokenizer
        for line in lines:
            if is_header(line) or not line.strip():
                continue
            try:
                ex = parse_line(line)
            except (ValueError, IndexError):  # a malformed row: counted, the stream goes on
                self.stats.skipped += 1
                continue
            if not self._accept_positive(ex):
                self.stats.skipped += 1
                continue
            label_texts = [
                self.featurizer.label_texts.get(str(int(c)), "") for c in ex.class_labels
            ]
            pos = fz(ex, label=1)
            pos_ids = tokenizer.encode_query(ex.query)
            if cfg.mlm:
                pos.update(self._mlm_fields(ex.query, tokenizer))
            if cfg.word_match_labels:
                t = np.ones(MAX_QUERY_LEN_AB - 2, np.int32)
                w = np.concatenate([
                    np.ones(max(len(pos_ids) - 2, 0), np.float32),
                    np.zeros(MAX_QUERY_LEN_AB - max(len(pos_ids) - 2, 0) - 2, np.float32),
                ])[: MAX_QUERY_LEN_AB - 2]
                pos["word_match_labels"] = t
                pos["word_match_weights"] = w
            self.stats.positives += 1
            yield pos

            neg_query = self.mine_negative(ex, label_texts)
            if neg_query is None:
                continue
            neg_ex = RawExample(
                product_id=ex.product_id,
                image_h=ex.image_h,
                image_w=ex.image_w,
                num_boxes=ex.num_boxes,
                boxes=ex.boxes,
                features=ex.features,
                class_labels=ex.class_labels,
                query=neg_query,
                query_id=0,
            )
            neg = fz(neg_ex, label=0)
            if cfg.mlm:
                neg.update(self._mlm_fields(neg_query, tokenizer))
            if cfg.word_match_labels:
                neg_ids = tokenizer.encode_query(neg_query, max_len=MAX_QUERY_LEN_AB)
                labels, weights = self.word_match_targets(pos_ids, neg_ids)
                neg["word_match_labels"] = labels
                neg["word_match_weights"] = weights
            self.stats.negatives += 1
            yield neg

    def _mlm_fields(self, query: str, tokenizer: FullTokenizer) -> dict:
        tokens = ["[CLS]"] + tokenizer.tokenize(query) + ["[SEP]"]
        masked, positions, ids, weights = mask_query_tokens(
            tokens, tokenizer, self.rng, self._vocab_words
        )
        masked_ids = tokenizer.convert_tokens_to_ids(masked)[:MAX_QUERY_LEN_AB]
        masked_ids = masked_ids + [0] * (MAX_QUERY_LEN_AB - len(masked_ids))
        pad = lambda xs, v: (list(xs)[:MAX_PRED] + [v] * (MAX_PRED - len(xs)))
        return {
            "input_ids": np.asarray(masked_ids, np.int32),
            "masked_lm_positions": np.asarray(pad(positions, 0), np.int32),
            "masked_lm_ids": np.asarray(pad(ids, 0), np.int32),
            "masked_lm_weights": np.asarray(pad(weights, 0.0), np.float32),
        }
