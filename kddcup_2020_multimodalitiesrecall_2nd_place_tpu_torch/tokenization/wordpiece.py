"""BERT WordPiece tokenization, behavior-compatible with both reference tokenizers.

The reference ships two lineages of the same algorithm:

* Google-BERT style (``code/imagebert_lds/src/tokenization.py:161-359``,
  byte-identical copy at ``code/imagebert_zk/tokenization.py``): no
  ``never_split`` set, ``max_input_chars_per_word=200``.
* HuggingFace style (``code/lxmert/src/lxrt/tokenization.py:48-388``):
  ``never_split=("[UNK]","[SEP]","[PAD]","[CLS]","[MASK]")``,
  ``max_input_chars_per_word=100``.

Both are the same pipeline: clean text -> CJK spacing -> whitespace split ->
(lower + NFD accent strip) -> punctuation split -> greedy longest-match
WordPiece with "##" continuations. This module implements that pipeline once
with the two variants exposed as constructors. Scores are only reproducible
if this output matches the reference exactly (query and box-label texts both
flow through it), so the unicode category rules below mirror BERT precisely.
"""

from __future__ import annotations

import unicodedata
from functools import lru_cache
from typing import Iterable, Sequence

_NEVER_SPLIT_HF = ("[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]")


def load_vocab(vocab_file) -> dict[str, int]:
    """Load a BERT vocab file: one token per line, id = line index."""
    vocab: dict[str, int] = {}
    with open(vocab_file, "r", encoding="utf-8") as f:
        for index, line in enumerate(f):
            token = line.rstrip("\n")
            # BERT's convert_to_unicode + token.strip(): the reference strips
            # surrounding whitespace from each vocab entry.
            token = token.strip()
            if token in vocab:
                continue  # first occurrence wins, as in dict insertion order
            vocab[token] = index
    return vocab


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges BERT treats as punctuation even when unicode disagrees
    # (e.g. "$", "`"): see _is_punctuation in the reference tokenizers.
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk_codepoint(cp: int) -> bool:
    return (
        (0x4E00 <= cp <= 0x9FFF)
        or (0x3400 <= cp <= 0x4DBF)
        or (0x20000 <= cp <= 0x2A6DF)
        or (0x2A700 <= cp <= 0x2B73F)
        or (0x2B740 <= cp <= 0x2B81F)
        or (0x2B820 <= cp <= 0x2CEAF)
        or (0xF900 <= cp <= 0xFAFF)
        or (0x2F800 <= cp <= 0x2FA1F)
    )


def _whitespace_split(text: str) -> list[str]:
    return text.split()


class BasicTokenizer:
    """Clean / CJK-space / lowercase / accent-strip / punctuation-split."""

    def __init__(self, do_lower_case: bool = True, never_split: Sequence[str] = ()):
        self.do_lower_case = do_lower_case
        self.never_split = frozenset(never_split)

    def tokenize(self, text: str) -> list[str]:
        text = self._clean(text)
        text = self._space_cjk(text)
        out: list[str] = []
        for token in _whitespace_split(text):
            if token in self.never_split:
                out.append(token)
                continue
            if self.do_lower_case:
                token = token.lower()
                token = self._strip_accents(token)
            out.extend(self._split_punc(token))
        return _whitespace_split(" ".join(out))

    @staticmethod
    def _clean(text: str) -> str:
        chars = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            chars.append(" " if _is_whitespace(ch) else ch)
        return "".join(chars)

    @staticmethod
    def _space_cjk(text: str) -> str:
        chars = []
        for ch in text:
            if _is_cjk_codepoint(ord(ch)):
                chars.append(f" {ch} ")
            else:
                chars.append(ch)
        return "".join(chars)

    @staticmethod
    def _strip_accents(text: str) -> str:
        text = unicodedata.normalize("NFD", text)
        return "".join(ch for ch in text if unicodedata.category(ch) != "Mn")

    def _split_punc(self, token: str) -> list[str]:
        if token in self.never_split:
            return [token]
        pieces: list[str] = []
        word: list[str] = []
        for ch in token:
            if _is_punctuation(ch):
                if word:
                    pieces.append("".join(word))
                    word = []
                pieces.append(ch)
            else:
                word.append(ch)
        if word:
            pieces.append("".join(word))
        return pieces


class WordpieceTokenizer:
    """Greedy longest-match-first subword split against a fixed vocab."""

    def __init__(self, vocab: dict[str, int], unk_token: str = "[UNK]",
                 max_input_chars_per_word: int = 200):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_input_chars_per_word = max_input_chars_per_word

    def tokenize(self, text: str) -> list[str]:
        out: list[str] = []
        for token in _whitespace_split(text):
            chars = list(token)
            if len(chars) > self.max_input_chars_per_word:
                out.append(self.unk_token)
                continue
            start = 0
            sub_tokens: list[str] = []
            bad = False
            n = len(chars)
            while start < n:
                end = n
                cur = None
                while start < end:
                    sub = "".join(chars[start:end])
                    if start > 0:
                        sub = "##" + sub
                    if sub in self.vocab:
                        cur = sub
                        break
                    end -= 1
                if cur is None:
                    bad = True
                    break
                sub_tokens.append(cur)
                start = end
            out.append(self.unk_token) if bad else out.extend(sub_tokens)
        return out


class FullTokenizer:
    """End-to-end BERT tokenizer: basic + wordpiece + id conversion."""

    def __init__(self, vocab_file, do_lower_case: bool = True,
                 never_split: Sequence[str] = (),
                 max_input_chars_per_word: int = 200):
        self.vocab = load_vocab(vocab_file)
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self.basic = BasicTokenizer(do_lower_case, never_split)
        self.wordpiece = WordpieceTokenizer(
            self.vocab, max_input_chars_per_word=max_input_chars_per_word)
        self._tokenize_cached = lru_cache(maxsize=1 << 16)(self._tokenize_uncached)

    @classmethod
    def google_style(cls, vocab_file, do_lower_case: bool = True) -> "FullTokenizer":
        """Matches imagebert_lds/imagebert_zk tokenization.py defaults."""
        return cls(vocab_file, do_lower_case, never_split=(),
                   max_input_chars_per_word=200)

    @classmethod
    def hf_style(cls, vocab_file, do_lower_case: bool = True) -> "FullTokenizer":
        """Matches lxmert/src/lxrt/tokenization.py defaults."""
        return cls(vocab_file, do_lower_case, never_split=_NEVER_SPLIT_HF,
                   max_input_chars_per_word=100)

    def _tokenize_uncached(self, text: str) -> tuple[str, ...]:
        pieces: list[str] = []
        for token in self.basic.tokenize(text):
            pieces.extend(self.wordpiece.tokenize(token))
        return tuple(pieces)

    def tokenize(self, text: str) -> list[str]:
        # Queries and box-label strings repeat heavily across the 29k test
        # pairs; an LRU cache makes host-side preprocessing essentially free.
        return list(self._tokenize_cached(text))

    def convert_tokens_to_ids(self, tokens: Iterable[str]) -> list[int]:
        return [self.vocab[t] for t in tokens]

    def convert_ids_to_tokens(self, ids: Iterable[int]) -> list[str]:
        return [self.inv_vocab[i] for i in ids]

    def encode_query(self, query: str, max_len: int | None = None) -> list[int]:
        """[CLS] + wordpieces + [SEP]; optionally hard-truncated to max_len.

        Matches ``load_data_pred.py:116`` followed by ``seq_padding(..., 20)``
        (truncation keeps the first ``max_len`` ids, possibly cutting [SEP]).
        """
        ids = self.convert_tokens_to_ids(["[CLS]"] + self.tokenize(query) + ["[SEP]"])
        return ids if max_len is None else ids[:max_len]
