"""Google-BERT WordPiece tokenization (``imagebert_lds/src/tokenization.py``),
a frozen copy for the reference: clean text, space CJK characters, split on
whitespace, lower-case and strip accents, split punctuation, then greedy
longest-match WordPiece with "##" continuations (200 characters a word at
most). The vocab is the repo's raw ``assets/user_data/vocab.txt``, the file
the reference models were trained with, read as it stands."""

from __future__ import annotations

import unicodedata
from functools import lru_cache
from pathlib import Path

VOCAB = Path(__file__).resolve().parents[2] / "assets" / "user_data" / "vocab.txt"


def _is_whitespace(ch: str) -> bool:
    return ch in (" ", "\t", "\n", "\r") or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    return ch not in ("\t", "\n", "\r") and unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def _basic(text: str) -> list[str]:
    chars = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        ch = " " if _is_whitespace(ch) else ch
        chars.append(f" {ch} " if _is_cjk(ord(ch)) else ch)
    out: list[str] = []
    for token in "".join(chars).split():
        token = unicodedata.normalize("NFD", token.lower())
        token = "".join(c for c in token if unicodedata.category(c) != "Mn")
        word = ""
        for ch in token:
            if _is_punctuation(ch):
                if word:
                    out.append(word)
                    word = ""
                out.append(ch)
            else:
                word += ch
        if word:
            out.append(word)
    return out


class Tokenizer:
    def __init__(self, vocab_file=VOCAB):
        self.vocab: dict[str, int] = {}
        with open(vocab_file, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab.setdefault(line.rstrip("\n").strip(), i)
        self.pieces = lru_cache(maxsize=1 << 14)(self._pieces)

    def _wordpiece(self, token: str) -> list[str]:
        if len(token) > 200:
            return ["[UNK]"]
        out, start = [], 0
        while start < len(token):
            end, cur = len(token), None
            while start < end:
                sub = ("##" if start else "") + token[start:end]
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return ["[UNK]"]
            out.append(cur)
            start = end
        return out

    def _pieces(self, text: str) -> tuple[int, ...]:
        return tuple(self.vocab[p] for t in _basic(text) for p in self._wordpiece(t))

    def query_ids(self, query: str) -> list[int]:
        """[CLS] + pieces + [SEP], untruncated."""
        return [self.vocab["[CLS]"], *self.pieces(query), self.vocab["[SEP]"]]
