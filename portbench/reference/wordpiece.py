"""Plain BERT tokenization (uncased): whitespace and control cleanup,
lowercase and accent stripping, punctuation split, then greedy
longest-match-first WordPiece over ``vocab.txt``, as Hugging Face's
``BertTokenizer`` does; pairs as ``[CLS] a [SEP] b [SEP]`` with the first
segment cut to a third of the budget. Imports nothing of the program."""

from __future__ import annotations

import unicodedata


def _punct(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


class Tokenizer:
    def __init__(self, vocab: list[str], max_len: int = 512):
        self.ids = {w: i for i, w in enumerate(vocab)}
        self.max_len = max_len
        self.unk, self.cls, self.sep = self.ids["[UNK]"], self.ids["[CLS]"], self.ids["[SEP]"]

    def words(self, text: str) -> list[str]:
        out = []
        for word in text.split():
            word = "".join(c for c in unicodedata.normalize("NFD", word.lower())
                           if unicodedata.category(c) != "Mn")
            cur = ""
            for ch in word:
                if _punct(ch):
                    if cur:
                        out.append(cur)
                    out.append(ch)
                    cur = ""
                else:
                    cur += ch
            if cur:
                out.append(cur)
        return out

    def tokenize(self, text: str) -> list[int]:
        out = []
        for w in self.words(text):
            pieces, start = [], 0
            while start < len(w):
                end = len(w)
                while end > start:
                    sub = ("##" if start else "") + w[start:end]
                    if sub in self.ids:
                        pieces.append(self.ids[sub])
                        break
                    end -= 1
                if end == start:
                    pieces = [self.unk]
                    break
                start = end
            out.extend(pieces)
        return out

    def encode(self, text: str) -> list[int]:
        return [self.cls] + self.tokenize(text)[: self.max_len - 2] + [self.sep]

    def encode_pair(self, a: str, b: str) -> tuple[list[int], list[int]]:
        """(ids, token types) of ``[CLS] a [SEP] b [SEP]``."""
        ta, tb = self.tokenize(a), self.tokenize(b)
        budget = self.max_len - 3
        ta = ta[: budget // 3]
        tb = tb[: budget - len(ta)]
        ids = [self.cls] + ta + [self.sep] + tb + [self.sep]
        return ids, [0] * (len(ta) + 2) + [1] * (len(tb) + 1)
