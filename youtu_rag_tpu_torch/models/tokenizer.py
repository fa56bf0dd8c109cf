"""Deterministic hashing tokenizer (pure Python).

A copy of ``youtu_rag_tpu/models/tokenizer.py::HashTokenizer`` on its
pure-Python path, which the JAX package tests byte-for-byte against its
native C tokenizer (``native/fasthash.c``). The BM25 index and the lexical
reranker use it; porting the C fast path is a later slice."""

from __future__ import annotations

import re

from ..utils.hashing import stable_hash64

_WORD_RE = re.compile(r"[A-Za-z0-9_]+|[一-鿿]|[^\sA-Za-z0-9_]")

_N_SPECIAL = 4  # ids 0-3: pad, cls, sep, unk


class HashTokenizer:
    """Lowercased word/CJK-char tokenization with hashed ids (4.. = hash
    buckets; 0-3 stay reserved as in the JAX package)."""

    def __init__(self, vocab_size: int = 32768):
        assert vocab_size > _N_SPECIAL
        self.vocab_size = vocab_size

    def tokenize(self, text: str) -> list[int]:
        n_buckets = self.vocab_size - _N_SPECIAL
        words = _WORD_RE.findall(text.lower())
        return [_N_SPECIAL + (stable_hash64(w) % n_buckets) for w in words]
