"""Deterministic hashing tokenizer.

A copy of ``youtu_rag_tpu/models/tokenizer.py::HashTokenizer``: the C
tokenizer of ``native/fasthash.c`` (``tokenize_ids``,
``tokenize_ids_batch``), whose ids equal the pure-Python path's, and that
path. The BM25 index, the lexical reranker and the encoder's embedder use
it."""

from __future__ import annotations

import os
import re

import numpy as np

from ..utils.hashing import stable_hash64

# the C tokenizer; YRT_NATIVE_TOKENIZER=0 takes the pure-Python path
_USE_NATIVE = os.environ.get("YRT_NATIVE_TOKENIZER", "1") != "0"

_WORD_RE = re.compile(r"[A-Za-z0-9_]+|[一-鿿]|[^\sA-Za-z0-9_]")

PAD_ID = 0
CLS_ID = 1
SEP_ID = 2
_N_SPECIAL = 4  # ids 0-3: pad, cls, sep, unk


class HashTokenizer:
    """Lowercased word/CJK-char tokenization with hashed ids (4.. = hash
    buckets; 0-3 stay reserved as in the JAX package)."""

    def __init__(self, vocab_size: int = 32768, max_length: int = 512):
        assert vocab_size > _N_SPECIAL
        self.vocab_size = vocab_size
        self.max_length = max_length

    def tokenize(self, text: str) -> list[int]:
        n_buckets = self.vocab_size - _N_SPECIAL
        if _USE_NATIVE:
            from ..native import tokenize_ids_native

            # tokens <= codepoints, so len(text) bounds the output
            return tokenize_ids_native(text, max(len(text), 1), n_buckets, _N_SPECIAL)
        words = _WORD_RE.findall(text.lower())
        return [_N_SPECIAL + (stable_hash64(w) % n_buckets) for w in words]

    def encode(self, text: str, max_length: int | None = None) -> list[int]:
        """[CLS] tokens [SEP], truncated to max_length."""
        max_length = max_length or self.max_length
        return [CLS_ID] + self.tokenize(text)[: max_length - 2] + [SEP_ID]

    def encode_pair(self, a: str, b: str, max_length: int | None = None) -> list[int]:
        """[CLS] a [SEP] b [SEP] — cross-encoder reranker input."""
        max_length = max_length or self.max_length
        budget = max_length - 3
        ta = self.tokenize(a)[: budget // 3]
        tb = self.tokenize(b)[: budget - len(ta)]
        return [CLS_ID] + ta + [SEP_ID] + tb + [SEP_ID]

    def batch(self, texts: list[str], max_length: int | None = None,
              pad_to: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """Encode and pad a batch: (ids [B, T] int32, mask [B, T] f32).

        The C tokenizer takes the whole batch in one call."""
        max_length = max_length or self.max_length
        if _USE_NATIVE:
            from ..native import tokenize_ids_batch_native

            toks, counts = tokenize_ids_batch_native(
                texts, max_length - 2, self.vocab_size - _N_SPECIAL, _N_SPECIAL
            )
            lens = counts + 2  # [CLS] ... [SEP]
            t = pad_to or int(lens.max(initial=2))
            rows, cols = np.arange(len(texts)), np.arange(t)
            ids = np.full((len(texts), t), PAD_ID, np.int32)
            body = min(t - 1, toks.shape[1])
            ids[:, 1 : 1 + body] = toks[:, :body]  # zero (PAD_ID) past each row's count
            ids[:, 0] = CLS_ID
            ids[rows, counts + 1] = SEP_ID
            mask = (cols[None, :] < lens[:, None]).astype(np.float32)
            return ids, mask
        seqs = [self.encode(t, max_length) for t in texts]
        t = pad_to or max(len(s) for s in seqs)
        ids = np.full((len(seqs), t), PAD_ID, np.int32)
        mask = np.zeros((len(seqs), t), np.float32)
        for i, s in enumerate(seqs):
            ids[i, : len(s)] = s
            mask[i, : len(s)] = 1.0
        return ids, mask
