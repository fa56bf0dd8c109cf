"""Plain BM25 term counts of a chunk, the semantics of the reference
project's hashing tokenizer: the lowercased text's words (runs of
letters, digits and ``_``), CJK characters and single other non-space
characters, each word's id ``4 + h mod (2**30 - 4)`` with ``h`` the
8-byte BLAKE2b digest of its UTF-8 bytes read as a signed little-endian
integer. Imports nothing of the program."""

from __future__ import annotations

import hashlib
import re
from collections import Counter

WORD = re.compile(r"[A-Za-z0-9_]+|[一-鿿]|[^\sA-Za-z0-9_]")
N_SPECIAL = 4
BUCKETS = 2**30 - N_SPECIAL


def term_id(word: str) -> int:
    h = int.from_bytes(hashlib.blake2b(word.encode("utf-8"), digest_size=8).digest(), "little",
                       signed=True)
    return N_SPECIAL + h % BUCKETS


def record(text: str) -> tuple[int, dict[int, int]]:
    """(length in terms, {term id: count}) of ``text``."""
    words = WORD.findall(text.lower())
    return len(words), dict(Counter(term_id(w) for w in words))
