"""Stable hashing helpers.

Used for: chunk ids (md5 of content, matching the reference's id scheme in
``utu/rag/knowledge_builder/base_builder.py``), incremental-build etags
(``utu/rag/api/kb_config_routes.py:504-605``), and metadata string→int32
encoding for device-side filter columns (new, device design)."""

from __future__ import annotations

import hashlib


def md5_hex(text: str) -> str:
    return hashlib.md5(text.encode("utf-8")).hexdigest()


def content_etag(data: bytes | str) -> str:
    if isinstance(data, str):
        data = data.encode("utf-8")
    return hashlib.sha256(data).hexdigest()[:32]


def stable_hash64(value: str) -> int:
    """Deterministic 64-bit hash of a string (process-independent)."""
    d = hashlib.blake2b(value.encode("utf-8"), digest_size=8).digest()
    return int.from_bytes(d, "little", signed=True)


def stable_hash32(value: str) -> int:
    """Deterministic signed 32-bit hash for device metadata columns.

    Avoids the int32 min sentinel reserved for 'missing value'."""
    d = hashlib.blake2b(value.encode("utf-8"), digest_size=4).digest()
    h = int.from_bytes(d, "little", signed=True)
    if h == -(2**31):  # reserved sentinel
        h += 1
    return h
