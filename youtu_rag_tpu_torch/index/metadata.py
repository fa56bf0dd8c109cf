"""Metadata → device-column encoding.

The reference stores chunk metadata as Chroma document metadata and filters
with Mongo-style where-clauses inside the HNSW query
(``utu/rag/storage/implementations/chroma_store.py:90-148``). The device design
instead encodes each metadata key into a fixed int32 column of a
``[capacity, C]`` device array so that filters compile to vectorized
mask-and-score on the VPU, fused with the top-k kernel via an additive bias.

Encoding (all order-preserving within a type):
- strings  → stable 32-bit blake2 hash (equality/membership ops only)
- bools    → 0 / 1
- ints     → saturated int32 (epoch-second timestamps fit until 2038)
- floats   → monotonic int32 total-order encoding of float32 bits
- missing  → ``MISSING_I32`` sentinel (int32 min); comparisons never match
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any

from ..utils.hashing import stable_hash32

MISSING_I32 = -(2**31)

# per-key value type tags
T_STR, T_NUM, T_BOOL = "str", "num", "bool"


def _float_to_ordered_i32(f: float) -> int:
    """Map float32 to int32 preserving numeric order (IEEE-754 trick)."""
    b = struct.unpack("<I", struct.pack("<f", float(f)))[0]
    if b & 0x80000000:
        u = ~b & 0xFFFFFFFF  # negative floats: flip all bits
    else:
        u = b | 0x80000000  # positive: flip sign bit
    v = u - 2**31
    return max(v, MISSING_I32 + 1)


def encode_value(value: Any, typ: str) -> int:
    if value is None:
        return MISSING_I32
    if typ == T_STR:
        return stable_hash32(str(value))
    if typ == T_BOOL:
        return 1 if value else 0
    # numeric: ints in int32 range encode directly (exact, order-preserving
    # vs other ints); everything else goes through the float32 ordering.
    if isinstance(value, bool):
        value = int(value)
    if isinstance(value, int) and -(2**30) <= value <= 2**30:
        return value
    return _float_to_ordered_i32(float(value))


def value_type_of(value: Any) -> str:
    if isinstance(value, bool):
        return T_BOOL
    if isinstance(value, (int, float)):
        return T_NUM
    return T_STR


@dataclass
class MetadataSchema:
    """key → (column slot, value type); grows on first use, capped at C.

    Keys beyond ``max_columns`` (or with mixed types) fall back to host-side
    filtering over the original metadata dicts."""

    max_columns: int = 16
    slots: dict[str, int] = field(default_factory=dict)
    types: dict[str, str] = field(default_factory=dict)

    def slot_of(self, key: str) -> int | None:
        return self.slots.get(key)

    def ensure_key(self, key: str, value: Any) -> int | None:
        """Register key (by example value); returns its slot or None."""
        typ = value_type_of(value)
        if key in self.slots:
            if self.types[key] != typ:
                # numeric value in a string column: coerce to string hash;
                # mark column as string-typed equality-only thereafter.
                if {self.types[key], typ} == {T_NUM, T_BOOL}:
                    self.types[key] = T_NUM
                else:
                    self.types[key] = T_STR
            return self.slots[key]
        if len(self.slots) >= self.max_columns:
            return None
        slot = len(self.slots)
        self.slots[key] = slot
        self.types[key] = typ
        return slot

    def encode_row(self, metadata: dict[str, Any] | None) -> list[int]:
        """Encode one metadata dict into a full row of C int32 values,
        registering any new keys."""
        row = [MISSING_I32] * self.max_columns
        if not metadata:
            return row
        for key, value in metadata.items():
            if value is None:
                continue
            slot = self.ensure_key(key, value)
            if slot is None:
                continue
            row[slot] = encode_value(value, self.types[key])
        return row

    def encode_const(self, key: str, value: Any) -> int | None:
        """Encode a filter constant for comparison against column ``key``."""
        if key not in self.slots:
            return None
        return encode_value(value, self.types[key])

    def to_dict(self) -> dict:
        return {"max_columns": self.max_columns, "slots": dict(self.slots), "types": dict(self.types)}

    @classmethod
    def from_dict(cls, d: dict) -> "MetadataSchema":
        return cls(max_columns=d["max_columns"], slots=dict(d["slots"]), types=dict(d["types"]))
