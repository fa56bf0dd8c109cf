"""Mongo-style metadata filter → device mask compiler.

Supports the operator surface the reference sends to Chroma
(``chroma_store.py:90-148``; filter builders in
``utu/rag/rag_tools/kb_search_toolkit.py:63-96`` and the time-range filters
of ``utu/rag/rag_tools/meta_retrieval_toolkit.py:343-366``):

  {"key": v}                        equality
  {"key": {"$eq"/"$ne"/"$gt"/"$gte"/"$lt"/"$lte": v}}
  {"key": {"$in"/"$nin": [v, ...]}}
  {"$and": [f, ...]}, {"$or": [f, ...]}
  multiple top-level keys           implicit $and

Compilation target: ``mask(cols: int32[N, C]) -> bool[N]``, elementwise
torch ops over the index's metadata columns on their device. The filter's
structure is fixed at compile time and named by ``signature()`` — a
canonical string of (slot, op) pairs; the constants travel separately as
an int32 vector. A copy of ``youtu_rag_tpu/index/filters.py`` with the
mask in torch.

Keys that are not device-encoded (beyond the column budget, or needing
``$regex``-like semantics) raise ``FilterError``; callers fall back to the
host-side evaluator ``host_eval`` over original metadata dicts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .metadata import MISSING_I32, MetadataSchema, T_STR

_CMP_OPS = {"$gt", "$gte", "$lt", "$lte"}
_EQ_OPS = {"$eq", "$ne"}
_SET_OPS = {"$in", "$nin"}


class FilterError(ValueError):
    """Filter cannot be compiled to device columns (host fallback needed)."""


@dataclass(frozen=True)
class _Leaf:
    slot: int
    op: str
    nconst: int  # number of constants ($in length)


@dataclass(frozen=True)
class _Node:
    op: str  # "and" | "or"
    children: tuple


class CompiledFilter:
    """A compiled filter: signature + constant vector + mask evaluator."""

    def __init__(self, tree, consts: np.ndarray, signature: str, raw: dict):
        self._tree = tree
        self.consts = consts  # int32 [n_consts]
        self._signature = signature
        self.raw = raw

    def signature(self) -> str:
        return self._signature

    def mask(self, cols: torch.Tensor) -> torch.Tensor:
        """Evaluate to bool[N] on ``cols``' device. ``cols`` is int32 [N, C]."""
        c = torch.as_tensor(self.consts, device=cols.device)
        pos = [0]

        def take(n):
            out = c[pos[0] : pos[0] + n]
            pos[0] += n
            return out

        def ev(node):
            if isinstance(node, _Leaf):
                col = cols[:, node.slot]
                present = col != MISSING_I32
                if node.op == "$eq":
                    k = take(1)[0]
                    return present & (col == k)
                if node.op == "$ne":
                    k = take(1)[0]
                    return present & (col != k)
                if node.op == "$gt":
                    k = take(1)[0]
                    return present & (col > k)
                if node.op == "$gte":
                    k = take(1)[0]
                    return present & (col >= k)
                if node.op == "$lt":
                    k = take(1)[0]
                    return present & (col < k)
                if node.op == "$lte":
                    k = take(1)[0]
                    return present & (col <= k)
                if node.op == "$in":
                    ks = take(node.nconst)
                    return present & (col[:, None] == ks[None, :]).any(dim=1)
                if node.op == "$nin":
                    ks = take(node.nconst)
                    return present & ~(col[:, None] == ks[None, :]).any(dim=1)
                raise AssertionError(node.op)
            masks = [ev(ch) for ch in node.children]
            out = masks[0]
            for m in masks[1:]:
                out = (out & m) if node.op == "and" else (out | m)
            return out

        return ev(self._tree)


def _compile_node(f: dict, schema: MetadataSchema, consts: list[int], sig: list[str]):
    if not isinstance(f, dict) or not f:
        raise FilterError(f"unsupported filter node: {f!r}")
    clauses = []
    for key, value in f.items():
        if key == "$and" or key == "$or":
            if not isinstance(value, list) or not value:
                raise FilterError(f"{key} expects a non-empty list")
            op = "and" if key == "$and" else "or"
            sig.append(f"({op}")
            children = tuple(_compile_node(sub, schema, consts, sig) for sub in value)
            sig.append(")")
            clauses.append(_Node(op, children))
            continue
        if key.startswith("$"):
            raise FilterError(f"unsupported operator {key!r}")
        slot = schema.slot_of(key)
        if slot is None:
            raise FilterError(f"key {key!r} has no device column")
        if isinstance(value, dict):
            if not value:
                # {} would compile to a zero-child AND whose mask() later
                # IndexErrors mid-search; fail at compile time so the
                # host-eval fallback engages instead
                raise FilterError(f"empty operator dict for key {key!r}")
            if len(value) != 1:
                # {"k": {"$gte": a, "$lte": b}} → implicit and
                subs = [{key: {op: v}} for op, v in value.items()]
                sig.append("(and")
                children = tuple(_compile_node(s, schema, consts, sig) for s in subs)
                sig.append(")")
                clauses.append(_Node("and", children))
                continue
            op, operand = next(iter(value.items()))
            if op in _CMP_OPS:
                if schema.types.get(key) == T_STR:
                    raise FilterError(f"ordered comparison on string key {key!r}")
                consts.append(schema.encode_const(key, operand))
                sig.append(f"{slot}{op}")
                clauses.append(_Leaf(slot, op, 1))
            elif op in _EQ_OPS:
                consts.append(schema.encode_const(key, operand))
                sig.append(f"{slot}{op}")
                clauses.append(_Leaf(slot, op, 1))
            elif op in _SET_OPS:
                if not isinstance(operand, (list, tuple)):
                    raise FilterError(f"{op} expects a list")
                for v in operand:
                    consts.append(schema.encode_const(key, v))
                sig.append(f"{slot}{op}:{len(operand)}")
                clauses.append(_Leaf(slot, op, len(operand)))
            else:
                raise FilterError(f"unsupported operator {op!r}")
        else:
            consts.append(schema.encode_const(key, value))
            sig.append(f"{slot}$eq")
            clauses.append(_Leaf(slot, "$eq", 1))
    if len(clauses) == 1:
        return clauses[0]
    return _Node("and", tuple(clauses))


def compile_filter(f: dict, schema: MetadataSchema) -> CompiledFilter:
    consts: list[int] = []
    sig: list[str] = []
    tree = _compile_node(f, schema, consts, sig)
    return CompiledFilter(tree, np.asarray(consts or [0], np.int32), "|".join(sig), f)


# ---------------------------------------------------------------------------
# Host fallback — evaluates the same operator surface over raw dicts.
# ---------------------------------------------------------------------------


def host_eval(f: dict, metadata: dict[str, Any] | None) -> bool:
    metadata = metadata or {}
    for key, value in f.items():
        if key == "$and":
            if not all(host_eval(sub, metadata) for sub in value):
                return False
            continue
        if key == "$or":
            if not any(host_eval(sub, metadata) for sub in value):
                return False
            continue
        actual = metadata.get(key)
        if isinstance(value, dict):
            for op, operand in value.items():
                if not _host_op(actual, op, operand):
                    return False
        else:
            if actual is None or actual != value:
                return False
    return True


def _host_op(actual: Any, op: str, operand: Any) -> bool:
    if op == "$regex":
        import re

        return actual is not None and re.search(str(operand), str(actual)) is not None
    if actual is None:
        return False
    try:
        if op == "$eq":
            return actual == operand
        if op == "$ne":
            return actual != operand
        if op == "$gt":
            return actual > operand
        if op == "$gte":
            return actual >= operand
        if op == "$lt":
            return actual < operand
        if op == "$lte":
            return actual <= operand
        if op == "$in":
            return actual in operand
        if op == "$nin":
            return actual not in operand
    except TypeError:
        return False
    raise FilterError(f"unsupported operator {op!r}")
