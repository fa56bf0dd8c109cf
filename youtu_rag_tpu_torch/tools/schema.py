"""Function → OpenAI tool-schema generation: a copy of
``youtu_rag_tpu/tools/schema.py``.

JSON-schema types from Python annotations, parameter descriptions from
Google-style ``Args:`` docstring sections, required-vs-optional from
defaults; non-strict (additionalProperties left unset), as the reference
exports its tools."""

from __future__ import annotations

import inspect
import re
import types as _types
import typing
from typing import Any, Callable, get_args, get_origin

_PY_TO_JSON = {
    str: "string",
    int: "integer",
    float: "number",
    bool: "boolean",
    list: "array",
    dict: "object",
    type(None): "null",
}


def _annotation_to_schema(ann: Any) -> dict:
    if ann is inspect.Parameter.empty or ann is Any:
        return {"type": "string"}
    origin = get_origin(ann)
    if origin is typing.Union or origin is _types.UnionType:  # Optional/X|Y
        args = [a for a in get_args(ann) if a is not type(None)]
        if len(args) == 1:
            return _annotation_to_schema(args[0])
        return {"anyOf": [_annotation_to_schema(a) for a in args]}
    if origin in (list, typing.List):
        item = get_args(ann)[0] if get_args(ann) else Any
        return {"type": "array", "items": _annotation_to_schema(item)}
    if origin in (dict, typing.Dict):
        return {"type": "object"}
    if origin is typing.Literal:
        vals = list(get_args(ann))
        t = _PY_TO_JSON.get(type(vals[0]), "string")
        return {"type": t, "enum": vals}
    if ann in _PY_TO_JSON:
        return {"type": _PY_TO_JSON[ann]}
    return {"type": "string"}


_ARGS_SECTION = re.compile(r"^\s*(Args|Arguments|Parameters)\s*:\s*$", re.IGNORECASE)
_ARG_LINE = re.compile(r"^\s+(\w+)\s*(?:\([^)]*\))?\s*:\s*(.+)$")
_SECTION_END = re.compile(r"^\s*(Returns|Raises|Yields|Examples?|Notes?)\s*:\s*$", re.IGNORECASE)


def parse_docstring(doc: str | None) -> tuple[str, dict[str, str]]:
    """Returns (summary, {param: description}) from a Google-style docstring."""
    if not doc:
        return "", {}
    lines = doc.strip().split("\n")
    summary_lines: list[str] = []
    params: dict[str, str] = {}
    in_args = False
    current: str | None = None
    for line in lines:
        if _ARGS_SECTION.match(line):
            in_args = True
            continue
        if _SECTION_END.match(line):
            in_args = False
            current = None
            continue
        if in_args:
            m = _ARG_LINE.match(line)
            if m:
                current = m.group(1)
                params[current] = m.group(2).strip()
            elif current and line.strip():
                params[current] += " " + line.strip()
        else:
            if not params and line.strip():
                summary_lines.append(line.strip())
    return " ".join(summary_lines).strip(), params


def function_schema(fn: Callable, name: str | None = None) -> dict:
    """Build an OpenAI function-tool schema dict for ``fn``."""
    sig = inspect.signature(fn)
    summary, param_docs = parse_docstring(inspect.getdoc(fn))
    props: dict[str, dict] = {}
    required: list[str] = []
    for pname, p in sig.parameters.items():
        if pname in ("self", "cls") or p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            continue
        schema = _annotation_to_schema(p.annotation)
        if pname in param_docs:
            schema["description"] = param_docs[pname]
        if p.default is inspect.Parameter.empty:
            required.append(pname)
        elif p.default is not None:
            schema["default"] = p.default
        props[pname] = schema
    return {
        "type": "function",
        "function": {
            "name": name or fn.__name__,
            "description": summary,
            "parameters": {"type": "object", "properties": props, "required": required},
        },
    }
