"""Context assembly: retrieval results → LLM-ready context string.

Behavior parity with ``utu/rag/knowledge_retrieval/context_assembler.py``:
markdown/plain/json styles, char budget (default 4000) enforced greedily
in rank order, chunk_index/total_chunks stripped from displayed metadata."""

from __future__ import annotations

import json
from typing import Any

from ..core.types import RetrievalResult

_HIDDEN_META = ("chunk_index", "total_chunks")


class ContextAssembler:
    def __init__(self, max_context_length: int = 4000):
        self.max_context_length = max_context_length

    def assemble(
        self,
        results: list[RetrievalResult],
        include_metadata: bool = True,
        format_style: str = "markdown",
    ) -> str:
        if not results:
            return ""
        if format_style == "markdown":
            sections = self._budget(
                self._section_md(i, r, include_metadata) for i, r in enumerate(results, 1)
            )
            return "\n\n---\n\n".join(sections)
        if format_style == "plain":
            sections = self._budget(
                self._section_plain(i, r, include_metadata) for i, r in enumerate(results, 1)
            )
            return "\n\n".join(sections)
        if format_style == "json":
            items = []
            used = 0
            for r in results:
                item: dict[str, Any] = {"content": r.chunk.content, "score": r.score, "rank": r.rank}
                if include_metadata and r.chunk.metadata:
                    item["metadata"] = r.chunk.metadata
                s = json.dumps(item, ensure_ascii=False)
                if used + len(s) > self.max_context_length:
                    break
                items.append(item)
                used += len(s)
            return json.dumps(items, ensure_ascii=False, indent=2)
        raise ValueError(f"Unknown format style: {format_style}")

    def _budget(self, sections) -> list[str]:
        out: list[str] = []
        used = 0
        for s in sections:
            if used + len(s) > self.max_context_length:
                if not out:
                    # the TOP hit alone exceeds the budget (big chunks vs a
                    # small budget): truncate it rather than answering with
                    # zero context
                    out.append(s[: self.max_context_length])
                break
            out.append(s)
            used += len(s)
        return out

    @staticmethod
    def _meta_str(metadata: dict[str, Any]) -> str:
        return ", ".join(f"{k}={v}" for k, v in metadata.items() if k not in _HIDDEN_META)

    def _section_md(self, i: int, r: RetrievalResult, include_metadata: bool) -> str:
        parts = [f"## Context {i} (Relevance: {r.score:.2f})"]
        if include_metadata and r.chunk.metadata:
            parts.append(f"**Metadata:** {self._meta_str(r.chunk.metadata)}")
        parts.append(r.chunk.content)
        return "\n\n".join(parts)

    def _section_plain(self, i: int, r: RetrievalResult, include_metadata: bool) -> str:
        parts = [f"Context {i}:"]
        if include_metadata and r.chunk.metadata:
            parts.append(f"Metadata: {self._meta_str(r.chunk.metadata)}")
        parts.append(r.chunk.content)
        return "\n".join(parts)
