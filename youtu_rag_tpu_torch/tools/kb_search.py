"""KB retrieval toolkits exposed as agent tools: a copy of
``youtu_rag_tpu/tools/kb_search.py`` on the port's ``KnowledgeBase``.

- ``kb_embedding_search``: recall top_k x recall_multiplier candidates on
  the KB's device index, rerank to top_k (the KB's reranker), or route
  through the hybrid retriever with ``{"mode": "hybrid"}``;
- ``kb_hybrid_search``, ``kb_rerank``, ``kb_file_search``, ``kb_stats``;
- filters take the Mongo-style operators the store compiles to masks.

The KB comes from the toolkit config: ``{"kb": <KnowledgeBase | name>}``
(a name is looked up in ``GLOBAL_KB_REGISTRY``).
"""

from __future__ import annotations

import json
from typing import Any

from ..core.types import RetrievalResult
from ..retrieval.kb import GLOBAL_KB_REGISTRY, KnowledgeBase
from ..utils.log import get_logger
from . import register_toolkit
from .base import AsyncBaseToolkit, register_tool

logger = get_logger("tools.kb_search")


def _format_results(results: list[RetrievalResult], max_chars: int = 6000) -> str:
    if not results:
        return "No results found."
    lines = []
    used = 0
    for r in results:
        meta = r.chunk.metadata or {}
        src = meta.get("source", r.chunk.document_id)
        block = f"[{r.rank}] (score {r.score:.3f}, source {src})\n{r.chunk.content}"
        if used + len(block) > max_chars:
            if not lines:
                # the TOP hit alone exceeds the budget (big summary/table
                # chunks): truncate it — an empty reply would read to the
                # LLM as "the KB has nothing"
                lines.append(block[:max_chars])
            break
        lines.append(block)
        used += len(block)
    return "\n\n".join(lines)


class BaseRAGToolkit(AsyncBaseToolkit):
    """Shared KB resolution (ref: rag_tools/base_toolkit.py:17,93-137)."""

    def _resolve_kb(self) -> KnowledgeBase:
        kb = self.config.config.get("kb")
        if isinstance(kb, KnowledgeBase):
            return kb
        name = kb or self.config.config.get("kb_name") or "default"
        resolved = GLOBAL_KB_REGISTRY.get(name)
        if resolved is None:
            raise ValueError(f"knowledge base {name!r} not registered")
        return resolved

    @property
    def kb(self) -> KnowledgeBase:
        return self._resolve_kb()


@register_toolkit("kb_search")
class KBSearchToolkit(BaseRAGToolkit):
    @register_tool
    async def kb_embedding_search(
        self,
        query: str,
        top_k: int = 5,
        filters: str | None = None,
    ) -> str:
        """Search the knowledge base for chunks relevant to the query using
        dense embeddings, with optional metadata filters.

        Args:
            query: The search query text.
            top_k: Number of results to return.
            filters: Optional JSON metadata filter, e.g.
                '{"source": "a.pdf"}' or '{"ts": {"$gte": 100}}'.
        """
        kb = self.kb
        parsed_filters: dict[str, Any] | None = None
        if filters:
            try:
                parsed_filters = json.loads(filters) if isinstance(filters, str) else filters
            except json.JSONDecodeError:
                return f"Error: filters is not valid JSON: {filters!r}"
        # toolkit-level retrieval mode: {"mode": "hybrid"} routes this tool
        # through the hybrid (dense+BM25 fusion) retriever while keeping
        # the tool NAME stable — deployed agents (and the local chat LM,
        # which is trained to call kb_embedding_search) upgrade to the
        # production-recommended fusion path by config alone, mirroring the
        # API query route's `mode` parameter.
        if self.config.config.get("mode") == "hybrid":
            results = await kb.hybrid_retriever.retrieve(
                query,
                top_k=top_k,
                filters=parsed_filters,
                enable_reranking=kb.reranker is not None,
                similarity_threshold=0.0,
            )
            return _format_results(results)
        multiplier = self.config.config.get("recall_multiplier", kb.config.retriever.recall_multiplier)
        recall_k = top_k * multiplier if kb.reranker is not None else top_k
        results = await kb.retriever.retrieve(
            query,
            top_k=recall_k,
            filters=parsed_filters,
            enable_reranking=False,
            similarity_threshold=0.0,
        )
        if kb.reranker is not None and results:
            results = await kb.reranker.rerank(query, results, top_k=top_k)
        else:
            results = results[:top_k]
        return _format_results(results)

    @register_tool
    async def kb_hybrid_search(
        self,
        query: str,
        top_k: int = 5,
        filters: str | None = None,
    ) -> str:
        """Search the knowledge base combining dense embeddings with exact
        keyword (BM25) matching. Prefer this over kb_embedding_search when
        the query contains identifiers, codes, names, or rare terms that
        must match exactly.

        Args:
            query: The search query text.
            top_k: Number of results to return.
            filters: Optional JSON metadata filter, e.g.
                '{"source": "a.pdf"}' or '{"ts": {"$gte": 100}}'.
        """
        kb = self.kb
        parsed_filters: dict[str, Any] | None = None
        if filters:
            try:
                parsed_filters = json.loads(filters) if isinstance(filters, str) else filters
            except json.JSONDecodeError:
                return f"Error: filters is not valid JSON: {filters!r}"
        results = await kb.hybrid_retriever.retrieve(
            query,
            top_k=top_k,
            filters=parsed_filters,
            enable_reranking=kb.reranker is not None,
            similarity_threshold=0.0,
        )
        return _format_results(results)

    @register_tool
    async def kb_rerank(self, query: str, candidates: list[str], top_k: int = 5) -> str:
        """Rerank a list of candidate text passages by relevance to a query.

        Args:
            query: The query text.
            candidates: Candidate passages to rerank.
            top_k: Number of top passages to keep.
        """
        from ..core.types import Chunk

        kb = self.kb
        results = [
            RetrievalResult(Chunk(f"cand-{i}", "candidates", c, i), score=0.0, rank=i + 1)
            for i, c in enumerate(candidates)
        ]
        reranker = kb.reranker
        if reranker is None:
            from ..models.reranker import LexicalReranker

            reranker = LexicalReranker()
        ranked = await reranker.rerank(query, results, top_k=top_k)
        return _format_results(ranked)

    @register_tool
    async def kb_file_search(self, query: str, top_k: int = 3) -> str:
        """Find the most relevant FILES (not chunks) in the knowledge base
        for a query, using file-level summary vectors.

        Args:
            query: The search query text.
            top_k: Number of files to return.
        """
        kb = self.kb
        # summary rows are tagged index_type=index_summary at build time
        # (ref: processors.py:423-464); fall back to chunk-level dedup when
        # no summary index exists.
        results = await kb.retriever.retrieve(
            query,
            top_k=top_k * 5,
            filters={"index_type": "index_summary"},
            enable_reranking=False,
            similarity_threshold=0.0,
        )
        if not results:
            results = await kb.retriever.retrieve(
                query, top_k=top_k * 5, enable_reranking=False, similarity_threshold=0.0
            )
        seen: set[str] = set()
        files: list[tuple[str, float]] = []
        for r in results:
            doc = r.chunk.document_id
            if doc not in seen:
                seen.add(doc)
                files.append((doc, r.score))
            if len(files) >= top_k:
                break
        if not files:
            return "No files found."
        return "\n".join(f"[{i+1}] {doc} (score {s:.3f})" for i, (doc, s) in enumerate(files))

    @register_tool
    async def kb_stats(self) -> str:
        """Get statistics about the knowledge base (chunk count, backend)."""
        return json.dumps(await self.kb.stats())
