"""Standalone RAG toolkit: self-contained build/retrieve/stats/clear.

Parity with ``utu/rag/toolkit.py:19-167`` — the minimal all-in-one RAG
tools for simple agents that own their KB (vs the registry-resolved
kb_search toolkits).

The port's copy of ``youtu_rag_tpu/tools/rag_toolkit.py``.
"""

from __future__ import annotations

import json

from ..core.types import Document
from ..retrieval.kb import KnowledgeBase
from ..utils.log import get_logger
from . import register_toolkit
from .base import AsyncBaseToolkit, register_tool

logger = get_logger("tools.rag")


@register_toolkit("rag")
class RAGToolkit(AsyncBaseToolkit):
    """config keys: kb (KnowledgeBase) or rag_config (RAGConfig dict), name, and
    device: where a KB it makes lives (``None`` → the CUDA card)."""

    def __init__(self, config=None):
        super().__init__(config)
        kb = self.config.config.get("kb")
        if kb is None:
            from ..core.config import RAGConfig

            raw = self.config.config.get("rag_config") or {}
            kb = KnowledgeBase(
                self.config.config.get("name", "rag_toolkit"),
                RAGConfig.model_validate(raw) if raw else None,
                device=self.config.config.get("device"),
            )
        self.kb: KnowledgeBase = kb

    @register_tool
    async def rag_build(self, texts: list[str], source: str = "inline") -> str:
        """Add texts to the knowledge base (chunk + embed + index).

        Args:
            texts: Document texts to index.
            source: Source label for the documents.
        """
        docs = [
            Document(f"{source}-{i}", t, {"source": source}) for i, t in enumerate(texts)
        ]
        status = await self.kb.build_documents(docs)
        return f"indexed {status.total_chunks} chunks from {status.processed_documents} documents"

    @register_tool
    async def rag_retrieve(self, query: str, top_k: int = 5) -> str:
        """Retrieve the most relevant chunks for a query.

        Args:
            query: The search query.
            top_k: Number of chunks to return.
        """
        results = await self.kb.search(query, top_k=top_k, similarity_threshold=0.0)
        return self.kb.assembler.assemble(results, format_style="markdown") or "No results."

    @register_tool
    async def rag_stats(self) -> str:
        """Get knowledge-base statistics."""
        return json.dumps(await self.kb.stats())

    @register_tool
    async def rag_clear(self) -> str:
        """Delete everything in the knowledge base."""
        n = await self.kb.store.count()
        await self.kb.store.clear()
        return f"cleared {n} chunks"
