"""Core RAG data model + abstract interfaces.

Interface parity with the reference data model (``utu/rag/base.py:12-257``):
``Document``/``Chunk``/``RetrievalResult`` dataclasses, query/response and
status pydantic models, and the abstract bases every backend implements.
The device index (``youtu_rag_tpu_torch.index``) plugs in underneath
``BaseVectorStore``; agents only ever see these types.
"""

from __future__ import annotations

import time
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Any

from pydantic import BaseModel, Field


@dataclass
class Document:
    """A source document prior to chunking."""

    id: str
    content: str
    metadata: dict[str, Any] | None = None
    embedding: list[float] | None = None

    def __repr__(self) -> str:  # mirror the truncated repr contract
        preview = self.content[:50] + "..." if len(self.content) > 50 else self.content
        return f"Document(id={self.id}, content='{preview}', metadata={self.metadata})"


@dataclass
class Chunk:
    """A retrievable unit of a document."""

    id: str
    document_id: str
    content: str
    chunk_index: int
    metadata: dict[str, Any] | None = None
    embedding: list[float] | None = None

    def __repr__(self) -> str:
        preview = self.content[:50] + "..." if len(self.content) > 50 else self.content
        return (
            f"Chunk(id={self.id}, doc_id={self.document_id}, "
            f"index={self.chunk_index}, content='{preview}')"
        )


@dataclass
class RetrievalResult:
    """A scored chunk returned by a retriever."""

    chunk: Chunk
    score: float
    rank: int | None = None

    def __repr__(self) -> str:
        return f"RetrievalResult(chunk_id={self.chunk.id}, score={self.score:.4f}, rank={self.rank})"

    def to_dict(self) -> dict[str, Any]:
        return {
            "chunk_id": self.chunk.id,
            "document_id": self.chunk.document_id,
            "content": self.chunk.content,
            "chunk_index": self.chunk.chunk_index,
            "metadata": self.chunk.metadata,
            "score": self.score,
            "rank": self.rank,
        }


class QueryRequest(BaseModel):
    """Query request for retrieval (ref: utu/rag/base.py:55-63)."""

    query: str
    top_k: int = 5
    filters: dict[str, Any] | None = None
    enable_reranking: bool = False
    similarity_threshold: float | None = None


class QueryResponse(BaseModel):
    """Query response from retrieval (ref: utu/rag/base.py:66-74)."""

    query: str
    results: list[dict[str, Any]]
    total_results: int
    retrieval_time_ms: float
    metadata: dict[str, Any] = Field(default_factory=dict)


class BuildStatus(BaseModel):
    """Status of a knowledge-build run (ref: utu/rag/base.py:77-88)."""

    status: str = "pending"  # pending | running | completed | failed
    total_documents: int = 0
    processed_documents: int = 0
    total_chunks: int = 0
    errors: list[str] = Field(default_factory=list)
    start_time: str | None = None
    end_time: str | None = None
    metadata: dict[str, Any] = Field(default_factory=dict)


class HealthStatus(BaseModel):
    """Health of a storage backend (ref: utu/rag/base.py:91-104)."""

    is_healthy: bool
    backend: str
    collection_name: str
    total_documents: int = 0
    total_chunks: int = 0
    index_size_bytes: int = 0
    last_check_time: str = ""
    errors: list[str] = Field(default_factory=list)
    warnings: list[str] = Field(default_factory=list)
    metadata: dict[str, Any] = Field(default_factory=dict)


@dataclass
class QueryLogEntry:
    """One logged query execution, kept by storage monitors."""

    query: str
    latency_ms: float
    result_count: int
    timestamp: float = field(default_factory=time.time)


# ---------------------------------------------------------------------------
# Abstract interfaces (parity with utu/rag/base.py:107-257)
# ---------------------------------------------------------------------------


class BaseTextSplitter(ABC):
    @abstractmethod
    def split_text(self, text: str, metadata: dict[str, Any] | None = None) -> list[str]:
        """Split text into chunk strings."""


class BaseEmbedder(ABC):
    @abstractmethod
    async def embed_texts(self, texts: list[str]) -> list[list[float]]:
        """Embed a batch of texts."""

    @abstractmethod
    async def embed_query(self, query: str) -> list[float]:
        """Embed a single query."""

    @property
    def dimension(self) -> int | None:
        """Embedding dimension if statically known."""
        return None


class BaseReranker(ABC):
    @abstractmethod
    async def rerank(
        self,
        query: str,
        results: list[RetrievalResult],
        top_k: int | None = None,
    ) -> list[RetrievalResult]:
        """Re-score results for relevance to ``query``; update score/rank."""


class BaseKnowledgeBuilder(ABC):
    @abstractmethod
    async def build_from_documents(self, documents: list[Document], rebuild: bool = False) -> BuildStatus:
        ...

    @abstractmethod
    async def add_documents(self, documents: list[Document]) -> BuildStatus:
        ...

    @abstractmethod
    async def get_build_status(self) -> BuildStatus:
        ...


class BaseRetriever(ABC):
    @abstractmethod
    async def retrieve(self, query: str, top_k: int = 5, **kwargs) -> list[RetrievalResult]:
        ...

    @abstractmethod
    async def batch_retrieve(self, queries: list[str], top_k: int = 5, **kwargs) -> list[list[RetrievalResult]]:
        ...


class BaseVectorStore(ABC):
    """Vector storage interface; the device index implements this.

    Semantics anchored to ``utu/rag/base.py:187-232``: ``search`` returns
    ``(chunk, similarity)`` pairs sorted descending, with optional
    Mongo-style metadata filters (``$eq/$ne/$in/$nin/$gt/$gte/$lt/$lte/
    $and/$or`` — see youtu_rag_tpu_torch.index.filters).
    """

    @abstractmethod
    async def add_chunks(self, chunks: list[Chunk]) -> None:
        ...

    @abstractmethod
    async def search(
        self,
        query_embedding: list[float],
        top_k: int = 5,
        filters: dict[str, Any] | None = None,
    ) -> list[tuple[Chunk, float]]:
        ...

    @abstractmethod
    async def delete(self, chunk_ids: list[str]) -> None:
        ...

    @abstractmethod
    async def delete_by_document_id(self, document_id: str) -> int:
        ...

    @abstractmethod
    async def get_by_id(self, chunk_id: str) -> Chunk | None:
        ...

    @abstractmethod
    async def count(self) -> int:
        ...

    @abstractmethod
    async def clear(self) -> None:
        ...


class BaseStorageMonitor(ABC):
    @abstractmethod
    async def check_health(self) -> HealthStatus:
        ...

    @abstractmethod
    async def collect_metrics(self) -> dict[str, Any]:
        ...

    @abstractmethod
    async def log_query(self, query: str, latency_ms: float, result_count: int) -> None:
        ...

    @abstractmethod
    async def get_query_stats(self, time_range_hours: int = 24) -> dict[str, Any]:
        ...
