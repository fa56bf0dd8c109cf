"""Knowledge builder: documents → chunks → batched embeddings → device index.

Parity with the simple builder (``utu/rag/knowledge_builder/base_builder.py:
17-182``): build lock, BuildStatus lifecycle, md5 chunk ids, per-document
delete-then-reinsert idempotency, error collection without aborting the
batch (ref agent behavior, ``agent.py:743-830``). The staged
KnowledgeBuilderAgent (config analysis, task groups, Excel/DB/QA
processors) layers on top in ``ingest.agent``.

Device shape: chunks from all documents in a wave are embedded in one large
batch (one device wave) instead of per-document HTTP batches with rate-limit
sleeps (ref ``openai_embedder.py:49-173``)."""

from __future__ import annotations

import asyncio
import time
from typing import Callable

from ..core.config import KnowledgeBuilderConfig
from ..core.types import (
    BaseEmbedder,
    BaseKnowledgeBuilder,
    BaseTextSplitter,
    BuildStatus,
    Chunk,
    Document,
)
from ..retrieval.store import TorchVectorStore
from ..utils.hashing import md5_hex
from ..utils.log import get_logger
from .chunker import get_splitter

logger = get_logger("ingest.builder")


def make_chunk_id(document_id: str, chunk_index: int, content: str) -> str:
    """Stable chunk id (md5 of identity+content, ref base_builder scheme)."""
    return md5_hex(f"{document_id}:{chunk_index}:{content}")


class KnowledgeBuilder(BaseKnowledgeBuilder):
    def __init__(
        self,
        vector_store: TorchVectorStore,
        embedder: BaseEmbedder,
        config: KnowledgeBuilderConfig | None = None,
        splitter: BaseTextSplitter | None = None,
        on_progress: Callable[[str, int, int], None] | None = None,
    ):
        self.store = vector_store
        self.embedder = embedder
        self.config = config or KnowledgeBuilderConfig()
        self.splitter = splitter or get_splitter(self.config.chunking)
        self.on_progress = on_progress
        self._status = BuildStatus()
        self._lock = asyncio.Lock()

    async def build_from_documents(self, documents: list[Document], rebuild: bool = False) -> BuildStatus:
        async with self._lock:
            if rebuild:
                await self.store.clear()
            return await self._build(documents)

    async def add_documents(self, documents: list[Document]) -> BuildStatus:
        async with self._lock:
            return await self._build(documents)

    async def get_build_status(self) -> BuildStatus:
        return self._status

    # ------------------------------------------------------------------

    async def _build(self, documents: list[Document]) -> BuildStatus:
        status = BuildStatus(
            status="running",
            total_documents=len(documents),
            start_time=time.strftime("%Y-%m-%dT%H:%M:%S"),
        )
        self._status = status
        try:
            return await self._build_inner(documents, status)
        except Exception as e:  # noqa: BLE001 - status must never stick at 'running'
            logger.exception("build aborted")
            status.status = "failed"
            status.errors.append(f"build aborted: {e}")
            status.end_time = time.strftime("%Y-%m-%dT%H:%M:%S")
            status.metadata["errors_count"] = len(status.errors)
            return status

    async def _build_inner(self, documents: list[Document], status: BuildStatus) -> BuildStatus:

        sem = asyncio.Semaphore(self.config.max_workers)

        async def chunk_one(doc: Document) -> tuple[Document, list[Chunk]] | None:
            async with sem:
                try:
                    texts = self.splitter.split_text(doc.content, doc.metadata)
                    chunks = []
                    for i, text in enumerate(texts):
                        meta = dict(doc.metadata or {})
                        meta.setdefault("source", doc.id)
                        meta["chunk_index"] = i
                        meta["total_chunks"] = len(texts)
                        chunks.append(
                            Chunk(
                                id=make_chunk_id(doc.id, i, text),
                                document_id=doc.id,
                                content=text,
                                chunk_index=i,
                                metadata=meta,
                            )
                        )
                    return doc, chunks
                except Exception as e:  # noqa: BLE001 - per-doc isolation
                    logger.exception("chunking failed for %s", doc.id)
                    status.errors.append(f"{doc.id}: {e}")
                    return None

        chunked = [r for r in await asyncio.gather(*(chunk_one(d) for d in documents)) if r]

        # embed in large cross-document batches (one device wave per batch)
        flat: list[Chunk] = [c for _, chunks in chunked for c in chunks]
        texts = [c.content for c in flat]
        bs = max(self.config.embedding.batch_size, 1)
        done = 0
        for i in range(0, len(texts), bs):
            embs = await self.embedder.embed_texts(texts[i : i + bs])
            for c, e in zip(flat[i : i + bs], embs):
                c.embedding = e
            done += len(embs)
            if self.on_progress:
                self.on_progress("embedding", done, len(texts))
            if self.config.batch_delay and i + bs < len(texts):
                await asyncio.sleep(self.config.batch_delay)

        # pre-allocate for the whole wave: appends during serving then never
        # trigger the capacity-growth stall (see bench_streaming)
        if flat and flat[0].embedding is not None:
            existing = await self.store.count()
            await self.store.reserve(existing + len(flat), dim=len(flat[0].embedding))

        # per-document idempotent store: drop stale rows, insert new
        processed = 0
        for doc, chunks in chunked:
            try:
                await self.store.delete_by_document_id(doc.id)
                await self.store.add_chunks(chunks)
                processed += 1
                status.processed_documents = processed
                status.total_chunks += len(chunks)
                if self.on_progress:
                    self.on_progress("storing", processed, len(chunked))
            except Exception as e:  # noqa: BLE001
                logger.exception("store failed for %s", doc.id)
                status.errors.append(f"{doc.id}: {e}")

        status.status = "completed" if not status.errors else ("failed" if processed == 0 else "completed")
        status.end_time = time.strftime("%Y-%m-%dT%H:%M:%S")
        status.metadata["errors_count"] = len(status.errors)
        return status
