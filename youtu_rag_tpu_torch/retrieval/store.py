"""BaseVectorStore facade over the port's device index.

The port's counterpart of ``youtu_rag_tpu/retrieval/store.py``: the seam
where the reference swaps Chroma/FAISS and this package plugs in its
torch ``DeviceVectorIndex``; everything above — retrievers, builders —
only sees ``BaseVectorStore``. It keeps the JAX store's search coalescer
and its BM25 upkeep; the index lives on the store's ``device``.

Batching note: ``search`` takes one embedding (reference signature); the
engine-native ``search_batch`` amortizes a whole query batch through one
fused kernel launch (replaces the reference's sequential
``batch_retrieve`` loop, ``base_retriever.py:82-99``)."""

from __future__ import annotations

import asyncio
import time
from typing import Any

import numpy as np
import torch

from ..core.config import VectorStoreConfig
from ..core.types import BaseVectorStore, Chunk, HealthStatus
from ..index.device_index import DeviceVectorIndex
from ..utils.device import resolve_device


class TorchVectorStore(BaseVectorStore):
    """Vector store backed by the port's device index on ``device``
    (``None`` → the CUDA card; a host without one raises).

    The index dimension is fixed lazily on the first ``add_chunks`` call
    (from the embedding length), like Chroma collections materializing on
    first insert."""

    def __init__(
        self,
        config: VectorStoreConfig | None = None,
        dim: int | None = None,
        device: str | torch.device | None = None,
    ):
        self.config = config or VectorStoreConfig()
        self._dim = dim
        self.device = resolve_device(device)
        self._index: DeviceVectorIndex | None = None
        self._lock = asyncio.Lock()
        self._search_coalescer: _SearchCoalescer | None = None
        self._lexical = None
        if self.config.lexical_index:
            from .lexical import LexicalInvertedIndex

            self._lexical = LexicalInvertedIndex()
        if dim is not None:
            self._index = self._make_index(dim)

    # -- engine plumbing ---------------------------------------------------

    def _make_index(self, dim: int):
        icfg = self.config.index
        metric = {"cosine": "cosine", "euclidean": "l2", "dot": "ip"}[self.config.distance_metric]
        icfg = icfg.model_copy(update={"metric": metric})
        return DeviceVectorIndex(dim, icfg, device=self.device)

    @property
    def index(self):
        if self._index is None:
            raise RuntimeError("store is empty; dimension unknown until first add_chunks")
        return self._index

    def _ensure_index(self, dim: int):
        if self._index is None:
            self._dim = dim
            self._index = self._make_index(dim)
        elif dim != self._dim:
            raise ValueError(f"embedding dim {dim} != store dim {self._dim}")
        return self._index

    # -- BaseVectorStore ---------------------------------------------------

    async def add_chunks(self, chunks: list[Chunk]) -> None:
        if not chunks:
            return
        missing = [c.id for c in chunks if c.embedding is None]
        if missing:
            raise ValueError(f"chunks missing embeddings: {missing[:3]}...")
        embs = np.asarray([c.embedding for c in chunks], np.float32)
        async with self._lock:
            self._ensure_index(embs.shape[1]).add(chunks, embs)
            if self._lexical is not None:
                self._lexical.add(chunks)

    async def search(
        self,
        query_embedding: list[float],
        top_k: int = 5,
        filters: dict[str, Any] | None = None,
    ) -> list[tuple[Chunk, float]]:
        return (await self.search_batch([query_embedding], top_k, filters))[0]

    async def search_batch(
        self,
        query_embeddings: list[list[float]] | np.ndarray,
        top_k: int = 5,
        filters: dict[str, Any] | None = None,
    ) -> list[list[tuple[Chunk, float]]]:
        """Engine-native batched search: one fused kernel launch for the
        whole query batch. With ``coalesce_window_ms`` > 0, concurrent
        calls sharing (top_k, filters) merge into one launch — N serving
        requests pay ~one kernel launch instead of N."""
        q = np.asarray(query_embeddings, np.float32)
        n_q = q.shape[0] if q.ndim >= 1 else 0
        if n_q == 0:
            return []  # empty batch: (0,)-shaped array would fail dim checks
        if self._index is None or self._index.count() == 0:
            return [[] for _ in range(n_q)]
        if self.config.coalesce_window_ms > 0:
            return await self._coalescer().search(q, top_k, filters)
        return self._index.search(q, top_k=top_k, filters=filters)

    def _coalescer(self) -> "_SearchCoalescer":
        if self._search_coalescer is None:
            self._search_coalescer = _SearchCoalescer(
                self, window_ms=self.config.coalesce_window_ms
            )
        return self._search_coalescer

    async def reserve(self, total_rows: int, dim: int | None = None) -> None:
        """Pre-allocate index capacity for a planned build."""
        if self._index is None:
            if dim is None:
                return  # dimension unknown until first add
            self._ensure_index(dim)
        self._index.reserve(total_rows)

    async def delete(self, chunk_ids: list[str]) -> None:
        if self._index is not None:
            self._index.delete(chunk_ids)
        if self._lexical is not None:
            self._lexical.delete(chunk_ids)

    async def delete_by_document_id(self, document_id: str) -> int:
        if self._index is None:
            return 0
        if self._lexical is not None:
            self._lexical.delete_by_document(document_id)
        return self._index.delete_by_document_id(document_id)

    async def get_by_id(self, chunk_id: str) -> Chunk | None:
        if self._index is None:
            return None
        return self._index.get_by_id(chunk_id)

    async def count(self) -> int:
        return 0 if self._index is None else self._index.count()

    async def clear(self) -> None:
        if self._index is not None:
            self._index.clear()
        if self._lexical is not None:
            self._lexical.clear()

    def rebuild_lexical(self) -> None:
        """Repopulate the inverted index from live chunks (snapshot
        restore, or flipping ``lexical_index`` on for an existing KB)."""
        if self.config.lexical_index and self._lexical is None:
            from .lexical import LexicalInvertedIndex

            self._lexical = LexicalInvertedIndex()
        if self._lexical is not None and self._index is not None:
            self._lexical.rebuild(self._index.iter_live())

    async def lexical_search_bundle(
        self,
        query: str,
        top_k: int = 10,
        filters: dict[str, Any] | None = None,
        rare_limit: int = 8,
    ) -> tuple[list[tuple[Chunk, float]], dict[str, float], list[tuple[Chunk, float]]]:
        """(top hits, full candidate score map, rare-term matches) from one
        tokenize + postings walk — the hybrid retriever's bundle."""
        if self._lexical is None or self._index is None:
            return [], {}, []
        predicate = self._filter_predicate(filters)
        hits, scores, rare = self._lexical.search_bundle(
            query, top_k=top_k, predicate=predicate, rare_limit=rare_limit
        )
        return (
            self._resolve_lexical_hits(hits),
            scores,
            self._resolve_lexical_hits(rare),
        )

    def _filter_predicate(self, filters: dict[str, Any] | None):
        if not filters:
            return None
        from ..index.filters import host_eval

        def predicate(cid: str) -> bool:
            c = self._index.get_by_id(cid)
            return c is not None and host_eval(filters, c.metadata)

        return predicate

    def _resolve_lexical_hits(
        self, hits: list[tuple[str, float]]
    ) -> list[tuple[Chunk, float]]:
        out = []
        for cid, score in hits:
            c = self._index.get_by_id(cid)
            if c is not None:  # tombstoned between postings and fetch
                out.append((c, score))
        return out

    async def health(self) -> HealthStatus:
        n = await self.count()
        nbytes = 0 if self._index is None else self._index.nbytes()
        return HealthStatus(
            is_healthy=True,
            backend=self.config.backend,
            collection_name=self.config.collection_name,
            total_chunks=n,
            index_size_bytes=nbytes,
            last_check_time=time.strftime("%Y-%m-%dT%H:%M:%S"),
        )


class _SearchCoalescer:
    """Merges concurrent search calls into one fused kernel launch.

    Same mechanics as CoalescingEmbedder (models/embedder.py): callers
    enqueue (queries, key, future); a lazily-started worker waits
    ``window_ms`` after the first arrival, groups waiters by
    (top_k, filter-signature) — different filters compile different bias
    masks and cannot share a launch — stacks each group's query rows into
    one ``index.search`` call, and slices results back per caller, so N
    concurrent single-query requests cost ~one index read instead of N."""

    def __init__(self, store: "TorchVectorStore", window_ms: float = 2.0, max_queries: int = 64):
        self.store = store
        self.window_s = window_ms / 1e3
        self.max_queries = max_queries
        self._queue: asyncio.Queue | None = None
        self._worker: asyncio.Task | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self.stats = {"dispatches": 0, "queries": 0, "max_merged": 0}

    @staticmethod
    def _key(top_k: int, filters: dict | None) -> str:
        import json as _json

        return f"{top_k}|{_json.dumps(filters, sort_keys=True, default=str) if filters else ''}"

    def _ensure_worker(self) -> asyncio.Queue:
        loop = asyncio.get_running_loop()
        if self._queue is None or self._loop is not loop or (self._worker and self._worker.done()):
            self._queue = asyncio.Queue()
            self._loop = loop
            self._worker = loop.create_task(self._run())
        return self._queue

    async def search(self, q: np.ndarray, top_k: int, filters: dict | None):
        fut = asyncio.get_running_loop().create_future()
        self._ensure_worker().put_nowait((q, top_k, filters, fut))
        return await fut

    async def _run(self) -> None:
        queue = self._queue
        while True:
            first = await queue.get()
            batch = [first]
            n = first[0].shape[0]
            deadline = asyncio.get_running_loop().time() + self.window_s
            while n < self.max_queries:
                remaining = deadline - asyncio.get_running_loop().time()
                if remaining <= 0:
                    break
                try:
                    item = await asyncio.wait_for(queue.get(), remaining)
                except asyncio.TimeoutError:
                    break
                batch.append(item)
                n += item[0].shape[0]
            groups: dict[str, list] = {}
            for item in batch:
                groups.setdefault(self._key(item[1], item[2]), []).append(item)
            self.stats["dispatches"] += len(groups)
            self.stats["queries"] += n
            self.stats["max_merged"] = max(self.stats["max_merged"], len(batch))
            for items in groups.values():
                top_k, filters = items[0][1], items[0][2]
                Q = np.concatenate([it[0] for it in items], axis=0)
                try:
                    hits = self.store._index.search(Q, top_k=top_k, filters=filters)
                except Exception as e:  # noqa: BLE001 - propagate to every waiter
                    for it in items:
                        if not it[3].done():
                            it[3].set_exception(e)
                    continue
                row = 0
                for it in items:
                    k = it[0].shape[0]
                    if not it[3].done():
                        it[3].set_result(hits[row : row + k])
                    row += k
