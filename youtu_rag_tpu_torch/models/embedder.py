"""Embedders + factory.

The port's counterpart of ``youtu_rag_tpu/models/embedder.py`` for the
hash provider: ``HashEmbedder`` on the JAX package's pure-Python path
(bit-equal to it; the JAX package's native C kernel, ``native/fasthash.c``,
normalizes within 1 ulp of it), the ``CoalescingEmbedder`` wrapper, and
``EmbedderFactory``. The encoder providers (``tpu``, remote services)
raise until their slice lands (ROADMAP Queue A 7).
"""

from __future__ import annotations

import asyncio
import math
import re

import numpy as np

from ..core.config import EmbeddingConfig
from ..core.types import BaseEmbedder


_FNV_OFFSET = 14695981039346656037
_FNV_PRIME = 1099511628211
_MASK64 = (1 << 64) - 1
_TOKEN_RE = re.compile(r"[A-Za-z0-9_]+|[^\sA-Za-z0-9_]")


def _fnv_feat(token: bytes) -> int:
    h = _FNV_OFFSET
    for b in b"feat:" + token:
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


class HashEmbedder(BaseEmbedder):
    """Feature-hashing bag-of-words embedder (deterministic, host-only).

    Tokens (ASCII word runs lowercased; every other codepoint/symbol is a
    single token) hash via FNV-1a-64 to a dimension; vectors are
    tf-weighted (1 + log tf), L2-normalized, positive-only."""

    def __init__(self, dim: int = 512):
        self._dim = dim

    @property
    def dimension(self) -> int:
        return self._dim

    def embed_one(self, text: str) -> np.ndarray:
        counts: dict[int, int] = {}
        for m in _TOKEN_RE.finditer(text):
            tok = m.group(0)
            if tok.isascii():
                tok = tok.lower()
            h = _fnv_feat(tok.encode("utf-8")[:64])
            counts[h] = counts.get(h, 0) + 1
        vec = np.zeros(self._dim, np.float32)
        for h, c in counts.items():
            vec[h % self._dim] += np.float32(1.0) + np.float32(math.log(c))
        n = np.linalg.norm(vec)
        return vec / n if n > 0 else vec

    def embed_batch(self, texts: list[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self._dim), np.float32)
        return np.stack([self.embed_one(t) for t in texts])

    async def embed_texts(self, texts: list[str]) -> list[list[float]]:
        return self.embed_batch(texts).tolist()

    async def embed_query(self, query: str) -> list[float]:
        return self.embed_batch([query])[0].tolist()


class CoalescingEmbedder(BaseEmbedder):
    """Request-coalescing wrapper: concurrent embed calls inside a short
    window merge into ONE underlying batch dispatch (a copy of the JAX
    package's wrapper). Errors propagate to every waiter in the merged
    batch; the worker restarts if the event loop changed."""

    def __init__(self, inner: BaseEmbedder, window_ms: float = 3.0, max_batch: int = 256):
        self.inner = inner
        self.window_s = window_ms / 1e3
        self.max_batch = max_batch
        self._queue: asyncio.Queue | None = None
        self._worker: asyncio.Task | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self.stats = {"dispatches": 0, "items": 0, "max_merged": 0}

    @property
    def dimension(self) -> int | None:
        return self.inner.dimension

    def _ensure_worker(self) -> asyncio.Queue:
        loop = asyncio.get_running_loop()
        if self._queue is None or self._loop is not loop or (self._worker and self._worker.done()):
            self._queue = asyncio.Queue()
            self._loop = loop
            self._worker = loop.create_task(self._run())
        return self._queue

    async def _run(self) -> None:
        queue = self._queue
        while True:
            first = await queue.get()
            batch = [first]
            n = len(first[0])
            deadline = asyncio.get_running_loop().time() + self.window_s
            while n < self.max_batch:
                remaining = deadline - asyncio.get_running_loop().time()
                if remaining <= 0:
                    break
                try:
                    item = await asyncio.wait_for(queue.get(), remaining)
                except asyncio.TimeoutError:
                    break
                batch.append(item)
                n += len(item[0])
            texts = [t for ts, _ in batch for t in ts]
            self.stats["dispatches"] += 1
            self.stats["items"] += len(texts)
            self.stats["max_merged"] = max(self.stats["max_merged"], len(batch))
            try:
                embs = await self.inner.embed_texts(texts)
            except Exception as e:  # noqa: BLE001 - fan the failure out
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(RuntimeError(str(e)))
                continue
            off = 0
            for ts, fut in batch:
                if not fut.done():
                    fut.set_result(embs[off : off + len(ts)])
                off += len(ts)

    async def embed_texts(self, texts: list[str]) -> list[list[float]]:
        if not texts:
            return []
        queue = self._ensure_worker()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        queue.put_nowait((texts, fut))
        return await fut

    async def embed_query(self, query: str) -> list[float]:
        return (await self.embed_texts([query]))[0]


class EmbedderFactory:
    """Provider dispatch. Only ``hash`` is ported; every other provider
    raises until the encoder slice lands."""

    @staticmethod
    def create(config: EmbeddingConfig | None = None) -> BaseEmbedder:
        config = config or EmbeddingConfig()
        if config.provider != "hash":
            raise NotImplementedError(
                f"embedding provider {config.provider!r} is not ported yet "
                "(ROADMAP Queue A 7); use provider='hash'"
            )
        inner = HashEmbedder(dim=config.dimensions or 256)
        if config.coalesce_window_ms > 0:
            return CoalescingEmbedder(
                inner, window_ms=config.coalesce_window_ms, max_batch=config.batch_size
            )
        return inner
