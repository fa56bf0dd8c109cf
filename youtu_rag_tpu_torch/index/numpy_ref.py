"""Brute-force NumPy reference index: a copy of
``youtu_rag_tpu/index/numpy_ref.py``.

The exact host index behind ``VectorStoreConfig(backend="numpy")``: the
same interface as ``DeviceVectorIndex``, exact f32 math on the host, on
any device the store names (a user's explicit choice of the host index,
not a fallback). It has no ``update_metadata``, ``reserve``, ``nbytes`` or
``count_by_document``, as in JAX; the store serves the first three as
JAX's store does. ``quantize_bf16`` rounds the stored rows to bf16 through
torch (round to nearest even, as ``ml_dtypes`` does in JAX)."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.config import IndexConfig
from ..core.types import Chunk
from .filters import host_eval


class NumpyVectorIndex:
    def __init__(self, dim: int, config: IndexConfig | None = None, quantize_bf16: bool = False):
        self.config = config or IndexConfig()
        self.dim = dim
        self.metric = self.config.metric
        self.quantize_bf16 = quantize_bf16
        self._vectors = np.zeros((0, dim), np.float32)
        self._chunks: list[Chunk | None] = []
        self._id_to_row: dict[str, int] = {}
        self._doc_rows: dict[str, list[int]] = {}
        self._live = np.zeros(0, bool)

    @property
    def live_count(self) -> int:
        return int(self._live.sum())

    def add(self, chunks: list[Chunk], embeddings: np.ndarray) -> list[int]:
        embeddings = np.asarray(embeddings, np.float32)
        stale = [c.id for c in chunks if c.id in self._id_to_row]
        if stale:
            self.delete(stale)
        if self.metric == "cosine":
            embeddings = embeddings / np.maximum(np.linalg.norm(embeddings, axis=1, keepdims=True), 1e-12)
        if self.quantize_bf16:
            embeddings = torch.from_numpy(np.ascontiguousarray(embeddings)).to(
                torch.bfloat16).to(torch.float32).numpy()
        start = len(self._chunks)
        self._vectors = np.concatenate([self._vectors, embeddings])
        self._live = np.concatenate([self._live, np.ones(len(chunks), bool)])
        rows = []
        for i, c in enumerate(chunks):
            row = start + i
            self._chunks.append(Chunk(c.id, c.document_id, c.content, c.chunk_index, c.metadata))
            self._id_to_row[c.id] = row
            self._doc_rows.setdefault(c.document_id, []).append(row)
            rows.append(row)
        return rows

    def delete(self, chunk_ids: list[str]) -> int:
        n = 0
        for cid in chunk_ids:
            row = self._id_to_row.pop(cid, None)
            if row is None:
                continue
            chunk = self._chunks[row]
            if chunk is not None:
                dr = self._doc_rows.get(chunk.document_id)
                if dr and row in dr:
                    dr.remove(row)
                    if not dr:
                        del self._doc_rows[chunk.document_id]
            self._chunks[row] = None
            self._live[row] = False
            n += 1
        return n

    def delete_by_document_id(self, document_id: str) -> int:
        rows = list(self._doc_rows.get(document_id, ()))
        return self.delete([self._chunks[r].id for r in rows if self._chunks[r] is not None])

    def clear(self) -> None:
        self.__init__(self.dim, self.config, self.quantize_bf16)

    def search(
        self,
        query_embeddings: np.ndarray,
        top_k: int = 5,
        filters: dict[str, Any] | None = None,
        backend: str = "numpy",
    ) -> list[list[tuple[Chunk, float]]]:
        q = np.asarray(query_embeddings, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if self.metric == "cosine":
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        if self._vectors.shape[0] == 0:
            return [[] for _ in range(q.shape[0])]

        if self.metric == "l2":
            # negative squared distance (monotonic with similarity ranking)
            x2 = np.sum(self._vectors**2, axis=1)
            scores = 2.0 * q @ self._vectors.T - x2[None, :]
        else:
            scores = q @ self._vectors.T

        keep = self._live.copy()
        if filters:
            for r, c in enumerate(self._chunks):
                if keep[r] and (c is None or not host_eval(filters, c.metadata)):
                    keep[r] = False
        scores = np.where(keep[None, :], scores, -np.inf)

        out = []
        for qi in range(q.shape[0]):
            order = np.argsort(-scores[qi], kind="stable")[:top_k]
            hits = [
                (self._chunks[r], float(scores[qi, r]))
                for r in order
                if np.isfinite(scores[qi, r]) and self._chunks[r] is not None
            ]
            out.append(hits)
        return out

    def get_by_id(self, chunk_id: str) -> Chunk | None:
        row = self._id_to_row.get(chunk_id)
        return self._chunks[row] if row is not None else None

    def count(self) -> int:
        return self.live_count

    def iter_live(self):
        for c in self._chunks:
            if c is not None:
                yield c
