"""Device-resident vector index: the brute half of
``youtu_rag_tpu/index/device_index.py::DeviceVectorIndex`` in PyTorch.

- vectors live in a device tensor ``[capacity, d_pad]`` (bf16 by default),
  L2-normalized at insert for cosine so score == inner product;
- liveness and the l2 norm term are one additive float32 bias per row:
  0 for live rows, ``NEG_INF`` for tombstones and padding, and
  ``-||x||²`` for the l2 metric, whose queries are doubled so that
  ``2 q·x - ||x||²`` ranks like negative squared distance;
- metadata filters compile to a mask over int32 columns
  (``index.filters``) that joins the bias, so filtering is fused into the
  scored scan;
- capacity grows by powers of two; chunk contents and metadata stay on
  the host (row ↔ chunk id maps).

Every search goes through ``ops.topk.topk_pruned``: the CUDA kernel on a
CUDA index, its plain version on a CPU index. There is no size threshold
that sends small indexes elsewhere.

Not ported yet (ROADMAP Queue A 3, Queue B 2-3 and 9-11): AOT tier warming,
the append pacing probe, IVF and the int8/int4 storage tiers (the last two
raise ``NotImplementedError`` rather than silently storing bf16). The array
updates that JAX writes as donated jit kernels are in-place tensor writes
here; searches run under the index lock and on the same stream, so a
search never observes half an append.
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np
import torch

from ..core.config import IndexConfig
from ..core.types import Chunk
from ..ops.topk import MAX_K, MAX_Q, NEG_INF, topk_pruned
from ..utils.device import resolve_device
from ..utils.log import get_logger
from .filters import CompiledFilter, FilterError, compile_filter, host_eval
from .metadata import MISSING_I32, MetadataSchema

logger = get_logger("index.device")

_LANE = 128
_STORE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pow2_at_least(x: int, floor: int) -> int:
    c = max(floor, 1)
    while c < x:
        c *= 2
    return c


class DeviceVectorIndex:
    """Single-device vector index.

    Thread-safe for interleaved add/delete/search (one internal lock around
    mutations and the search launch)."""

    def __init__(self, dim: int, config: IndexConfig | None = None,
                 device: str | torch.device | None = None):
        self.config = config or IndexConfig()
        self.dim = dim
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self._reset()

    def _reset(self) -> None:
        """(Re)initialize all index state in place (never the lock)."""
        if self.config.kind != "flat":
            raise NotImplementedError(
                f"kind={self.config.kind!r}: IVF is not ported yet (ROADMAP Queue A 9); use 'flat'"
            )
        if self.config.storage_dtype not in _STORE_DTYPES:
            raise NotImplementedError(
                f"storage_dtype={self.config.storage_dtype!r}: the int8/int4 storage "
                "tiers are not ported yet (ROADMAP Queue B 2-3); use 'bfloat16' or 'float32'"
            )
        self.metric = self.config.metric
        self.d_pad = _round_up(self.dim, _LANE)
        self._store_dtype = _STORE_DTYPES[self.config.storage_dtype]
        self.capacity = _pow2_at_least(self.config.min_capacity, self.config.block_rows)
        self.size = 0  # rows ever appended (including tombstones)
        self.live_count = 0
        self.schema = MetadataSchema(max_columns=self.config.max_metadata_columns)
        self._vectors = torch.zeros((self.capacity, self.d_pad), dtype=self._store_dtype,
                                    device=self.device)
        self._cols = torch.full((self.capacity, self.schema.max_columns), MISSING_I32,
                                dtype=torch.int32, device=self.device)
        self._bias = torch.full((self.capacity,), NEG_INF, dtype=torch.float32,
                                device=self.device)
        # host-side
        self._chunks: list[Chunk | None] = []
        self._id_to_row: dict[str, int] = {}
        self._doc_rows: dict[str, list[int]] = {}

    # -- mutation ----------------------------------------------------------

    def _grow(self, need_rows: int) -> None:
        new_cap = self.capacity
        while new_cap < need_rows:
            new_cap *= 2
        if new_cap == self.capacity:
            return
        logger.info("index grow %d -> %d rows", self.capacity, new_cap)
        pad = new_cap - self.capacity
        self._vectors = torch.cat([
            self._vectors,
            torch.zeros((pad, self.d_pad), dtype=self._store_dtype, device=self.device),
        ])
        self._cols = torch.cat([
            self._cols,
            torch.full((pad, self.schema.max_columns), MISSING_I32, dtype=torch.int32,
                       device=self.device),
        ])
        self._bias = torch.cat([
            self._bias,
            torch.full((pad,), NEG_INF, dtype=torch.float32, device=self.device),
        ])
        self.capacity = new_cap

    def reserve(self, total_rows: int) -> None:
        """Pre-allocate capacity for a known build size."""
        with self._lock:
            self._grow(total_rows)

    def add(self, chunks: list[Chunk], embeddings: np.ndarray) -> list[int]:
        """Append chunks with their embeddings; returns assigned rows.

        Re-adding an existing chunk id tombstones the old row first
        (delete-then-reinsert). Host prep and the host→device copy run
        outside the lock; commits go in ``append_slice_rows`` slices so a
        concurrent search waits for at most one slice."""
        n = len(chunks)
        if n == 0:
            return []
        embeddings = np.asarray(embeddings, np.float32)
        if embeddings.shape != (n, self.dim):
            raise ValueError(f"embeddings {embeddings.shape} != ({n}, {self.dim})")

        # -- host prep (no lock): pow2 bucket, as the JAX index pads -------
        bucket = _pow2_at_least(n, 64)
        vpad = np.zeros((bucket, self.d_pad), np.float32)
        vpad[:n, : self.dim] = embeddings
        if self.metric == "cosine":
            norms = np.linalg.norm(vpad[:n], axis=1, keepdims=True)
            vpad[:n] /= np.maximum(norms, 1e-12)
        bpad = np.full(bucket, NEG_INF, np.float32)
        bpad[:n] = -np.sum(vpad[:n] * vpad[:n], axis=1) if self.metric == "l2" else 0.0
        with self._lock:  # schema slot assignment mutates shared host state
            cols = np.asarray([self.schema.encode_row(c.metadata) for c in chunks], np.int32)
        cpad = np.full((bucket, self.schema.max_columns), MISSING_I32, np.int32)
        cpad[:n] = cols
        new_chunks = [
            Chunk(c.id, c.document_id, c.content, c.chunk_index, c.metadata) for c in chunks
        ]
        # f32 → store dtype rounds to nearest even, as jnp.asarray does
        dev_vec = torch.from_numpy(vpad).to(self.device).to(self._store_dtype)
        dev_cols = torch.from_numpy(cpad).to(self.device)
        dev_bias = torch.from_numpy(bpad).to(self.device)

        slice_rows = self.config.append_slice_rows or bucket
        with self._lock:
            self._grow(self.size + bucket)  # one jump to the final capacity

        # -- sliced commits ------------------------------------------------
        rows: list[int] = []
        offset = 0
        while offset < n:
            s_n = min(slice_rows, bucket - offset)
            sl = slice(offset, offset + s_n)
            real = min(n - offset, s_n)  # live rows in this slice
            with self._lock:
                # ids re-added in THIS slice tombstone under the same lock
                # hold as their re-insert: an updated chunk is never missing
                stale = [
                    c.id for c in new_chunks[offset : offset + real] if c.id in self._id_to_row
                ]
                if stale:
                    self.delete(stale)
                self._grow(self.size + s_n)
                start = self.size
                self._vectors[start : start + s_n] = dev_vec[sl]
                self._cols[start : start + s_n] = dev_cols[sl]
                self._bias[start : start + s_n] = dev_bias[sl]
                for i in range(real):
                    c = new_chunks[offset + i]
                    row = start + i
                    self._chunks.append(c)
                    self._id_to_row[c.id] = row
                    self._doc_rows.setdefault(c.document_id, []).append(row)
                    rows.append(row)
                # padding rows of the last slice carry NEG_INF bias and no
                # chunk; the next append's start overwrites them
                self.size += real
                self.live_count += real
            offset += s_n
        return rows

    def update_metadata(self, chunk_ids: list[str], metadatas: list[dict]) -> int:
        """In-place metadata update (no re-embedding): host chunk records
        change and the device filter columns are re-encoded."""
        with self._lock:
            rows: list[int] = []
            cols: list[list[int]] = []
            for cid, meta in zip(chunk_ids, metadatas):
                row = self._id_to_row.get(cid)
                if row is None:
                    continue
                chunk = self._chunks[row]
                if chunk is None:
                    continue
                chunk.metadata = meta
                rows.append(row)
                cols.append(self.schema.encode_row(meta))
            if not rows:
                return 0
            self._cols[torch.as_tensor(rows, device=self.device)] = torch.as_tensor(
                cols, dtype=torch.int32, device=self.device
            )
            return len(rows)

    def delete(self, chunk_ids: list[str]) -> int:
        """Tombstone rows for the given chunk ids; returns count deleted."""
        with self._lock:
            rows = [self._id_to_row[cid] for cid in chunk_ids if cid in self._id_to_row]
            if not rows:
                return 0
            self._bias[torch.as_tensor(rows, device=self.device)] = NEG_INF
            for cid in chunk_ids:
                row = self._id_to_row.pop(cid, None)
                if row is None:
                    continue
                chunk = self._chunks[row]
                if chunk is not None:
                    dr = self._doc_rows.get(chunk.document_id)
                    if dr is not None:
                        try:
                            dr.remove(row)
                        except ValueError:
                            pass
                        if not dr:
                            del self._doc_rows[chunk.document_id]
                self._chunks[row] = None
                self.live_count -= 1
            self._maybe_auto_compact()
            return len(rows)

    def _maybe_auto_compact(self) -> None:
        """Compact when tombstones dominate (IndexConfig.auto_compact_ratio)."""
        ratio = self.config.auto_compact_ratio
        if ratio <= 0 or self.size < 4 * self.config.block_rows:
            return
        dead = self.size - self.live_count
        if dead / max(self.size, 1) >= ratio:
            logger.info("auto-compact: %d/%d rows are tombstones (>= %.0f%%)",
                        dead, self.size, ratio * 100)
            self.compact()

    def delete_by_document_id(self, document_id: str) -> int:
        with self._lock:
            rows = list(self._doc_rows.get(document_id, ()))
            ids = [self._chunks[r].id for r in rows if self._chunks[r] is not None]
            return self.delete(ids)

    def clear(self) -> None:
        with self._lock:
            self._reset()

    def _rebuild_host_maps(self) -> None:
        """Recompute _id_to_row/_doc_rows from _chunks."""
        self._id_to_row = {}
        self._doc_rows = {}
        for row, c in enumerate(self._chunks):
            if c is not None:
                self._id_to_row[c.id] = row
                self._doc_rows.setdefault(c.document_id, []).append(row)

    def compact(self) -> None:
        """Rebuild arrays dropping tombstones (periodic maintenance)."""
        with self._lock:
            live = [(r, c) for r, c in enumerate(self._chunks) if c is not None]
            if not live:
                self._reset()
                return
            rows = torch.as_tensor([r for r, _ in live], device=self.device)
            vecs = self._vectors[rows, : self.dim].float().cpu().numpy()
            chunks = [c for _, c in live]
            schema = self.schema
            self._reset()
            self.schema = schema  # keep slot assignments stable
            self.add(chunks, vecs)

    # -- search ------------------------------------------------------------

    def search(
        self,
        query_embeddings: np.ndarray,
        top_k: int = 5,
        filters: dict[str, Any] | None = None,
    ) -> list[list[tuple[Chunk, float]]]:
        """Batched top-k search. Returns per-query (chunk, similarity) lists.

        Filters compile to a device mask joined into the bias; filters that
        do not compile fall back to a host pre-filter over raw metadata.
        ``top_k`` must lie in 1..MAX_K on every device, the CUDA kernel's
        range, so a CPU index refuses what a CUDA index would."""
        if not 1 <= top_k <= MAX_K:
            raise ValueError(f"top_k={top_k} outside 1..{MAX_K}, the most the top-k kernel keeps")
        q = np.asarray(query_embeddings, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(f"queries {q.shape} do not have width {self.dim}")
        n_q = q.shape[0]
        # pow2 query bucket, as the JAX index pads: the kernel sees the
        # same query counts on both sides; padding rows are sliced off
        q_bucket = 1 << max(n_q - 1, 0).bit_length()
        qpad = np.zeros((q_bucket, self.d_pad), np.float32)
        qpad[:n_q, : self.dim] = q
        if self.metric == "cosine":
            qpad /= np.maximum(np.linalg.norm(qpad, axis=1, keepdims=True), 1e-12)
        elif self.metric == "l2":
            qpad *= 2.0  # score = 2 q·x - ||x||^2 (norm term lives in the bias)
        queries = torch.from_numpy(qpad).to(self.device)

        with self._lock:
            vectors, cols, bias = self._vectors, self._cols, self._bias
            k_eff = min(top_k, max(self.live_count, 1))
            if filters:
                try:
                    bias = _filter_bias(cols, bias, compile_filter(filters, self.schema))
                except FilterError:
                    # host fallback: explicit bias from raw metadata
                    hb = np.full(self.capacity, NEG_INF, np.float32)
                    keep = [
                        r for r, c in enumerate(self._chunks)
                        if c is not None and host_eval(filters, c.metadata)
                    ]
                    hb[keep] = 0.0
                    bias = bias + torch.from_numpy(hb).to(self.device)
            scores, rows = self._run_search(queries, vectors, bias, k_eff)
            # reference capture, not a copy: structural mutations replace
            # the list; add() appends and delete() writes None, both benign
            chunks_snapshot = self._chunks

        scores = scores.cpu().numpy()[:n_q]
        rows = rows.cpu().numpy()[:n_q]
        out: list[list[tuple[Chunk, float]]] = []
        for qi in range(scores.shape[0]):
            hits: list[tuple[Chunk, float]] = []
            for s, r in zip(scores[qi], rows[qi]):
                if s <= NEG_INF / 2:
                    continue
                chunk = chunks_snapshot[r] if r < len(chunks_snapshot) else None
                if chunk is None:
                    continue
                hits.append((chunk, float(s)))
            out.append(hits)
        return out

    def _run_search(self, queries: torch.Tensor, vectors: torch.Tensor,
                    bias: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The kernel takes at most MAX_Q queries per launch; bigger
        batches launch once per MAX_Q-query tile. f32 storage is searched
        in bf16, as the JAX kernels cast it."""
        x = vectors if vectors.dtype == torch.bfloat16 else vectors.to(torch.bfloat16)
        parts = [topk_pruned(queries[i : i + MAX_Q], x, bias, k)
                 for i in range(0, queries.shape[0], MAX_Q)]
        if len(parts) == 1:
            return parts[0]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    # -- introspection -----------------------------------------------------

    def get_by_id(self, chunk_id: str) -> Chunk | None:
        row = self._id_to_row.get(chunk_id)
        return self._chunks[row] if row is not None else None

    def count(self) -> int:
        return self.live_count

    def count_by_document(self, document_id: str) -> int:
        """Live chunk rows for one document (storage-state checks)."""
        return len(self._doc_rows.get(document_id, ()))

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self._vectors, self._cols, self._bias))

    def iter_live(self):
        for c in self._chunks:
            if c is not None:
                yield c


def _filter_bias(cols: torch.Tensor, bias: torch.Tensor, filt: CompiledFilter) -> torch.Tensor:
    """Join a compiled metadata mask into the additive bias. A row already
    at NEG_INF that the filter also drops overflows to -inf, as in JAX."""
    drop = torch.full_like(bias, NEG_INF).masked_fill_(filt.mask(cols), 0.0)
    return bias + drop
