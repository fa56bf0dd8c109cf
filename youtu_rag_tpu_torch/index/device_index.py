"""Device-resident vector index:
``youtu_rag_tpu/index/device_index.py::DeviceVectorIndex`` in PyTorch.

- vectors live in a device tensor ``[capacity, d_pad]`` (bf16 by default),
  L2-normalized at insert for cosine so score == inner product. The int8
  tier stores symmetric per-row int8 with f32 scales; the int4 tier packs
  two columns per byte (``[capacity, d_pad/2]``, ``d_pad`` a multiple of
  256) with f32 scales and, when ``int4_rerank_multiplier > 1``, keeps an
  int8 shadow copy in host RAM that re-ranks the kernel's over-fetched
  candidates (ScaNN-style);
- liveness and the l2 norm term are one additive float32 bias per row:
  0 for live rows, ``NEG_INF`` for tombstones and padding, and
  ``-||x||²`` for the l2 metric, whose queries are doubled so that
  ``2 q·x - ||x||²`` ranks like negative squared distance;
- metadata filters compile to a mask over int32 columns
  (``index.filters``) that joins the bias, so filtering is fused into the
  scored scan;
- capacity grows by powers of two; chunk contents and metadata stay on
  the host (row ↔ chunk id maps).

Every search goes through the top-k wrapper of its storage tier
(``ops.topk.topk_pruned``, ``topk_int8_pruned`` or ``topk_int4_pruned``):
the CUDA kernel on a CUDA index, its plain version on a CPU index. There is
no size threshold that sends small indexes elsewhere.

IVF (``build_ivf``): k-means sorts the rows by cluster (``index.ivf``);
a search then plans its probed blocks on the device (``probe_blocks``, one
plan for the whole batch) and scans only those through the tier's IVF
wrapper (``ops.ivf.ivf_topk_dma`` and its int8/int4 forms), with no host
sync between the two. It follows the JAX index's ``backend == "pallas"``
branch on every device: no fallback to brute force when the plan's bound
covers every block. Options: the adaptive ``n_probe`` margin, the
closed-loop ``n_probe`` tuner (a brute shadow search every
``ivf_tune_interval`` batches) and the residual re-rank, which draws JAX's
candidate count. ``IndexConfig.kind`` is not read, as in JAX.

Facts of the JAX index that this one copies on purpose: ``compact()`` (and
``persistence.load_index``) rebuild the int4 host shadow from the
int4-dequantized vectors, so after either the re-rank sees int4 precision
only; ``nbytes()`` leaves out the scales.

Not ported (ROADMAP Queue A 3): AOT tier warming and the append pacing
probe. The array updates that JAX writes as donated jit kernels are in-place tensor
writes here; searches run under the index lock and on the same stream, so
a search never observes half an append.
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np
import torch

from ..core.config import IndexConfig
from ..core.types import Chunk
from ..ops.ivf import ivf_topk_dma, ivf_topk_int4_dma, ivf_topk_int8_dma
from ..ops.topk import (
    NEG_INF,
    topk_int4_pruned,
    topk_int8_pruned,
    topk_pruned,
    unpack_int4,
)
from ..utils.device import resolve_device
from ..utils.log import get_logger
from .filters import CompiledFilter, FilterError, compile_filter, host_eval
from .metadata import MISSING_I32, MetadataSchema

logger = get_logger("index.device")

_LANE = 128
BACKENDS = ("auto", "pallas", "pallas_interpret", "xla")  # JAX's search backends
_STORE_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "int8": torch.int8,  # symmetric per-row quantization + f32 scales
    "int4": torch.int8,  # packed nibbles (ops.topk.quantize_rows_int4)
}


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
        self.metric = self.config.metric
        self._int8 = self.config.storage_dtype == "int8"
        self._int4 = self.config.storage_dtype == "int4"
        self._quant = self._int8 or self._int4
        # int4 packs two columns per byte, so the PACKED width (d_pad/2)
        # must stay a multiple of 128: pad d to 2 x 128
        self.d_pad = _round_up(self.dim, 2 * _LANE if self._int4 else _LANE)
        self._vec_cols = self.d_pad // 2 if self._int4 else self.d_pad
        self._store_dtype = _STORE_DTYPES[self.config.storage_dtype]
        self.capacity = _pow2_at_least(self.config.min_capacity, self.config.block_rows)
        self.size = 0  # rows ever appended (including tombstones)
        self.live_count = 0
        self.schema = MetadataSchema(max_columns=self.config.max_metadata_columns)
        self._vectors = torch.zeros((self.capacity, self._vec_cols), dtype=self._store_dtype,
                                    device=self.device)
        self._scales = (torch.zeros(self.capacity, dtype=torch.float32, device=self.device)
                        if self._quant else None)
        # int4 two-stage search: an int8 shadow copy in HOST RAM re-ranks
        # the kernel's candidates (d bytes/row of host memory, no device
        # memory; IndexConfig.int4_rerank_multiplier)
        self._host_rerank = self._int4 and self.config.int4_rerank_multiplier > 1
        self._host_q8 = (np.zeros((self.capacity, self.d_pad), np.int8)
                         if self._host_rerank else None)
        self._host_s8 = np.zeros(self.capacity, np.float32) if self._host_rerank else None
        self._cols = torch.full((self.capacity, self.schema.max_columns), MISSING_I32,
                                dtype=torch.int32, device=self.device)
        self._bias = torch.full((self.capacity,), NEG_INF, dtype=torch.float32,
                                device=self.device)
        # host-side
        self._chunks: list[Chunk | None] = []
        self._id_to_row: dict[str, int] = {}
        self._doc_rows: dict[str, list[int]] = {}
        self._ivf = None  # IVFState after build_ivf()
        # closed-loop n_probe tuner (IndexConfig.ivf_recall_target)
        self._ivf_tune_counter = 0
        self._ivf_recall_est: float | None = None
        self._ivf_tune_streak = 0  # consecutive comfortable observations

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
            torch.zeros((pad, self._vec_cols), dtype=self._store_dtype, device=self.device),
        ])
        if self._quant:
            self._scales = torch.cat([
                self._scales, torch.zeros(pad, dtype=torch.float32, device=self.device)
            ])
        if self._host_q8 is not None:
            self._host_q8 = np.concatenate([self._host_q8, np.zeros((pad, self.d_pad), np.int8)])
            self._host_s8 = np.concatenate([self._host_s8, np.zeros(pad, np.float32)])
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
        if self._int8:
            amax = np.maximum(np.abs(vpad).max(axis=1), 1e-12)
            spad = (amax / 127.0).astype(np.float32)
            host_vec = np.clip(np.round(vpad / spad[:, None]), -127, 127).astype(np.int8)
        elif self._int4:
            # packed nibbles: byte j = col j (low) | col j + d_pad/2 (high),
            # as ops.topk.quantize_rows_int4 / unpack_int4
            amax = np.maximum(np.abs(vpad).max(axis=1), 1e-12)
            spad = (amax / 7.0).astype(np.float32)
            q4 = np.clip(np.round(vpad / spad[:, None]), -7, 7).astype(np.int32)
            half = self.d_pad // 2
            host_vec = ((q4[:, :half] & 0xF) | ((q4[:, half:] & 0xF) << 4)).astype(
                np.uint8).view(np.int8)
            if self._host_rerank:
                s8pad = (amax / 127.0).astype(np.float32)
                q8pad = np.clip(np.round(vpad / s8pad[:, None]), -127, 127).astype(np.int8)
        else:
            host_vec = vpad
        new_chunks = [
            Chunk(c.id, c.document_id, c.content, c.chunk_index, c.metadata) for c in chunks
        ]
        # f32 → store dtype rounds to nearest even, as jnp.asarray does
        dev_vec = torch.from_numpy(host_vec).to(self.device).to(self._store_dtype)
        dev_cols = torch.from_numpy(cpad).to(self.device)
        dev_bias = torch.from_numpy(bpad).to(self.device)
        dev_scales = torch.from_numpy(spad).to(self.device) if self._quant else None

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
                if self._quant:
                    self._scales[start : start + s_n] = dev_scales[sl]
                if self._host_rerank:
                    self._host_q8[start : start + s_n] = q8pad[sl]
                    self._host_s8[start : start + s_n] = s8pad[sl]
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
        """Compact when tombstones dominate (IndexConfig.auto_compact_ratio);
        an index that had IVF builds it again over the compacted rows."""
        ratio = self.config.auto_compact_ratio
        if ratio <= 0 or self.size < 4 * self.config.block_rows:
            return
        dead = self.size - self.live_count
        if dead / max(self.size, 1) >= ratio:
            had_ivf = self._ivf is not None
            logger.info("auto-compact: %d/%d rows are tombstones (>= %.0f%%)",
                        dead, self.size, ratio * 100)
            self.compact()
            if had_ivf and self.live_count > 0:
                self.build_ivf()

    def delete_by_document_id(self, document_id: str) -> int:
        with self._lock:
            rows = list(self._doc_rows.get(document_id, ()))
            ids = [self._chunks[r].id for r in rows if self._chunks[r] is not None]
            return self.delete(ids)

    def clear(self) -> None:
        with self._lock:
            self._reset()

    def reorder(self, permutation: np.ndarray) -> None:
        """Permute rows in place (device arrays, the int4 host shadow and the
        host maps): ``permutation[new_row] = old_row`` over the ``size``
        appended rows. The IVF builder sorts rows by cluster with it."""
        with self._lock:
            perm = np.asarray(permutation, np.int64)
            if perm.shape != (self.size,):
                raise ValueError(f"permutation of {perm.shape} rows, index holds {self.size}")
            full = np.concatenate([perm, np.arange(self.size, self.capacity)])
            self._apply_permutation(full)
            old = self._chunks
            self._chunks = [old[o] for o in perm]
            self._rebuild_host_maps()

    def _apply_permutation(self, idx: np.ndarray) -> None:
        """Gather every row by ``idx`` (length == capacity): on the device,
        or through the host when the device gather would not fit."""
        if self._host_q8 is not None:
            self._host_q8 = self._host_q8[idx]
            self._host_s8 = self._host_s8[idx]
        if self._should_stage_reorder():
            return self._apply_permutation_host(idx)
        gidx = torch.as_tensor(idx, device=self.device)
        self._vectors = self._vectors[gidx]
        self._cols = self._cols[gidx]
        self._bias = self._bias[gidx]
        if self._quant:
            self._scales = self._scales[gidx]

    def _should_stage_reorder(self) -> bool:
        """The JAX index's rule with the card's own numbers: stage through
        the host when 1.3x the index bytes (the new copies and workspace)
        exceed the free device memory, counting what PyTorch's allocator
        holds cached but unused as free. A CPU index never stages."""
        if self.device.type != "cuda":
            return False
        free, _ = torch.cuda.mem_get_info(self.device)
        free += torch.cuda.memory_reserved(self.device) - torch.cuda.memory_allocated(self.device)
        total = self.nbytes() + (self._scales.numel() * 4 if self._quant else 0)
        return 1.3 * total > free

    def _apply_permutation_host(self, idx: np.ndarray) -> None:
        """Pull each array to the host, free the device copies, permute,
        push back: the device peak stays near one copy of the index."""
        logger.info("host-staged reorder (%d rows, %.1f GB index)",
                    len(idx), self.nbytes() / 1e9)
        gidx = torch.as_tensor(idx)
        names = ["_vectors", "_cols", "_bias"] + (["_scales"] if self._quant else [])
        host = {}
        for name in names:
            host[name] = getattr(self, name).cpu()
            setattr(self, name, None)
        # new arrays land in locals first: a failed push leaves the host copies
        moved = {name: t[gidx].to(self.device) for name, t in host.items()}
        for name, t in moved.items():
            setattr(self, name, t)

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
            rows = np.asarray([r for r, _ in live])
            # through the dequantized view, as the JAX index: a quantized
            # index re-quantizes its own dequantized rows (and the int4
            # shadow is rebuilt from int4 precision)
            vecs = np.empty((len(rows), self.dim), np.float32)
            step = 1 << 20  # bounded device memory: the f32 view is 4x int8
            for i in range(0, len(rows), step):
                part = rows[i : i + step]
                vecs[i : i + len(part)] = self.dequantize_take(part)[:, : self.dim].cpu().numpy()
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
        backend: str = "auto",
    ) -> list[list[tuple[Chunk, float]]]:
        """Batched top-k search. Returns per-query (chunk, similarity) lists.

        ``backend`` takes JAX's names (``BACKENDS``). A CPU index runs the
        plain versions under each of them. A CUDA index runs the kernels
        under "auto" and "pallas" (JAX's pallas branch, on every device)
        and refuses "xla" and "pallas_interpret": its path is the kernel,
        and an index made with ``device="cpu"`` runs the plain one. An
        unknown name raises on every device.

        Filters compile to a device mask joined into the bias; filters that
        do not compile fall back to a host pre-filter over raw metadata.
        ``top_k`` >= 1 on every device (the kernels keep any k up to the
        live count, which bounds it as in JAX); a smaller one raises.

        int4 with the host re-rank asks the kernel for JAX's
        ``pow2_at_least(ceil(k * int4_rerank_multiplier), 16)`` candidates
        (at most the largest power of two <= the live count) and re-scores
        them from the int8 shadow."""
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
        if self.device.type == "cuda" and backend in ("xla", "pallas_interpret"):
            raise ValueError(f"backend {backend!r} on a CUDA index: the card's path is the "
                             "kernel ('auto' or 'pallas'); an index made with device='cpu' "
                             "runs the plain version")
        if top_k < 1:
            raise ValueError(f"top_k={top_k} below 1")
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
            # int4 two-stage: ask the packed kernel for a pow2-bucketed
            # candidate multiple, re-rank on the host from the int8 shadow
            k_req = k_eff
            host_rr = self._host_rerank
            if host_rr:
                mult = self.config.int4_rerank_multiplier
                k2 = _pow2_at_least(max(int(np.ceil(k_eff * mult)), k_eff), 16)
                if self.live_count < k2:
                    k2 = 1 << max(self.live_count.bit_length() - 1, 0)
                k_req = max(k2, k_eff)
                hq8, hs8 = self._host_q8, self._host_s8
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
            scores, rows = self._run_search(queries, vectors, self._scales, bias, k_req)
            # reference capture, not a copy: structural mutations replace
            # the list; add() appends and delete() writes None, both benign
            chunks_snapshot = self._chunks
            # closed-loop n_probe tuning: every Nth IVF batch also runs the
            # brute kernel on the same snapshot (the shadow check)
            shadow = None
            if self._ivf is not None and self.config.ivf_recall_target > 0:
                self._ivf_tune_counter += 1
                if self._ivf_tune_counter % self.config.ivf_tune_interval == 0:
                    shadow = self._run_brute(queries, vectors, self._scales, bias, k_eff)

        scores = scores.cpu().numpy()[:n_q]
        rows = rows.cpu().numpy()[:n_q]
        # the tuner compares like with like: the kernel's rows before the
        # int4 re-rank against the brute shadow, both at storage precision
        rows_raw = rows
        if host_rr and k_req > k_eff:
            scores, rows = self._host_rerank_candidates(qpad[:n_q], scores, rows, hq8, hs8, k_eff)
        if shadow is not None:
            self._tune_nprobe(rows_raw[:, :k_eff], shadow[1].cpu().numpy()[:n_q], k_eff)
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

    def _host_rerank_candidates(self, qpad, scores, rows, hq8, hs8, k: int):
        """Re-score int4 candidates from the host int8 shadow copy.

        The kernel over-fetches mult*k candidates from packed nibbles; this
        second stage removes most of the int4 quantization rank error for a
        tiny host GEMM (k2 x d per query). qpad is the metric-adjusted query
        (cosine: normalized; l2: pre-doubled, norm term re-added here)."""
        n_q = rows.shape[0]
        out_s = np.full((n_q, k), NEG_INF, np.float32)
        out_r = np.zeros((n_q, k), np.int32)
        for qi in range(n_q):
            valid = scores[qi] > NEG_INF / 2
            r = rows[qi][valid]
            if r.size == 0:
                continue
            v = hq8[r].astype(np.float32) * hs8[r][:, None]
            s = v @ qpad[qi]
            if self.metric == "l2":
                s = s - np.sum(v * v, axis=1)
            order = np.argsort(-s, kind="stable")[:k]
            out_s[qi, : order.size] = s[order]
            out_r[qi, : order.size] = r[order]
        return out_s, out_r

    def _run_search(self, queries: torch.Tensor, vectors: torch.Tensor,
                    scales: torch.Tensor | None, bias: torch.Tensor,
                    k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """IVF search when IVF is built (with the residual re-rank when
        ``ivf_rerank_multiplier > 1``, unless int4's host re-rank, which
        re-scores at a higher precision, follows), else brute."""
        if self._ivf is None:
            return self._run_brute(queries, vectors, scales, bias, k)
        mult = self.config.ivf_rerank_multiplier
        if mult > 1.0 and not self._host_rerank:
            # probe deeper, then re-score exactly: k2 pow2-bucketed, at most
            # the largest pow2 <= live_count (as JAX)
            k2 = _pow2_at_least(max(int(np.ceil(k * mult)), k), 16)
            if self.live_count < k2:
                k2 = 1 << max(self.live_count.bit_length() - 1, 0)
            if k2 > k:
                s2, r2 = self._run_ivf_search(queries, vectors, scales, bias, k2)
                flat = r2.reshape(-1).long()
                cand = self._dequantize(vectors[flat], None if scales is None else scales[flat])
                return _residual_rerank(queries, cand, bias, s2, r2, k)
        return self._run_ivf_search(queries, vectors, scales, bias, k)

    def _run_brute(self, queries, vectors, scales, bias, k: int):
        """The storage tier's brute kernel over every row. f32 storage is
        searched in bf16, as the JAX kernels cast it."""
        if self._quant:
            kernel = topk_int4_pruned if self._int4 else topk_int8_pruned
            return kernel(queries, vectors, scales, bias, k)
        x = vectors if vectors.dtype == torch.bfloat16 else vectors.to(torch.bfloat16)
        return topk_pruned(queries, x, bias, k)

    def _run_ivf_search(self, queries, vectors, scales, bias, k: int):
        """One probe plan for the whole batch (as JAX: a plan per 64-query
        tile would probe another union), then the tier's IVF kernel, which
        runs every 64-query tile on that plan. ``n_valid`` stays on the
        device."""
        from .ivf import plan_max_blocks, probe_blocks

        st = self._ivf
        br = self.config.block_rows
        total_blocks = self.capacity // br
        max_blocks = plan_max_blocks(st, queries.shape[0], total_blocks)
        margin = self.config.ivf_adaptive_margin
        adaptive = ({"adaptive_margin": margin,
                     "min_probe": min(self.config.ivf_min_probe, st.n_probe)}
                    if margin > 0 else {})
        ids, n_valid = probe_blocks(
            queries, st.centroids, st.cluster_block_start, st.cluster_block_count,
            n_probe=st.n_probe, max_cluster_blocks=st.max_cluster_blocks,
            total_blocks=total_blocks, frozen_blocks=st.frozen_blocks, max_blocks=max_blocks,
            **adaptive,
        )
        if self._quant:
            kernel = ivf_topk_int4_dma if self._int4 else ivf_topk_int8_dma
            return kernel(queries, vectors, scales, bias, ids, n_valid, k, block_rows=br)
        x = vectors if vectors.dtype == torch.bfloat16 else vectors.to(torch.bfloat16)
        return ivf_topk_dma(queries, x, bias, ids, n_valid, k, block_rows=br)

    # -- IVF -------------------------------------------------------------------

    def build_ivf(self, n_lists: int | None = None, seed: int = 0) -> None:
        """Cluster-sort the index and enable probed search (ANN). Appends
        after this call land in always-probed tail blocks; call again to
        re-freeze after heavy growth."""
        from .ivf import build_ivf_state

        with self._lock:
            self._ivf = build_ivf_state(self, n_lists=n_lists, seed=seed)

    def drop_ivf(self) -> None:
        self._ivf = None

    def _tune_nprobe(self, ivf_rows: np.ndarray, brute_rows: np.ndarray, k: int) -> None:
        """Adjust n_probe from the observed IVF-vs-brute overlap@k: grow by
        ``ivf_probe_step`` at once below the recall target, shrink only
        after three comfortable observations (target + 0.04)."""
        overlap = float(np.mean([
            len(set(ivf_rows[i]) & set(brute_rows[i])) / max(k, 1)
            for i in range(ivf_rows.shape[0])
        ]))
        self._ivf_recall_est = overlap
        cfg = self.config
        with self._lock:
            st = self._ivf
            if st is None:
                return
            if overlap < cfg.ivf_recall_target and st.n_probe < st.n_lists:
                new = min(st.n_lists, max(st.n_probe + 1, int(st.n_probe * cfg.ivf_probe_step)))
                logger.info("nprobe tune: recall %.3f < %.2f → n_probe %d → %d",
                            overlap, cfg.ivf_recall_target, st.n_probe, new)
                st.n_probe = new
                self._ivf_tune_streak = 0
            elif (overlap >= min(cfg.ivf_recall_target + 0.04, 1.0)
                  and st.n_probe > cfg.ivf_min_probe):
                self._ivf_tune_streak += 1
                if self._ivf_tune_streak >= 3:
                    new = max(cfg.ivf_min_probe, int(st.n_probe / cfg.ivf_probe_step))
                    if new < st.n_probe:
                        logger.info("nprobe tune: recall %.3f comfortable ×%d → n_probe %d → %d",
                                    overlap, self._ivf_tune_streak, st.n_probe, new)
                        st.n_probe = new
                    self._ivf_tune_streak = 0
            else:
                self._ivf_tune_streak = 0

    # -- dequantized views ---------------------------------------------------

    def _dequantize(self, vectors: torch.Tensor, scales: torch.Tensor | None) -> torch.Tensor:
        if self._int4:
            return unpack_int4(vectors).float() * scales[:, None]
        if self._int8:
            return vectors.float() * scales[:, None]
        return vectors.float()

    def dequantized_vectors(self) -> torch.Tensor:
        """f32 view of the stored vectors ``[capacity, d_pad]`` (4x the int8
        bytes; use ``dequantized_rows`` or ``dequantize_take`` at scale)."""
        return self._dequantize(self._vectors, self._scales)

    def dequantized_rows(self, start: int, count: int) -> torch.Tensor:
        """f32 view of rows [start, start + count)."""
        sl = slice(start, start + count)
        return self._dequantize(self._vectors[sl], None if self._scales is None else self._scales[sl])

    def dequantize_take(self, rows) -> torch.Tensor:
        """f32 gather of an arbitrary row subset."""
        idx = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        scales = None if self._scales is None else self._scales[idx]
        return self._dequantize(self._vectors[idx], scales)

    def dequantize_take_padded(self, rows: np.ndarray) -> tuple[torch.Tensor, int]:
        """``dequantize_take`` over a gather index padded to a pow2 bucket
        (at least 4096, repeating the first row), as the JAX index pads
        it. Returns (padded [B, d_pad] f32, n_valid)."""
        rows = np.asarray(rows, np.int64)
        n = len(rows)
        bucket = _pow2_at_least(max(n, 1), 4096)
        if bucket > n:
            rows = np.concatenate([rows, np.full(bucket - n, rows[0] if n else 0, np.int64)])
        return self.dequantize_take(rows), n

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
        """Device bytes of vectors, filter columns and bias; the scales are
        left out, as the JAX index counts."""
        return sum(t.numel() * t.element_size() for t in (self._vectors, self._cols, self._bias))

    def iter_live(self):
        for c in self._chunks:
            if c is not None:
                yield c


def _residual_rerank(queries: torch.Tensor, cand: torch.Tensor, bias: torch.Tensor,
                     approx_scores: torch.Tensor, rows: torch.Tensor, k: int):
    """Exact f32 re-score of IVF candidates → the true top k of the k2
    pool. queries [Q, d_pad] (metric-prescaled), cand [Q*k2, d_pad] f32
    (the dequantized gather), approx_scores/rows [Q, k2] from the probe
    pass; padding candidates (approx <= NEG_INF/2) stay NEG_INF, so they
    cannot duplicate real rows. Ties go to the lower candidate slot."""
    q_n, k2 = rows.shape
    if queries.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    s = torch.einsum("qd,qkd->qk", queries.float(), cand.reshape(q_n, k2, -1))
    s = s + bias[rows.long()]
    s = torch.where(approx_scores > NEG_INF / 2, s, torch.full_like(s, NEG_INF))
    top_s, top_i = torch.sort(s, dim=1, descending=True, stable=True)
    return top_s[:, :k].contiguous(), torch.gather(rows, 1, top_i[:, :k]).contiguous()


def _filter_bias(cols: torch.Tensor, bias: torch.Tensor, filt: CompiledFilter) -> torch.Tensor:
    """Join a compiled metadata mask into the additive bias. A row already
    at NEG_INF that the filter also drops overflows to -inf, as in JAX."""
    drop = torch.full_like(bias, NEG_INF).masked_fill_(filt.mask(cols), 0.0)
    return bias + drop
