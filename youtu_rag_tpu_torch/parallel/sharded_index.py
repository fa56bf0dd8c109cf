"""Sharded vector index: ``youtu_rag_tpu/parallel/sharded_index.py`` in PyTorch.

Index rows shard over a mesh axis (``db``, or a tuple such as ``("dcn",
"ici")`` on a hybrid mesh) in contiguous ranges: with capacity C and S
shards, shard s holds rows ``s * C/S .. (s + 1) * C/S - 1``. Queries are
replicated; each shard runs its tier's top-k kernel (``ops.topk``:
``topk_pruned``, ``topk_int8_pruned``, ``topk_int4_pruned``; with IVF the
DMA scans of ``ops.ivf``) on its own rows, one launch per shard; local row
i of shard s is global row ``i + s * C/S``; then the [q, S·k] candidates,
shard-major, merge into the top k by a stable sort, ties to the lower
position as ``jax.lax.top_k`` takes them. On CUDA the index always
launches the kernels: there is no plain run on the card, where JAX's
``_backend`` picks XLA for small shards.

The mesh (``parallel.mesh``) is one of two forms, and the index computes the
same with both:

- a **local mesh**: the shards live on one device, as views of one
  ``[capacity, d]`` tensor, so every array operation of
  ``DeviceVectorIndex`` (appends, growth, compaction, permutations,
  snapshots) runs on it unchanged, and growth never moves a row: JAX's
  shard of a row is ``row // (C/S)``, so when C doubles rows change shard
  (XLA moves them silently), and here the views simply move with C;
- a **group mesh** over ``torch.distributed``: each process holds only its
  own shards' rows (a contiguous range, on one device), and the host state
  (chunks, maps, the int4 shadow) is replicated on every process, SPMD as
  in JAX. Growth and cross-process permutations (compaction) redistribute
  rows explicitly around a ring of ``batch_isend_irecv`` (JAX's ppermute
  ring); block-diagonal permutations (the IVF cluster sort) stay local;
  the candidate merge is an all-gather, the only collective a search runs;
  gathers of arbitrary rows (the k-means sample, snapshots) are a MAX
  all-reduce over a buffer of each type's least value, which is exact.
  Compaction keeps the capacity and parks dead rows as a ``NEG_INF`` tail.

IVF (``build_ivf``): k-means over all rows, then a stable cluster sort
within each shard (a block-diagonal permutation), per-shard cluster →
block ranges and per-shard frozen tails; a search plans and scans each
shard on its own (``probe_blocks`` with the adaptive margin), the plan
sized for the least-filled shard, and merges as the brute path does. As in
JAX, the sharded index takes no residual re-rank (``ivf_rerank_multiplier``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import IndexConfig
from ..index.device_index import DeviceVectorIndex, _pow2_at_least
from ..index.metadata import MISSING_I32
from ..ops.ivf import ivf_topk_dma, ivf_topk_int4_dma, ivf_topk_int8_dma
from ..ops.topk import NEG_INF, topk_int4_pruned, topk_int8_pruned, topk_pruned
from ..utils.log import get_logger
from .mesh import Mesh, _default_devices, get_mesh

logger = get_logger("parallel.sharded_index")


class ShardLayout:
    """Where an index's shards lie for this process: ``n_shards`` in all,
    ``n_local`` of them from shard ``first`` on ``device``; on a group mesh
    the process group, the number of processes (``n_blocks``, each holding
    as many shards) and this process's place among them (``block``)."""

    def __init__(self, mesh: Mesh, axis: str | tuple[str, ...] = "db"):
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        devs, procs = mesh.layout(axes)
        self.n_shards = devs.shape[1]
        self.group = mesh.group(axes)
        me = dist.get_rank() if mesh.distributed else 0
        mine_rows = [r for r in range(procs.shape[0]) if me in procs[r]]
        if not mine_rows:
            raise ValueError(f"this process holds no shard of {mesh}")
        owners, row_devs = procs[mine_rows[0]], devs[mine_rows[0]]
        mine = np.flatnonzero(owners == me)
        self.first, self.n_local = int(mine[0]), len(mine)
        if not np.array_equal(mine, np.arange(self.first, self.first + self.n_local)):
            raise ValueError(f"this process's shards {mine.tolist()} are not contiguous")
        devices = {row_devs[j] for j in mine}
        if len(devices) != 1:
            raise ValueError(f"a process's shards must lie on one device, got "
                             f"{sorted(map(str, devices))}; across cards run one process per "
                             "card (a group mesh)")
        self.device = devices.pop()
        if self.group is None:
            self.n_blocks, self.block = 1, 0
            return
        # the group gathers in rank order: shards must ascend with the rank
        procs_in_order = owners[:: self.n_local]
        if not (np.array_equal(np.repeat(procs_in_order, self.n_local), owners)
                and np.all(np.diff(procs_in_order) > 0)):
            raise ValueError("every process must hold as many shards, in rank order")
        self.n_blocks = dist.get_world_size(self.group)
        self.block = self.first // self.n_local

    def merge(self, parts: list[tuple[torch.Tensor, torch.Tensor]], k: int):
        """Top k of the candidates ``parts`` (this process's shards, in
        order: (scores [q, k_s] f32, global rows [q, k_s] int32) each), with
        every other process's, shard-major; ties to the lower position."""
        s = torch.cat([p[0] for p in parts], dim=1)
        i = torch.cat([p[1] for p in parts], dim=1)
        if self.group is not None:
            ss = [torch.empty_like(s) for _ in range(self.n_blocks)]
            ii = [torch.empty_like(i) for _ in range(self.n_blocks)]
            dist.all_gather(ss, s.contiguous(), group=self.group)
            dist.all_gather(ii, i.contiguous(), group=self.group)
            s, i = torch.cat(ss, dim=1), torch.cat(ii, dim=1)
        top_s, pos = torch.sort(s, dim=1, descending=True, stable=True)
        return top_s[:, :k].contiguous(), torch.gather(i, 1, pos[:, :k]).contiguous()


class ShardedTopK:
    """The sharded brute search (``make_sharded_topk``): each of this
    process's shards through the tier's kernel, then ``ShardLayout.merge``.
    ``vectors``, ``scales`` and ``bias`` are this process's rows (all of
    them on a local mesh); returns (scores [q, k] f32, global rows [q, k]
    int32)."""

    def __init__(self, layout: ShardLayout):
        self.layout = layout

    def _run(self, kernel, queries, vectors, scales, bias, k: int):
        lay = self.layout
        rows = vectors.shape[0] // lay.n_local
        k_s = min(k, rows)
        parts = []
        for j in range(lay.n_local):
            sl = slice(j * rows, (j + 1) * rows)
            args = (vectors[sl],) if scales is None else (vectors[sl], scales[sl])
            s, i = kernel(queries, *args, bias[sl], k_s)
            parts.append((s, i + (lay.first + j) * rows))
        return lay.merge(parts, k)

    def __call__(self, queries, vectors, bias, k: int):
        """bf16 rows (f32 storage is searched in bf16, as the kernels cast it)."""
        x = vectors if vectors.dtype == torch.bfloat16 else vectors.to(torch.bfloat16)
        return self._run(topk_pruned, queries, x, None, bias, k)

    def int8(self, queries, vectors, scales, bias, k: int):
        return self._run(topk_int8_pruned, queries, vectors, scales, bias, k)

    def int4(self, queries, vectors, scales, bias, k: int):
        return self._run(topk_int4_pruned, queries, vectors, scales, bias, k)


def mesh_device(mesh: Mesh, device=None) -> torch.device:
    """The device the index shards of ``mesh``'s ``db`` axis lie on for this
    process; ``device``, if given, must name it."""
    got = ShardLayout(mesh).device
    if device is not None and torch.device(device) != got:
        raise ValueError(f"device {device} is not the mesh's {got}")
    return got


def make_sharded_topk(mesh: Mesh, axis: str | tuple[str, ...] = "db") -> ShardedTopK:
    """The sharded search over ``mesh``'s ``axis``: per-shard top-k + merge
    (``.int8`` and ``.int4`` for the quantized tiers)."""
    return ShardedTopK(ShardLayout(mesh, axis))


_FILLS = {"_vectors": 0, "_cols": MISSING_I32, "_bias": NEG_INF, "_scales": 0.0}


def _least(dtype: torch.dtype):
    return -float("inf") if dtype.is_floating_point else torch.iinfo(dtype).min


def default_index_mesh(axis: str = "db") -> Mesh:
    """The mesh a ``ShardedVectorIndex`` takes when given none: one shard
    on each process's card, i.e. one shard a card of a process group and a
    single shard in one process (a process's shards share one device, so a
    single process cannot span its cards). S shards on one card are
    ``get_mesh({axis: S}, devices=[card] * S)``. Raises without CUDA."""
    return get_mesh({axis: -1}, devices=_default_devices()[:1])


class ShardedVectorIndex(DeviceVectorIndex):
    """``DeviceVectorIndex`` with rows sharded over ``mesh``'s ``axis``
    (default: ``default_index_mesh``, one shard on each process's card).
    ``axis`` may be a tuple of mesh axes, e.g. ``("dcn", "ici")`` on a
    hybrid mesh: rows shard jointly over both, and the candidate merge is
    the only collective that crosses processes."""

    def __init__(self, dim: int, config: IndexConfig | None = None, mesh: Mesh | None = None,
                 axis: str | tuple[str, ...] = "db"):
        if mesh is None:
            if not isinstance(axis, str):
                raise ValueError("tuple axes need an explicit mesh (get_hybrid_mesh)")
            mesh = default_index_mesh(axis)
        self.mesh = mesh
        self.axis = axis
        self._layout = ShardLayout(mesh, axis)
        self.n_shards = self._layout.n_shards
        # the group form: this process holds its own shards' rows only
        self._multi_process = mesh.distributed
        cfg = config or IndexConfig()
        # capacity splits evenly into shards of whole blocks
        cfg = cfg.model_copy(update={
            "min_capacity": _pow2_at_least(cfg.min_capacity, cfg.block_rows * self.n_shards)})
        self._sharded_topk = ShardedTopK(self._layout)
        super().__init__(dim, cfg, device=self._layout.device)

    def _reset(self) -> None:
        # keeps mesh, axis and layout: clear() and compact() stay on the mesh
        super()._reset()
        if self.capacity % (self.n_shards * self.config.block_rows):
            raise ValueError(f"capacity {self.capacity} does not split into {self.n_shards} "
                             f"shards of whole {self.config.block_rows}-row blocks")
        self._clear_ivf_state()

    def _clear_ivf_state(self) -> None:
        """One place that forgets the IVF layout (reset, compact)."""
        self._ivf = None
        self._ivf_frozen = None  # np.int32 [S]: each shard's frozen blocks
        self._ivf_frozen_min = 0
        self._ivf_local_blocks = 0

    # next-tier warming would launch the single-device brute scan on one
    # [capacity, d] placeholder; a search here runs one launch per shard on
    # its rows (on a group mesh, this process's rows only), so neither the
    # launches nor their memory match: no-ops, as in the JAX index
    def _maybe_warm_next_tier(self) -> None:
        return

    def ensure_tier_ready(self, cap: int) -> None:
        return

    # -- placement -------------------------------------------------------

    @property
    def rows_per_shard(self) -> int:
        return self.capacity // self.n_shards

    @property
    def _row0(self) -> int:
        """The first global row this process holds."""
        return self._layout.first * self.rows_per_shard if self._multi_process else 0

    def _device_rows(self) -> int:
        return self._layout.n_local * self.rows_per_shard if self._multi_process else self.capacity

    def _write_rows(self, start: int, vec, cols, bias, scales) -> None:
        if not self._multi_process:
            return super()._write_rows(start, vec, cols, bias, scales)
        lo = self._row0
        a, b = max(start, lo), min(start + bias.shape[0], lo + self._device_rows())
        if a < b:
            sl = slice(a - start, b - start)
            super()._write_rows(a - lo, vec[sl], cols[sl], bias[sl],
                                None if scales is None else scales[sl])

    def _set_rows(self, name: str, rows: list[int], values) -> None:
        if not self._multi_process:
            return super()._set_rows(name, rows, values)
        r = np.asarray(rows, np.int64) - self._row0
        keep = np.flatnonzero((r >= 0) & (r < self._device_rows()))
        if keep.size:
            if isinstance(values, torch.Tensor):
                values = values[torch.as_tensor(keep, device=values.device)]
            super()._set_rows(name, r[keep].tolist(), values)

    def _host_bias(self, bias: np.ndarray) -> torch.Tensor:
        lo = self._row0
        return super()._host_bias(np.ascontiguousarray(bias[lo : lo + self._device_rows()]))

    def _take_global(self, rows, names: tuple[str, ...]) -> list[torch.Tensor]:
        """Rows of the named arrays wherever they lie, on every process: each
        fills the rows it holds into a buffer of the type's least value and
        a MAX all-reduce joins them (exact: every other slot is the least)."""
        r = np.asarray(rows, np.int64) - self._row0
        keep = np.flatnonzero((r >= 0) & (r < self._device_rows()))
        pos = torch.as_tensor(keep, device=self.device)
        src = torch.as_tensor(r[keep], device=self.device)
        out = []
        for name in names:
            t = getattr(self, name)
            buf = torch.full((len(r), *t.shape[1:]), _least(t.dtype), dtype=t.dtype,
                             device=self.device)
            buf[pos] = t[src]
            dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=self._layout.group)
            out.append(buf)
        return out

    def _stored_rows(self, rows):
        if not self._multi_process:
            return super()._stored_rows(rows)
        names = ("_vectors", "_cols") + (("_scales",) if self._quant else ())
        got = self._take_global(rows, names)
        vec = got[0] if self._quant else got[0].float()
        scales = got[2].cpu().numpy() if self._quant else None
        return vec.cpu().numpy(), scales, got[1].cpu().numpy()

    def dequantize_take(self, rows) -> torch.Tensor:
        if not self._multi_process:
            return super().dequantize_take(rows)
        got = self._take_global(rows, ("_vectors",) + (("_scales",) if self._quant else ()))
        return self._dequantize(got[0], got[1] if self._quant else None)

    def dequantized_rows(self, start: int, count: int) -> torch.Tensor:
        if not self._multi_process:
            return super().dequantized_rows(start, count)
        return self.dequantize_take(np.arange(start, start + count))

    def dequantized_vectors(self) -> torch.Tensor:
        return self.dequantized_rows(0, self.capacity)

    # -- moving rows -------------------------------------------------------

    def _grow(self, need_rows: int) -> None:
        if not self._multi_process:
            return super()._grow(need_rows)
        new_cap = self.capacity
        while new_cap < need_rows:
            new_cap *= 2
        if new_cap == self.capacity:
            return
        logger.info("index grow %d -> %d rows (process group)", self.capacity, new_cap)
        old_cap, old_rows = self.capacity, self._device_rows()
        src = np.arange(new_cap, dtype=np.int64)
        src[old_cap:] = -1
        self.capacity = new_cap
        # rows change shard (C/S doubles): each process's new range comes
        # round the ring from the processes that held it
        self._ring_move(src, old_rows)
        if self._host_q8 is not None:
            pad = new_cap - old_cap
            self._host_q8 = np.concatenate([self._host_q8, np.zeros((pad, self.d_pad), np.int8)])
            self._host_s8 = np.concatenate([self._host_s8, np.zeros(pad, np.float32)])

    def _apply_permutation(self, idx: np.ndarray) -> None:
        """``permutation[new_row] = old_row`` over every row. Local mesh: the
        base gather. Group mesh: a local gather when every row stays with its
        process (the IVF sort), else the ring."""
        if not self._multi_process:
            return super()._apply_permutation(idx)
        idx = np.asarray(idx, np.int64)
        if self._host_q8 is not None:
            self._host_q8 = self._host_q8[idx]
            self._host_s8 = self._host_s8[idx]
        lo, n = self._row0, self._device_rows()
        if np.array_equal(idx // n, np.arange(idx.shape[0]) // n):
            return self._gather_rows(idx[lo : lo + n] - lo)
        self._ring_move(idx, n)

    def _ring_move(self, src: np.ndarray, old_rows: int) -> None:
        """New arrays in which this process's global row g holds old row
        ``src[g]`` (-1: an empty row), by JAX's ppermute ring: the processes'
        blocks (``old_rows`` rows each) rotate round the group, and at round r
        this process holds block (block - r) mod P, from which each of its
        rows takes its own. One block is in flight at a time."""
        lay = self._layout
        lo, n = self._row0, self._device_rows()
        want = np.asarray(src, np.int64)[lo : lo + n]
        held = np.where(want >= 0, want // old_rows, -1)  # the block each row comes from
        off = np.where(want >= 0, want % old_rows, 0)
        names = ["_vectors", "_cols", "_bias"] + (["_scales"] if self._quant else [])
        blocks = {name: getattr(self, name) for name in names}
        out = {name: torch.full((n, *t.shape[1:]), _FILLS[name], dtype=t.dtype,
                                device=self.device) for name, t in blocks.items()}
        for r in range(lay.n_blocks):
            dst = np.flatnonzero(held == (lay.block - r) % lay.n_blocks)
            if dst.size:
                take = torch.as_tensor(off[dst], device=self.device)
                dpos = torch.as_tensor(dst, device=self.device)
                for name in names:
                    out[name][dpos] = blocks[name][take]
            if r < lay.n_blocks - 1:
                blocks = self._ring_shift(blocks)
        for name, t in out.items():
            setattr(self, name, t)

    def _ring_shift(self, blocks: dict) -> dict:
        """Each process's blocks to the next rank of the group, the previous
        rank's in their place (``batch_isend_irecv``)."""
        lay = self._layout
        nxt = dist.get_global_rank(lay.group, (lay.block + 1) % lay.n_blocks)
        prv = dist.get_global_rank(lay.group, (lay.block - 1) % lay.n_blocks)
        got = {n: torch.empty_like(t) for n, t in blocks.items()}
        ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, lay.group, tag)
               for tag, t in enumerate(blocks.values())]
        ops += [dist.P2POp(dist.irecv, t, prv, lay.group, tag)
                for tag, t in enumerate(got.values())]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return got

    def compact(self) -> None:
        """Drop tombstones. Local mesh: the base rebuild (the capacity
        shrinks back). Group mesh: a permutation instead, live rows to the
        global front round the ring (the stored values as they are), dead
        rows an inert ``NEG_INF`` tail that appends overwrite; the capacity
        stays."""
        if not self._multi_process:
            return super().compact()
        with self._lock:
            live = [r for r, c in enumerate(self._chunks) if c is not None]
            if not live:
                self._reset()
                return
            dead = [r for r, c in enumerate(self._chunks) if c is None]
            if not dead:
                return  # nothing to reclaim: keep the arrays and the IVF
            perm = np.asarray(live + dead, np.int64)
            self._apply_permutation(np.concatenate([perm, np.arange(self.size, self.capacity)]))
            self._chunks = [self._chunks[o] for o in perm[: len(live)]]
            self._rebuild_host_maps()
            self.size = self.live_count = len(live)
            self._clear_ivf_state()

    # -- search --------------------------------------------------------------

    def _run_search(self, queries, vectors, scales, bias, k: int):
        if self._ivf is not None:
            return self._run_sharded_ivf(queries, vectors, scales, bias, k)
        return self._run_brute(queries, vectors, scales, bias, k)

    def _run_brute(self, queries, vectors, scales, bias, k: int):
        """Also the n_probe tuner's shadow check (``search``)."""
        if self._int4:
            return self._sharded_topk.int4(queries, vectors, scales, bias, k)
        if self._int8:
            return self._sharded_topk.int8(queries, vectors, scales, bias, k)
        return self._sharded_topk(queries, vectors, bias, k)

    # -- sharded IVF -----------------------------------------------------------

    def build_ivf(self, n_lists: int | None = None, seed: int = 0) -> None:
        """Global spherical k-means centroids (replicated); rows sorted by
        cluster within their shard; per-shard cluster → block ranges."""
        from ..index.ivf import IVFState, fit_and_assign

        if self.size <= 0:
            raise ValueError("cannot build IVF over an empty index")
        cfg = self.config
        n_lists = n_lists or min(cfg.n_lists, max(self.size // 64, 1))
        with self._lock:
            if self._multi_process:
                centroids, assign = self._mp_fit_assign(n_lists, seed)
            else:
                centroids, assign = fit_and_assign(self, n_lists, seed)
            rows, br, S = self.rows_per_shard, cfg.block_rows, self.n_shards
            perm_parts = []
            block_start = np.zeros((S, n_lists), np.int32)
            block_cnt = np.zeros((S, n_lists), np.int32)
            frozen = np.zeros(S, np.int32)
            for s in range(S):
                lo, hi = s * rows, min((s + 1) * rows, self.size)
                if lo >= self.size:
                    continue
                order = np.argsort(assign[lo:hi], kind="stable")
                perm_parts.append(np.arange(lo, hi)[order])
                counts = np.bincount(assign[lo:hi], minlength=n_lists)
                row_start = np.concatenate([[0], np.cumsum(counts)])
                bs = (row_start[:-1] // br).astype(np.int32)
                be = np.ceil(row_start[1:] / br).astype(np.int32)
                block_start[s] = bs
                block_cnt[s] = np.maximum(be - bs, 0) * (counts > 0)
                frozen[s] = -(-(hi - lo) // br)
            self.reorder(np.concatenate(perm_parts))
            self._ivf = IVFState(
                centroids=centroids,
                cluster_block_start=torch.from_numpy(block_start).to(self.device),
                cluster_block_count=torch.from_numpy(block_cnt).to(self.device),
                max_cluster_blocks=max(int(block_cnt.max()), 1),
                frozen_blocks=int(frozen.max()),  # informational; the plan reads per shard
                n_lists=n_lists,
                n_probe=min(cfg.n_probe, n_lists),
            )
            # appends land in the shard that owns row = size, so the fresh
            # tail differs per shard; the least-filled shard has the most
            # tail blocks, and the plan's size must cover it
            self._ivf_frozen = frozen
            self._ivf_frozen_min = int(frozen.min())
            self._ivf_local_blocks = rows // br
        logger.info("sharded IVF built: %d lists over %d rows in %d shards", n_lists, self.size, S)

    def _mp_fit_assign(self, n_lists: int, seed: int):
        """k-means on a group mesh, where no process holds every row: the
        fit sample (the same on every process) gathers to each, the fit runs
        replicated (the centroids then broadcast from the group's first
        process), and each process assigns its own rows; only the int32
        assignment travels back."""
        from ..index.ivf import fit_sample_indices
        from ..ops.kmeans import kmeans_assign, kmeans_fit

        sel = fit_sample_indices(self.size, seed)
        if sel is None:
            sel = np.arange(self.size, dtype=np.int32)
        centroids = kmeans_fit(self.dequantize_take(sel), n_lists, iters=self.config.kmeans_iters,
                               seed=seed)
        lay = self._layout
        dist.broadcast(centroids, src=dist.get_global_rank(lay.group, 0), group=lay.group)
        n, step = self._device_rows(), 1 << 20
        local = torch.cat([
            kmeans_assign(self._dequantize(self._vectors[i : i + step],
                                           None if self._scales is None
                                           else self._scales[i : i + step]), centroids)
            for i in range(0, n, step)]).to(torch.int32)
        parts = [torch.empty_like(local) for _ in range(lay.n_blocks)]
        dist.all_gather(parts, local, group=lay.group)
        return centroids, torch.cat(parts).cpu().numpy()[: self.size]

    def _run_sharded_ivf(self, queries, vectors, scales, bias, k: int):
        """Every shard plans its probed blocks with the shared centroids and
        scans them through the tier's DMA kernel; then the brute path's merge."""
        from ..index.ivf import probe_blocks

        st, lay, br = self._ivf, self._layout, self.config.block_rows
        rows, local_blocks = self.rows_per_shard, self._ivf_local_blocks
        est = (queries.shape[0] * st.n_probe * st.max_cluster_blocks
               + (local_blocks - self._ivf_frozen_min) + 4)
        max_blocks = min(_pow2_at_least(est, 8), local_blocks)
        margin = self.config.ivf_adaptive_margin
        adaptive = ({"adaptive_margin": margin,
                     "min_probe": min(self.config.ivf_min_probe, st.n_probe)}
                    if margin > 0 else {})
        parts = []
        for j in range(lay.n_local):
            s = lay.first + j
            sl = slice(j * rows, (j + 1) * rows)
            ids, n_valid = probe_blocks(
                queries, st.centroids, st.cluster_block_start[s], st.cluster_block_count[s],
                n_probe=st.n_probe, max_cluster_blocks=st.max_cluster_blocks,
                total_blocks=local_blocks, frozen_blocks=int(self._ivf_frozen[s]),
                max_blocks=max_blocks, **adaptive)
            if self._quant:
                kernel = ivf_topk_int4_dma if self._int4 else ivf_topk_int8_dma
                sc, i = kernel(queries, vectors[sl], scales[sl], bias[sl], ids, n_valid, k,
                               block_rows=br)
            else:
                x = vectors[sl]
                x = x if x.dtype == torch.bfloat16 else x.to(torch.bfloat16)
                sc, i = ivf_topk_dma(queries, x, bias[sl], ids, n_valid, k, block_rows=br)
            parts.append((sc, i + s * rows))
        return lay.merge(parts, k)
