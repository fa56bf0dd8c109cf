"""IVF probed-block top-k: the exact masked top-k over the blocks a probe
plan lists.

Counterpart of ``youtu_rag_tpu/ops/ivf.py``'s DMA kernels
(``pallas_ivf_topk_dma``, ``pallas_ivf_topk_int8_dma``,
``pallas_ivf_topk_int4_dma``). The contract is theirs:

- rows: the exact top k over the rows of ``block_ids[:n_valid]`` only;
  entry ``b`` covers rows ``[b * block_rows, (b + 1) * block_rows)`` and
  entries past ``n_valid`` are never read;
- order: the TPU kernels' walk, (score desc, probe position asc, row in
  block asc), that is (score desc, virtual row v asc), v counting the
  probed rows in ``block_ids`` order; with the ids ascending, as the probe
  plan lists them, this is (score desc, row asc);
- a row scoring ``NEG_INF`` (a tombstone) or ``-inf`` (a filtered
  tombstone) never enters. The slots no live row fills (fewer than k live
  rows probed) hold JAX's fill ``(NEG_INF, r)``: L is the probe position
  of the last block with a live row, and r the row of the query's best
  live entry (in the order above) in a block probed before L, or 0 where
  there is none (and where no block has a live row). JAX's kernel merges
  every block with a live row while its lists are not full, and each
  merge's dead picks repeat the running list's top entry;
- scores: bf16 ``f32(bf16 q) · f32(bf16 x) + bias``; int8 and int4 the
  exact integer dot of ``quantize_rows_int8(queries)`` with the stored
  rows (int4: the unpacked nibbles against the full-width queries), then
  ``f32(acc) * (qs[q] * xs[row]) + bias[row]``, rounded op by op;
- inputs: what JAX takes, on every device: any ``block_rows`` that divides
  N, any d % 128 == 0 (int4: the packed width d/2 % 128 == 0) and k, bias
  and scales at any offset (on CUDA each entry picks a shared-memory plan
  for (d, k), ``ops/topk.py::scan_plan``).

Each wrapper launches its entry of ``csrc/ivf_topk_<tier>.cu`` for CUDA tensors,
once per tile of at most ``MAX_Q`` queries (``ops/topk.py::_query_tiles``;
none for no query), and counts the launches in its ``.launches``;
``n_valid`` stays on the device (no ``.item()``), so nothing waits between
the plan and the scan. Each makes one kernel launch per tile
(``csrc/ivf_scan_tma.cuh``: the queries' cast or quantization, the scan
and the merge, after one memset of its counters; int4 unpacks its rows'
nibbles in registers). For CPU tensors it runs its plain PyTorch version
(``*_reference``). k may exceed the probed rows (empty slots).

Also the counterparts of the per-probed-block kernels (``pallas_ivf_topk``
→ ``ivf_topk``, ``pallas_ivf_topk_int8`` → ``ivf_topk_int8``) and of the
gather fallback ``xla_ivf_topk``. Their contract is ``pallas_ivf_topk``'s,
which differs from the DMA kernels' above:

- probe position i holds block ``ids[i]``'s own top k (``ops/topk.py``'s
  per-block contract, rows offset by ``ids[i] * block_rows``); a position
  ``i >= n_valid`` scores ``NEG_INF`` throughout, so its list is
  ``(NEG_INF, ids[i] * block_rows)``;
- the merge takes ties in probe position order: (score desc, position asc,
  row in block asc), so with shuffled ids tied rows come in probe order;
- the tail: slots no live row fills repeat the first-listed block's lowest
  row that scores ``>= NEG_INF`` (``ids[0] * block_rows`` when it scores
  ``-inf`` throughout or n_valid is 0), not row 0; with no live row, block
  0 all ``-inf`` and k a multiple of 128 the last slot comes from position
  1 (or is ``(-inf, ids[0] * block_rows)`` for a one-block plan), with k
  not a multiple of 128 it is the pad's ``(NEG_INF, 0)``;
- any ``block_rows >= k`` that divides N, bias and scales at any offset.

On CUDA the merged call (``candidates=False``) launches
``csrc/ivf_topk_<tier>.cu``'s ``ivf_blocks_bf16`` / ``ivf_blocks_int8`` (the
DMA kernels' ``csrc/ivf_scan_tma.cuh`` under its ``kProbe`` flag): one
launch per tile of at most ``MAX_Q`` queries, after one memset of its
counters, with the queries' cast or quantization and the merge inside; no
``torch.sort``. ``candidates=True`` (the port's own inspection path)
launches ``csrc/topk_blocks.cu``'s ``ivf_topk_blocks_*`` entries and
returns their unmerged ``[max_blocks, q, k_pad]`` lists.
"""

from __future__ import annotations

import torch

from .precision import f32_matmul
from .topk import (
    NEG_INF,
    _bf16_scores,
    _blocks_of,
    _blocks_tiles,
    _check_blocks,
    _check_cuda,
    _check_k,
    _device_of,
    _exact_dot,
    _ring_tiles,
    _scaled_scores,
    _sorted_topk,
    quantize_rows_int8,
    unpack_int4,
)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _probed_rows(block_ids: torch.Tensor, n_valid, block_rows: int) -> torch.Tensor:
    """Stored rows of ``block_ids[:n_valid]`` in probe order: virtual row v
    is row ``ids[v // block_rows] * block_rows + v % block_rows`` (int64)."""
    nv = max(0, min(int(n_valid), block_ids.shape[0]))
    ids = block_ids[:nv].long()
    return (ids[:, None] * block_rows
            + torch.arange(block_rows, device=ids.device)[None, :]).reshape(-1)


def _probed_topk(scores: torch.Tensor, rows: torch.Tensor, k: int, block_rows: int):
    """(score desc, v asc) top k of ``scores`` [q, len(rows)], column v the
    virtual row v of ``rows``; the slots without a live row hold JAX's fill
    (module docstring)."""
    qn = scores.shape[0]
    out_s = torch.full((qn, k), NEG_INF, dtype=torch.float32, device=scores.device)
    out_i = torch.zeros((qn, k), dtype=torch.int32, device=scores.device)
    if not rows.numel():
        return out_s, out_i
    s, v = torch.sort(scores, dim=1, descending=True, stable=True)
    m = min(k, rows.numel())
    s, v = s[:, :m], v[:, :m]
    live = s > NEG_INF
    out_s[:, :m] = torch.where(live, s, torch.full_like(s, NEG_INF))
    out_i[:, :m] = torch.where(live, rows[v].to(torch.int32), 0)
    live_cols = (scores > NEG_INF).any(0).nonzero()
    if live_cols.numel():
        # the best live entry in a block probed before the last one with a live row
        before = live & (v < int(live_cols.max()) // block_rows * block_rows)
        first = v.gather(1, before.int().argmax(1, keepdim=True))[:, 0]
        fill = torch.where(before.any(1), rows[first].to(torch.int32), 0)
        out_i = torch.where(out_s > NEG_INF, out_i, fill[:, None])
    return out_s, out_i


def ivf_topk_dma_reference(queries, database, bias, block_ids, n_valid, k: int, *,
                           block_rows: int):
    """Plain PyTorch version of the bf16 kernel: gather the valid blocks in
    probe order, score them (``topk_pruned_reference``'s arithmetic),
    stable sort."""
    rows = _probed_rows(block_ids, n_valid, block_rows)
    q = queries.to(torch.bfloat16).float()
    x = database[rows].to(torch.bfloat16).float()
    with f32_matmul():
        scores = q @ x.T
    return _probed_topk(scores + bias.float()[rows][None, :], rows, k, block_rows)


def _scaled_reference(queries, x_int, x_max, db_scales, bias, rows, k, block_rows):
    qq, qs = quantize_rows_int8(queries)
    acc = _exact_dot(qq, x_int, x_max)
    scores = acc * (qs[:, None] * db_scales.float()[rows][None, :]) + bias.float()[rows][None, :]
    return _probed_topk(scores, rows, k, block_rows)


def ivf_topk_int8_dma_reference(queries, database_q, db_scales, bias, block_ids, n_valid,
                                k: int, *, block_rows: int):
    """Plain PyTorch version of the int8 kernel."""
    rows = _probed_rows(block_ids, n_valid, block_rows)
    return _scaled_reference(queries, database_q[rows], 127, db_scales, bias, rows, k,
                             block_rows)


def ivf_topk_int4_dma_reference(queries, database_p, db_scales, bias, block_ids, n_valid,
                                k: int, *, block_rows: int):
    """Plain PyTorch version of the int4 kernel: the int8 one over the
    unpacked nibbles of the probed rows."""
    rows = _probed_rows(block_ids, n_valid, block_rows)
    return _scaled_reference(queries, unpack_int4(database_p[rows]), 7, db_scales, bias, rows, k,
                             block_rows)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _check_plan(name: str, n: int, block_ids: torch.Tensor, n_valid: torch.Tensor,
                block_rows: int, device) -> torch.Tensor:
    """The plan's checks (JAX asks only that block_rows divide the rows);
    returns n_valid as an int32 [1] tensor."""
    if block_rows < 1 or n % block_rows:
        raise ValueError(f"{name}: block_rows={block_rows} must divide the {n} rows")
    return _check_ids(name, block_ids, n_valid, device)


def _check_ids(name: str, block_ids: torch.Tensor, n_valid: torch.Tensor, device) -> torch.Tensor:
    """The plan tensors' checks; returns n_valid as an int32 [1] tensor."""
    if (block_ids.dtype != torch.int32 or block_ids.dim() != 1 or not block_ids.is_contiguous()
            or block_ids.numel() < 1):
        raise ValueError(f"{name}: block_ids must be a contiguous non-empty 1-D int32 tensor")
    if not isinstance(n_valid, torch.Tensor) or n_valid.dtype != torch.int32 or n_valid.numel() != 1 or n_valid.device != device:
        raise ValueError(f"{name}: n_valid must be one int32 on {device}")
    return n_valid.reshape(1).contiguous()


def _tiles(fn, queries, x, xscale, bias, block_ids, n_valid, k: int, d: int, n: int,
           block_rows: int):
    """``fn``'s entry of ``csrc/ivf_topk_<tier>.cu`` over MAX_Q-query tiles."""
    nv = _check_plan(fn.__name__, n, block_ids, n_valid, block_rows, x.device)
    return _ring_tiles(fn, queries, x, xscale, bias, k, d, n, block_rows, block_ids, nv)


def ivf_topk_dma(queries: torch.Tensor, database: torch.Tensor, bias: torch.Tensor,
                 block_ids: torch.Tensor, n_valid, k: int, *, block_rows: int):
    """Exact masked top-k over the bf16 rows of ``block_ids[:n_valid]``
    (``pallas_ivf_topk_dma``): (scores [q, k] f32 desc, rows [q, k] int32).

    queries [q, d] float (cast to bf16), database [N, d] bf16 contiguous with
    d % 128 == 0 and N % block_rows == 0, bias [N] f32, block_ids int32
    [max_blocks], n_valid an int32 scalar tensor; k >= 1; block_rows >= 1
    and bias at any offset, as JAX."""
    _check_k("ivf_topk_dma", k)
    if _device_of("ivf_topk_dma", queries, database, bias, block_ids) == "cpu":
        return ivf_topk_dma_reference(queries, database, bias, block_ids, n_valid, k,
                                      block_rows=block_rows)
    d = database.shape[1]
    n = _check_cuda("ivf_topk_dma", queries, database, bias, torch.bfloat16, d)
    return _tiles(ivf_topk_dma, queries, database, None, bias, block_ids, n_valid, k, d, n,
                  block_rows)


def ivf_topk_int8_dma(queries: torch.Tensor, database_q: torch.Tensor, db_scales: torch.Tensor,
                      bias: torch.Tensor, block_ids: torch.Tensor, n_valid, k: int, *,
                      block_rows: int):
    """The int8 form (``pallas_ivf_topk_int8_dma``): database_q [N, d] int8,
    db_scales [N] f32; queries quantized per row as ``quantize_rows_int8``
    does (on CUDA inside the kernel)."""
    _check_k("ivf_topk_int8_dma", k)
    if _device_of("ivf_topk_int8_dma", queries, database_q, db_scales, bias, block_ids) == "cpu":
        return ivf_topk_int8_dma_reference(queries, database_q, db_scales, bias, block_ids,
                                           n_valid, k, block_rows=block_rows)
    d = database_q.shape[1]
    n = _check_cuda("ivf_topk_int8_dma", queries, database_q, bias, torch.int8, d, db_scales)
    return _tiles(ivf_topk_int8_dma, queries, database_q, db_scales, bias, block_ids, n_valid,
                  k, d, n, block_rows)


def ivf_topk_int4_dma(queries: torch.Tensor, database_p: torch.Tensor, db_scales: torch.Tensor,
                      bias: torch.Tensor, block_ids: torch.Tensor, n_valid, k: int, *,
                      block_rows: int):
    """The int4 form (``pallas_ivf_topk_int4_dma``): database_p [N, d/2]
    packed nibbles with (d/2) % 128 == 0, db_scales [N] f32 (amax/7);
    queries quantized per row as ``quantize_rows_int8`` does (on CUDA
    inside the kernel)."""
    _check_k("ivf_topk_int4_dma", k)
    if _device_of("ivf_topk_int4_dma", queries, database_p, db_scales, bias, block_ids) == "cpu":
        return ivf_topk_int4_dma_reference(queries, database_p, db_scales, bias, block_ids,
                                           n_valid, k, block_rows=block_rows)
    d = 2 * database_p.shape[1]
    n = _check_cuda("ivf_topk_int4_dma", queries, database_p, bias, torch.int8, d, db_scales)
    return _tiles(ivf_topk_int4_dma, queries, database_p, db_scales, bias, block_ids, n_valid,
                  k, d, n, block_rows)


def xla_ivf_topk(queries: torch.Tensor, database: torch.Tensor, bias: torch.Tensor,
                 block_ids: torch.Tensor, n_valid, k: int, *, block_rows: int = 1024):
    """JAX's gather fallback ``xla_ivf_topk``: every listed block gathered,
    the positions at and past ``n_valid`` given a ``NEG_INF`` bias, the bf16
    scores' top k over the flat [max_blocks * block_rows] positions (ties to
    the lower position), each position p mapped to row
    ``ids[p // block_rows] * block_rows + p % block_rows``. Every entry of
    ``block_ids`` must lie in the index, those past ``n_valid`` too (the
    probe plan lists the unselected blocks there). Plain PyTorch on every
    device. Returns (scores [q, k] f32 desc, rows [q, k] int32)."""
    mb = block_ids.shape[0]
    if not 1 <= k <= mb * block_rows:
        raise ValueError(f"xla_ivf_topk: k={k} outside 1..{mb * block_rows}, the listed rows")
    ids = block_ids.to(torch.int32)
    offs = torch.arange(block_rows, device=ids.device)
    rows = (ids.long()[:, None] * block_rows + offs[None, :]).reshape(-1)
    nv = torch.as_tensor(n_valid, device=ids.device).reshape(())
    valid = torch.arange(mb, device=ids.device) < nv
    sel_b = torch.where(valid[:, None], bias.float()[rows].reshape(mb, block_rows),
                        torch.full((), NEG_INF, device=ids.device))
    top_s, pos = _sorted_topk(_bf16_scores(queries, database[rows], sel_b.reshape(-1)), k)
    pos = pos.long()
    return top_s, ids[pos // block_rows] * block_rows + (pos % block_rows).to(torch.int32)


def _probed_blocks(score_rows, block_ids: torch.Tensor, n_valid, k: int, block_rows: int,
                   candidates: bool):
    """The per-probed-block plain path: ``score_rows(rows)`` gives the
    [q, len(rows)] scores of the stored rows of ``block_ids[:n_valid]``; the
    positions past them score NEG_INF throughout and are not read."""
    mb = block_ids.shape[0]
    nv = max(0, min(int(n_valid), mb))
    ids = block_ids.to(torch.int32)
    offs = torch.arange(block_rows, device=ids.device)
    scores = score_rows((ids[:nv].long()[:, None] * block_rows + offs[None, :]).reshape(-1))
    full = torch.full((scores.shape[0], mb * block_rows), NEG_INF, dtype=torch.float32,
                      device=scores.device)
    full[:, : nv * block_rows] = scores
    # ids * block_rows in int32, as the TPU kernel's fill computes it
    return _blocks_of(full, k, block_rows, ids * block_rows, candidates)


def ivf_topk_reference(queries, database, bias, block_ids, n_valid, k: int, *,
                       block_rows: int = 1024, candidates: bool = False):
    """Plain PyTorch version of ``ivf_topk``: the bf16 scores of the valid
    blocks' rows (``_bf16_scores``), then the per-block selection."""
    _check_blocks("ivf_topk", database.shape[0], database.shape[1], k, block_rows)
    return _probed_blocks(lambda rows: _bf16_scores(queries, database[rows], bias[rows]),
                          block_ids, n_valid, k, block_rows, candidates)


def ivf_topk_int8_reference(queries, database_q, db_scales, bias, block_ids, n_valid, k: int, *,
                            block_rows: int = 4096, candidates: bool = False):
    """Plain PyTorch version of ``ivf_topk_int8``: the int8 scores of the
    valid blocks' rows (``_scaled_scores``), then the per-block selection."""
    _check_blocks("ivf_topk_int8", database_q.shape[0], database_q.shape[1], k, block_rows)
    return _probed_blocks(
        lambda rows: _scaled_scores(queries, database_q[rows], 127, db_scales[rows], bias[rows]),
        block_ids, n_valid, k, block_rows, candidates)


def ivf_topk(queries: torch.Tensor, database: torch.Tensor, bias: torch.Tensor,
             block_ids: torch.Tensor, n_valid, k: int, *, block_rows: int = 1024,
             candidates: bool = False):
    """Masked top-k through per-probed-block candidates
    (``pallas_ivf_topk``): (scores [q, k] f32 desc, rows [q, k] int32), or
    with ``candidates`` the unmerged lists [max_blocks, q, k_pad] (module
    docstring).

    queries [q, d] (cast to bf16); database [N, d] (bf16; another float
    type is cast) with d % 128 == 0 and N % block_rows == 0; bias [N] f32;
    block_ids int32 [max_blocks], whose entries lie in the index, those
    past n_valid too (the probe plan makes them so); n_valid an int32
    scalar tensor, which stays on the device; 1 <= k <= block_rows. On
    CUDA: one launch per MAX_Q queries (module docstring)."""
    n, d = database.shape
    _check_blocks("ivf_topk", n, d, k, block_rows)
    if _device_of("ivf_topk", queries, database, bias, block_ids) == "cpu":
        return ivf_topk_reference(queries, database, bias, block_ids, n_valid, k,
                                  block_rows=block_rows, candidates=candidates)
    x = database.to(torch.bfloat16).contiguous()
    n = _check_cuda("ivf_topk", queries, x, bias, torch.bfloat16, d)
    nv = _check_ids("ivf_topk", block_ids, n_valid, x.device)
    if candidates:
        return _blocks_tiles(ivf_topk, "ivf_topk_blocks_bf16", queries, False, x, None, bias, k,
                             d, n, block_rows, block_ids, nv)
    return _ring_tiles(ivf_topk, queries, x, None, bias, k, d, n, block_rows, block_ids, nv)


def ivf_topk_int8(queries: torch.Tensor, database_q: torch.Tensor, db_scales: torch.Tensor,
                  bias: torch.Tensor, block_ids: torch.Tensor, n_valid, k: int, *,
                  block_rows: int = 4096, candidates: bool = False):
    """The int8 form of ``ivf_topk`` (``pallas_ivf_topk_int8``):
    database_q [N, d] int8, db_scales [N] f32; queries quantized per row as
    ``quantize_rows_int8`` does (the merged call on CUDA inside the
    kernel)."""
    n, d = database_q.shape
    _check_blocks("ivf_topk_int8", n, d, k, block_rows)
    if _device_of("ivf_topk_int8", queries, database_q, db_scales, bias, block_ids) == "cpu":
        return ivf_topk_int8_reference(queries, database_q, db_scales, bias, block_ids, n_valid,
                                       k, block_rows=block_rows, candidates=candidates)
    n = _check_cuda("ivf_topk_int8", queries, database_q, bias, torch.int8, d, db_scales)
    nv = _check_ids("ivf_topk_int8", block_ids, n_valid, database_q.device)
    if candidates:
        return _blocks_tiles(ivf_topk_int8, "ivf_topk_blocks_int8", queries, True, database_q,
                             db_scales, bias, k, d, n, block_rows, block_ids, nv)
    return _ring_tiles(ivf_topk_int8, queries, database_q, db_scales, bias, k, d, n, block_rows,
                       block_ids, nv)


ivf_topk_dma.launches = 0
ivf_topk_int8_dma.launches = 0
ivf_topk_int4_dma.launches = 0
ivf_topk.launches = 0
ivf_topk_int8.launches = 0
