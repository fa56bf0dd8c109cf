"""IVF probed-block top-k: the exact masked top-k over the blocks a probe
plan lists.

Counterpart of ``youtu_rag_tpu/ops/ivf.py``'s DMA kernels
(``pallas_ivf_topk_dma``, ``pallas_ivf_topk_int8_dma``,
``pallas_ivf_topk_int4_dma``). The contract is theirs:

- rows: the exact top k over the rows of ``block_ids[:n_valid]`` only;
  entry ``b`` covers rows ``[b * block_rows, (b + 1) * block_rows)`` and
  entries past ``n_valid`` are never read;
- order: (score desc, row asc); the probe plan lists its blocks in
  ascending id, so this is also the TPU kernels' probe-order walk;
- empty slots come back as ``(NEG_INF, row 0)``: a row scoring ``NEG_INF``
  (a tombstone) or ``-inf`` (a filtered tombstone) never enters;
- scores: bf16 ``f32(bf16 q) · f32(bf16 x) + bias``; int8 and int4 the
  exact integer dot of ``quantize_rows_int8(queries)`` with the stored
  rows (int4: the unpacked nibbles against the full-width queries), then
  ``f32(acc) * (qs[q] * xs[row]) + bias[row]``, rounded op by op;
- inputs: what JAX takes, on every device: any ``block_rows`` that divides
  N, any d % 128 == 0 (int4: the packed width d/2 % 128 == 0) and k, bias
  and scales at any offset (on CUDA each entry picks a shared-memory plan
  for (d, k), ``scan_plan``).

Each wrapper launches its entry of ``csrc/ivf_topk.cu`` for CUDA tensors,
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
``csrc/ivf_topk.cu``'s ``ivf_blocks_bf16`` / ``ivf_blocks_int8`` (the
DMA kernels' ``csrc/ivf_scan_tma.cuh`` under its ``kProbe`` flag): one
launch per tile of at most ``MAX_Q`` queries, after one memset of its
counters, with the queries' cast or quantization and the merge inside; no
``torch.sort``. ``candidates=True`` (the port's own inspection path)
launches ``csrc/topk_blocks.cu``'s ``ivf_topk_blocks_*`` entries and
returns their unmerged ``[max_blocks, q, k_pad]`` lists.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .topk import (
    NEG_INF,
    _bf16_scores,
    _blocks_of,
    _blocks_tiles,
    _check_blocks,
    _check_cuda,
    _check_k,
    _device_of,
    _empty,
    _exact_dot,
    _list_ctas,
    _query_tiles,
    _scaled_scores,
    _sorted_topk,
    quantize_rows_int8,
    unpack_int4,
)

_LIB = "ivf_topk"
_ENTRY = {"ivf_topk_dma": "ivf_topk_bf16", "ivf_topk_int8_dma": "ivf_topk_int8",
          "ivf_topk_int4_dma": "ivf_topk_int4", "ivf_topk": "ivf_blocks_bf16",
          "ivf_topk_int8": "ivf_blocks_int8"}
_FIRST_COLS = 16  # the per-block entries' counters past [2, tiles]: [tiles, 8 queries, 2]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _probed_rows(block_ids: torch.Tensor, n_valid, block_rows: int) -> torch.Tensor:
    """Stored rows of ``block_ids[:n_valid]``, ascending (int64)."""
    nv = max(0, min(int(n_valid), block_ids.shape[0]))
    ids = block_ids[:nv].long()
    rows = (ids[:, None] * block_rows
            + torch.arange(block_rows, device=ids.device)[None, :]).reshape(-1)
    return torch.sort(rows).values


def _probed_topk(scores: torch.Tensor, rows: torch.Tensor, k: int):
    """(score desc, row asc) top k of ``scores`` [q, len(rows)] over the
    ascending ``rows``; slots without a live row are (NEG_INF, 0)."""
    qn = scores.shape[0]
    out_s = torch.full((qn, k), NEG_INF, dtype=torch.float32, device=scores.device)
    out_i = torch.zeros((qn, k), dtype=torch.int32, device=scores.device)
    if rows.numel():
        s, order = torch.sort(scores, dim=1, descending=True, stable=True)
        m = min(k, rows.numel())
        s, r = s[:, :m], rows[order[:, :m]].to(torch.int32)
        live = s > NEG_INF
        out_s[:, :m] = torch.where(live, s, torch.full_like(s, NEG_INF))
        out_i[:, :m] = torch.where(live, r, torch.zeros_like(r))
    return out_s, out_i


def ivf_topk_dma_reference(queries, database, bias, block_ids, n_valid, k: int, *,
                           block_rows: int):
    """Plain PyTorch version of the bf16 kernel: gather the valid blocks,
    score them (``topk_pruned_reference``'s arithmetic), stable sort."""
    rows = _probed_rows(block_ids, n_valid, block_rows)
    if database.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    q = queries.to(torch.bfloat16).float()
    x = database[rows].to(torch.bfloat16).float()
    return _probed_topk(q @ x.T + bias.float()[rows][None, :], rows, k)


def _scaled_reference(queries, x_int, x_max, db_scales, bias, rows, k):
    qq, qs = quantize_rows_int8(queries)
    acc = _exact_dot(qq, x_int, x_max)
    scores = acc * (qs[:, None] * db_scales.float()[rows][None, :]) + bias.float()[rows][None, :]
    return _probed_topk(scores, rows, k)


def ivf_topk_int8_dma_reference(queries, database_q, db_scales, bias, block_ids, n_valid,
                                k: int, *, block_rows: int):
    """Plain PyTorch version of the int8 kernel."""
    rows = _probed_rows(block_ids, n_valid, block_rows)
    return _scaled_reference(queries, database_q[rows], 127, db_scales, bias, rows, k)


def ivf_topk_int4_dma_reference(queries, database_p, db_scales, bias, block_ids, n_valid,
                                k: int, *, block_rows: int):
    """Plain PyTorch version of the int4 kernel: the int8 one over the
    unpacked nibbles of the probed rows."""
    rows = _probed_rows(block_ids, n_valid, block_rows)
    return _scaled_reference(queries, unpack_int4(database_p[rows]), 7, db_scales, bias, rows, k)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _library() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    if lib.ivf_topk_error_string.restype is not ctypes.c_char_p:
        p, i = ctypes.c_void_p, ctypes.c_int
        for name, entry in _ENTRY.items():
            launch = getattr(lib, f"{entry}_launch")
            launch.argtypes = [p, i] + [p] * 10 + [i] * 7 + [p]
            launch.restype = i
            per_sm = getattr(lib, f"{entry}_ctas_per_sm")
            per_sm.argtypes = [i, i]
            per_sm.restype = i
            plan = getattr(lib, f"{entry}_plan")
            plan.argtypes = [i, i, p]
            plan.restype = i
        lib.ivf_topk_error_string.argtypes = [i]
        lib.ivf_topk_error_string.restype = ctypes.c_char_p
    return lib


def _cuda_error(lib: ctypes.CDLL, entry: str, err: int) -> RuntimeError:
    return RuntimeError(f"{entry} failed: CUDA error {err} "
                        f"({lib.ivf_topk_error_string(err).decode()})")


@functools.lru_cache(maxsize=None)
def scan_plan(entry: str, d: int, k: int) -> tuple[int, int, int, int]:
    """The shared-memory plan of an entry of ``csrc/ivf_topk.cu`` at (d, k):
    (rows per stage, stages, lists in device memory, wide). A wide plan
    (bf16 only) reads the query tile from device memory and takes bf16
    queries (``csrc/ivf_scan_tma.cuh``, 9.); rows 0: none fits."""
    lib = _library()
    out = (ctypes.c_int * 4)()
    err = getattr(lib, f"{entry}_plan")(d, k, out)
    if err != 0:
        raise _cuda_error(lib, entry, err)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _ctas_per_sm(entry: str, d: int, k: int) -> int:
    """Scan CTAs one SM holds at (d, k), at most two (the register cap)."""
    lib = _library()
    per_sm = getattr(lib, f"{entry}_ctas_per_sm")(d, k)
    if per_sm < 0:
        raise _cuda_error(lib, entry, -per_sm)
    if per_sm == 0:
        raise RuntimeError(f"{entry}: d={d}, k={k} needs more shared memory than one SM has")
    return min(per_sm, 2)


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
    """``fn``'s entry of ``csrc/ivf_topk.cu`` over MAX_Q-query tiles."""
    nv = _check_plan(fn.__name__, n, block_ids, n_valid, block_rows, x.device)
    return _query_tiles(lambda qt: _launch_tma(fn, qt, x, xscale, bias, block_ids, nv, k, d, n,
                                               block_rows),
                        queries, _empty((0, k), x.device))


def _n_cta(entry: str, d: int, k: int, qn: int, rows: int, device, tiles: int = 1) -> int:
    """Scan CTAs per 8-query tile: as many as fit at once on the card
    (shared by ``tiles`` query tiles), at least 512 rows of the longest
    plan each (fewer above SHARED_K: _list_ctas)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    wave = _ctas_per_sm(entry, d, k) * sms // tiles
    return _list_ctas(max(1, min(wave, -(-rows // 512))), qn, k)


def _launch_tma(fn, queries, x, xscale, bias, block_ids, nv, k: int, d: int, n: int,
                block_rows: int):
    """Launch an entry of ``csrc/ivf_topk.cu`` (one kernel that prepares
    the queries, scans and merges, after a memset of its counters; the DMA
    or, for ``ivf_topk*``, the per-block contract) on the current stream (no
    sync) for one tile of at most MAX_Q queries, as the caller gives them:
    f32, or bf16 for a bf16 entry (another float type is cast here; a wide
    plan takes them cast here to bf16, as the kernel would round them)."""
    entry = _ENTRY[fn.__name__]
    lib = _library()
    dev = x.device
    keep = (torch.float32, torch.bfloat16) if xscale is None else (torch.float32,)
    if xscale is None and scan_plan(entry, d, k)[3]:
        keep = (torch.bfloat16,)
    if queries.dtype not in keep:
        queries = queries.to(torch.bfloat16 if xscale is None else torch.float32)
    queries = queries.contiguous()
    if queries.data_ptr() % 16:  # the kernel reads them in 16-byte units
        queries = queries.clone()
    qn = queries.shape[0]
    max_blocks = block_ids.numel()
    tiles = -(-qn // 8)
    # one wave: the card's CTAs split over the launch's 8-query tiles
    n_cta = _n_cta(entry, d, k, 8 * tiles, max_blocks * block_rows, dev, tiles)
    # the CTAs' lists, [tiles, n_cta, 8, k rounded up to 4]
    cand = (tiles, n_cta, 8, -(-k // 4) * 4)
    cand_s = torch.empty(cand, dtype=torch.float32, device=dev)
    cand_i = torch.empty(cand, dtype=torch.int32, device=dev)
    # tickets, stage pairs, the per-block entries' first columns
    counter = torch.empty((2 + _FIRST_COLS) * tiles, dtype=torch.int32, device=dev)
    out_s = torch.empty((qn, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, k), dtype=torch.int32, device=dev)
    err = getattr(lib, f"{entry}_launch")(
        queries.data_ptr(), int(queries.dtype == torch.bfloat16), x.data_ptr(),
        None if xscale is None else xscale.data_ptr(), bias.data_ptr(), block_ids.data_ptr(),
        nv.data_ptr(), cand_s.data_ptr(), cand_i.data_ptr(), counter.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), qn, n, d, k, max_blocks, block_rows, n_cta,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise _cuda_error(lib, entry, err)
    fn.launches += 1
    return out_s, out_i


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
                             d, n, block_rows, True, block_ids, nv)
    return _query_tiles(lambda qt: _launch_tma(ivf_topk, qt, x, None, bias, block_ids, nv, k, d,
                                               n, block_rows),
                        queries, _empty((0, k), x.device))


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
                             db_scales, bias, k, d, n, block_rows, True, block_ids, nv)
    return _query_tiles(lambda qt: _launch_tma(ivf_topk_int8, qt, database_q, db_scales, bias,
                                               block_ids, nv, k, d, n, block_rows),
                        queries, _empty((0, k), database_q.device))


ivf_topk_dma.launches = 0
ivf_topk_int8_dma.launches = 0
ivf_topk_int4_dma.launches = 0
ivf_topk.launches = 0
ivf_topk_int8.launches = 0
