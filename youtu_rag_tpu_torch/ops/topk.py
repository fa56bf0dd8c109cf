"""Fused masked score + exact top-k over a bf16, int8 or int4 index.

Counterpart of ``youtu_rag_tpu/ops/topk.py``: its pruned kernels
(``pallas_topk_pruned``, ``pallas_topk_int8_pruned``,
``pallas_topk_int4_pruned``), its quantizers, its XLA paths (``xla_topk*``),
its per-block kernels (``pallas_topk`` → ``topk``, ``pallas_topk_int8`` →
``topk_int8``; contract below) and the dispatcher ``fused_topk``. The
pruned kernels' contract is the JAX kernels':

- bf16: scores are ``f32(bf16(q)) · f32(bf16(x))`` summed in f32, plus
  ``bias[row]`` (0 for live rows, ``NEG_INF`` for tombstones, padding and
  filtered-out rows);
- int8 / int4: queries are quantized per row to int8
  (``quantize_rows_int8``), the dot with the stored int8 rows (or the
  packed int4 nibbles) is an exact int32, and the score is
  ``f32(acc) * (qs[q] * xs[row]) + bias[row]``, each operation rounded on
  its own;
- the result is the exact top k per query ordered by (score desc, row
  asc): lower rows win ties; 1 <= k <= N on every device (JAX asserts
  k <= block_rows, which divides N);
- slots no live row fills carry a score of ``NEG_INF`` (or ``-inf`` where
  a filter added ``NEG_INF`` to a ``NEG_INF`` bias); their row is not
  specified, and callers drop any slot with ``score <= NEG_INF / 2``.

The per-block kernels score the same way and follow ``pallas_topk``:
block i of ``block_rows`` rows writes its own top k, as ``_select_topk``
picks it (k passes of: the max, the first column scoring ``>=`` it, that
column overwritten with ``NEG_INF``), padded with ``(NEG_INF, 0)`` to
``k_pad = round_up(k, 128)``; the ``[blocks, q, k_pad]`` candidates then
merge by a stable descending sort over their positions (``lax.top_k``).
So the live rows come in (score desc, row asc), and the slots past them
are not ``(NEG_INF, 0)`` but ``_select_topk``'s repeated pick: the lowest
row of a block that scores ``>= NEG_INF``, in block order (see
``csrc/topk_blocks.cu``).

Each wrapper (``topk_pruned``, ``topk_int8_pruned``, ``topk_int4_pruned``,
``topk``, ``topk_int8``) launches a hand-written CUDA kernel for CUDA
tensors and counts the launch in its ``.launches``; for CPU tensors it runs
its plain PyTorch version (``*_reference``). The pruned scans and the
per-block ones merged launch an entry of the ring, ``csrc/ivf_topk_<tier>.cu``
(``_launch_tma``: the IVF scans' kernels over the identity plan, which
prepare the queries, scan, select and merge in one kernel after a memset,
so no candidates reach another launch, no sort runs and the host neither
casts nor quantizes the queries): ``topk_pruned_bf16`` / ``_int8`` /
``_int4`` (one block of all n rows; the slots no live row fills come back
``(NEG_INF, 0)``) and ``topk_merged_bf16`` / ``topk_merged_int8``; with
``candidates=True`` the per-block ones launch ``csrc/topk_blocks.cu``.
``merge_blocks`` is the plain versions' merge. Every wrapper takes any number
of queries: on CUDA it launches once per tile of at most ``MAX_Q`` queries
(``_query_tiles``, shared with ``ops/ivf.py``) and joins the results; with
no query it returns an empty result without a launch. The ``xla_*``
functions are plain PyTorch on every device, as they are plain XLA in JAX.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from .precision import f32_matmul

NEG_INF = float(np.finfo(np.float32).min)

# The kernels' lists stay in shared memory up to k = SHARED_K; above it
# (the JAX kernels take any k up to their block_rows) each list lives in
# the candidate buffer in device memory, which _list_ctas bounds.
SHARED_K = 1024
MAX_Q = 64  # queries per kernel launch; the wrappers tile more (_query_tiles)
CAND_BYTES = 256 << 20  # the device-memory lists' candidate buffer, at most
_LANE = 128


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _check_k(name: str, k: int, limit: int | None = None, what: str = "") -> None:
    """1 <= k (<= limit, where the JAX function bounds it)."""
    if k < 1 or (limit is not None and k > limit):
        top = "" if limit is None else str(limit)
        raise ValueError(f"{name}: k={k} outside 1..{top}{what}")


def _check_blocks(name: str, n: int, d: int, k: int, block_rows: int) -> None:
    """The per-block kernels' asserts (``pallas_topk``'s), as ValueError."""
    _check_k(name, k)
    if block_rows < 1 or n % block_rows:
        raise ValueError(f"{name}: block_rows={block_rows} must divide the {n} rows")
    if d % _LANE:
        raise ValueError(f"{name}: width {d} must be a multiple of {_LANE}")
    if k > block_rows:
        raise ValueError(f"{name}: k={k} above block_rows={block_rows}")


# ---------------------------------------------------------------------------
# quantizers (bit-identical to the JAX package's)
# ---------------------------------------------------------------------------


def _row_scales(xf: torch.Tensor, levels: float, folded: bool) -> torch.Tensor:
    """``max(amax, 1e-12) / levels`` per row, in f32, rounded as the JAX
    quantizer is. ``quantize_rows_int8`` is jitted, and XLA compiles its
    division by a constant into a product with the constant's f32
    reciprocal (``folded``), which can differ from a true division in the
    last bit. ``quantize_rows_int4`` runs eagerly and divides. The true
    division takes a tensor divisor: CUDA divides by a Python scalar as a
    product with its reciprocal."""
    amax = xf.abs().amax(dim=1).clamp_min(1e-12)
    if folded:
        return amax * float(np.float32(1.0) / np.float32(levels))
    return amax / torch.full_like(amax, levels)


def quantize_rows_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8: x ≈ scale[:, None] * q, q ∈ [-127, 127];
    round half to even, as ``jnp.round``. Returns (q int8 [N, d], scale f32 [N])."""
    xf = x.float()
    scale = _row_scales(xf, 127.0, folded=True)
    q = torch.round(xf / scale[:, None]).clamp_(-127, 127).to(torch.int8)
    return q, scale


def quantize_rows_int4(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int4, q ∈ [-7, 7], packed two columns per byte:
    byte j = column j in the low nibble | column j + d/2 in the high one.
    Returns (packed int8 [N, d/2], scale f32 [N])."""
    d = x.shape[1]
    if d % 2:
        raise ValueError(f"quantize_rows_int4: odd width {d}")
    xf = x.float()
    scale = _row_scales(xf, 7.0, folded=False)
    q = torch.round(xf / scale[:, None]).clamp_(-7, 7).to(torch.int32)
    packed = (q[:, : d // 2] & 0xF) | ((q[:, d // 2 :] & 0xF) << 4)
    return packed.to(torch.uint8).view(torch.int8), scale


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[..., d/2] packed int8 → [..., d] int8 nibbles in [-8, 7] (stored
    values lie in [-7, 7])."""
    p = packed.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8  # sign-extend the low nibble
    hi = p >> 4  # arithmetic shift sign-extends the high nibble
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _sorted_topk(scores: torch.Tensor, k: int):
    # torch.topk promises no tie order; a stable sort puts lower rows first
    s, i = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :k].contiguous(), i[:, :k].to(torch.int32).contiguous()


def _bf16_scores(queries: torch.Tensor, database: torch.Tensor, bias: torch.Tensor):
    """[q, N] f32 ``f32(bf16 q) · f32(bf16 x) + bias``. Casts to bf16 and
    back to f32 before the matmul (a bf16 matmul would round the scores to
    bf16), with TF32 off."""
    q = queries.to(torch.bfloat16).float()
    x = database.to(torch.bfloat16).float()
    with f32_matmul():
        return q @ x.T + bias.float()[None, :]


def topk_pruned_reference(queries: torch.Tensor, database: torch.Tensor,
                          bias: torch.Tensor, k: int):
    """Plain PyTorch version of the bf16 kernel: full score matrix
    (``_bf16_scores``), stable sort.
    Returns (scores [q, k] f32 desc, rows [q, k] int32)."""
    return _sorted_topk(_bf16_scores(queries, database, bias), k)


def _exact_dot(qq: torch.Tensor, xq: torch.Tensor, x_max: int) -> torch.Tensor:
    """The exact integer dot ``qq · xqᵀ`` as f32 (``f32(acc)``, rounded to
    nearest). In f32 with TF32 off while every partial sum stays below 2²⁴
    (then any summation order is exact), else in float64."""
    if qq.shape[1] * 127 * x_max < 2**24:
        with f32_matmul():
            return qq.float() @ xq.float().T
    return (qq.double() @ xq.double().T).float()


def _scaled_scores(queries, x_int, x_max, db_scales, bias):
    """[q, N] f32 int8/int4 scores: the queries quantized per row, the exact
    integer dot, then two f32 operations in the TPU kernels' order."""
    qq, qs = quantize_rows_int8(queries)
    acc = _exact_dot(qq, x_int, x_max)
    return acc * (qs[:, None] * db_scales.float()[None, :]) + bias.float()[None, :]


def _scaled_topk(queries, x_int, x_max, db_scales, bias, k):
    return _sorted_topk(_scaled_scores(queries, x_int, x_max, db_scales, bias), k)


def topk_int8_pruned_reference(queries: torch.Tensor, database_q: torch.Tensor,
                               db_scales: torch.Tensor, bias: torch.Tensor, k: int):
    """Plain PyTorch version of the int8 kernel: the queries quantized per
    row as the JAX wrapper does, the exact int32 dot, the f32 epilogue, a
    stable sort. Returns (scores [q, k] f32 desc, rows [q, k] int32)."""
    return _scaled_topk(queries, database_q, 127, db_scales, bias, k)


def topk_int4_pruned_reference(queries: torch.Tensor, database_p: torch.Tensor,
                               db_scales: torch.Tensor, bias: torch.Tensor, k: int):
    """Plain PyTorch version of the int4 kernel: as the int8 one over the
    unpacked nibbles (``unpack_int4``)."""
    return _scaled_topk(queries, unpack_int4(database_p), 7, db_scales, bias, k)


def _check_rows(name: str, n: int, k: int) -> None:
    if not 1 <= k <= n:
        raise ValueError(f"{name}: k={k} outside 1..{n}, the index's rows")


def xla_topk(queries: torch.Tensor, database: torch.Tensor, bias: torch.Tensor, k: int):
    """JAX's ``xla_topk``: the full score matrix (``_bf16_scores``) and its
    top k per query, ties to the lowest row (a stable sort, as
    ``lax.top_k``); 1 <= k <= N. Plain PyTorch on every device.
    Returns (scores [q, k] f32 desc, rows [q, k] int32)."""
    _check_rows("xla_topk", database.shape[0], k)
    return topk_pruned_reference(queries, database, bias, k)


def xla_topk_int8(queries: torch.Tensor, database_q: torch.Tensor, db_scales: torch.Tensor,
                  bias: torch.Tensor, k: int):
    """JAX's ``xla_topk_int8``: as ``xla_topk`` with the int8 scores
    (``_scaled_scores``)."""
    _check_rows("xla_topk_int8", database_q.shape[0], k)
    return topk_int8_pruned_reference(queries, database_q, db_scales, bias, k)


def xla_topk_int4(queries: torch.Tensor, database_p: torch.Tensor, db_scales: torch.Tensor,
                  bias: torch.Tensor, k: int):
    """JAX's ``xla_topk_int4``: as ``xla_topk_int8`` over the unpacked
    nibbles of the packed rows."""
    _check_rows("xla_topk_int4", database_p.shape[0], k)
    return topk_int4_pruned_reference(queries, database_p, db_scales, bias, k)


def _select_blocks(scores: torch.Tensor, k: int, base: torch.Tensor):
    """``_select_topk`` (``topk.py:77-94``) on every block at once, step by
    step: scores [q, blocks, block_rows] f32, base [blocks] int32 (each
    block's first row). k times: the max of each block, the first column
    scoring ``>=`` it, that column overwritten with ``NEG_INF``.
    Returns (scores, rows), each [blocks, q, k]."""
    br = scores.shape[2]
    s = scores.clone()
    col = torch.arange(br, dtype=torch.int32, device=s.device)
    vals, cols = [], []
    for _ in range(k):
        m = s.amax(dim=2, keepdim=True)
        arg = torch.where(s >= m, col, br).amin(dim=2, keepdim=True)
        vals.append(m)
        cols.append(arg)
        s.scatter_(2, arg.long(), NEG_INF)
    rows = torch.cat(cols, dim=2) + base.to(torch.int32)[None, :, None]
    return torch.cat(vals, dim=2).transpose(0, 1), rows.transpose(0, 1)


def _blocks_of(scores: torch.Tensor, k: int, block_rows: int, base: torch.Tensor,
               candidates: bool):
    """The per-block kernels' plain path from a score matrix [q, blocks *
    block_rows]: ``_select_blocks``, each list padded with (NEG_INF, 0) to
    ``k_pad = round_up(k, 128)`` as ``topk.py:112-116`` pads it; the
    candidates [blocks, q, k_pad], or their merge (``merge_blocks``)."""
    qn = scores.shape[0]
    vals, rows = _select_blocks(scores.reshape(qn, scores.shape[1] // block_rows, block_rows), k,
                                base)
    nb, k_pad = vals.shape[0], _round_up(k, _LANE)
    cand_s = torch.full((nb, qn, k_pad), NEG_INF, dtype=torch.float32, device=scores.device)
    cand_i = torch.zeros((nb, qn, k_pad), dtype=torch.int32, device=scores.device)
    cand_s[..., :k] = vals
    cand_i[..., :k] = rows
    return (cand_s, cand_i) if candidates else merge_blocks(cand_s, cand_i, k)


def merge_blocks(cand_s: torch.Tensor, cand_i: torch.Tensor, k: int):
    """The per-block functions' merge (``topk.py:184-189``), in the plain
    versions (the kernels merge inside their one launch): the candidates
    [blocks, q, k_pad] laid out per query in block order, a stable
    descending sort over those positions (``lax.top_k``: ties to the lower
    position), the first k. Returns (scores [q, k] f32, rows [q, k] int32)."""
    nb, qn, kp = cand_s.shape
    s = cand_s.transpose(0, 1).reshape(qn, nb * kp)
    i = cand_i.transpose(0, 1).reshape(qn, nb * kp)
    top, pos = torch.sort(s, dim=1, descending=True, stable=True)
    return top[:, :k].contiguous(), torch.gather(i, 1, pos[:, :k]).contiguous()


def _block_base(n_blocks: int, block_rows: int, device) -> torch.Tensor:
    return torch.arange(n_blocks, dtype=torch.int32, device=device) * block_rows


def topk_reference(queries: torch.Tensor, database: torch.Tensor, bias: torch.Tensor, k: int,
                   *, block_rows: int = 1024, candidates: bool = False):
    """Plain PyTorch version of ``topk`` (``pallas_topk``): the bf16 score
    matrix, then ``_blocks_of``."""
    n, d = database.shape
    _check_blocks("topk", n, d, k, block_rows)
    return _blocks_of(_bf16_scores(queries, database, bias), k, block_rows,
                      _block_base(n // block_rows, block_rows, database.device), candidates)


def topk_int8_reference(queries: torch.Tensor, database_q: torch.Tensor, db_scales: torch.Tensor,
                        bias: torch.Tensor, k: int, *, block_rows: int = 2048,
                        candidates: bool = False):
    """Plain PyTorch version of ``topk_int8`` (``pallas_topk_int8``): the
    int8 score matrix (``_scaled_scores``), then ``_blocks_of``."""
    n, d = database_q.shape
    _check_blocks("topk_int8", n, d, k, block_rows)
    scores = _scaled_scores(queries, database_q, 127, db_scales, bias)
    return _blocks_of(scores, k, block_rows,
                      _block_base(n // block_rows, block_rows, database_q.device), candidates)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _list_ctas(n_cta: int, qn: int, k: int) -> int:
    """Above SHARED_K the kernel keeps each (CTA, query) list in the
    candidate buffer [n_cta, q, k] itself: fewer CTAs bound it to
    CAND_BYTES."""
    if k <= SHARED_K:
        return n_cta
    return max(1, min(n_cta, CAND_BYTES // (qn * k * 8)))


def _query_tiles(launch, queries: torch.Tensor, empty: tuple, dim: int = 0):
    """``launch(tile)`` over tiles of at most MAX_Q queries (the most one
    kernel launch takes), each result joined along its query axis ``dim``;
    with no query, ``empty`` and no launch."""
    qn = queries.shape[0]
    if qn == 0:
        return empty
    parts = [launch(queries[i : i + MAX_Q]) for i in range(0, qn, MAX_Q)]
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(p, dim=dim) for p in zip(*parts))


def _kernel_queries(qt: torch.Tensor, quantized: bool):
    """A tile's queries as a kernel reads them: bf16 rows and no scales, or
    int8 rows and their f32 scales (``quantize_rows_int8``)."""
    return quantize_rows_int8(qt) if quantized else (qt.to(torch.bfloat16).contiguous(), None)


def _empty(shape: tuple, device) -> tuple[torch.Tensor, torch.Tensor]:
    """An empty (scores f32, rows int32) result of ``shape``."""
    return (torch.empty(shape, dtype=torch.float32, device=device),
            torch.empty(shape, dtype=torch.int32, device=device))


def _check_cuda(name: str, queries, x, bias, dtype, width, scales=None) -> int:
    """Shape, type and layout checks of a CUDA launch; returns n."""
    if x.dtype != dtype or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: database must be a contiguous 2-D {dtype} tensor")
    n = x.shape[0]
    if x.shape[1] % _LANE or x.data_ptr() % 16:
        raise ValueError(f"{name}: stored width {x.shape[1]} must be a multiple of {_LANE}, "
                         "rows 16-byte aligned")
    if queries.dim() != 2 or queries.shape[1] != width:
        raise ValueError(f"{name}: queries {tuple(queries.shape)} do not match width {width}")
    for what, t in (("bias", bias), ("db_scales", scales)):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != (n,)
                              or not t.is_contiguous()):
            raise ValueError(f"{name}: {what} must be contiguous f32 [{n}]")
    return n


def _device_of(name: str, *tensors: torch.Tensor) -> str:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on different devices {devices}")
    kind = devices.pop().type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {kind}")
    return kind


def _rows_k(name: str, k: int, n: int) -> None:
    _check_k(name, k, n, ", the index's rows")


def topk_pruned(queries: torch.Tensor, database: torch.Tensor, bias: torch.Tensor, k: int):
    """Exact masked top-k over bf16 rows (``pallas_topk_pruned``):
    (scores [q, k] f32 desc, rows [q, k] int32).

    queries [q, d] (any float dtype; rounded to bf16: on CUDA f32 ones
    inside the kernel), database [N, d] bf16 contiguous with d % 128 == 0,
    bias [N] f32, 1 <= k <= N. On CUDA: the ring's ``topk_pruned_bf16``
    (``csrc/ivf_topk_bf16.cu``), once per MAX_Q queries on the current
    stream, without a sync."""
    _rows_k("topk_pruned", k, database.shape[0])
    if _device_of("topk_pruned", queries, database, bias) == "cpu":
        return topk_pruned_reference(queries, database, bias, k)
    d = database.shape[1]
    n = _check_cuda("topk_pruned", queries, database, bias, torch.bfloat16, d)
    # the ring's identity plan with one block of all n rows (block_rows n
    # divides any n)
    return _ring_tiles(topk_pruned, queries, database, None, bias, k, d, n, n)


def topk_int8_pruned(queries: torch.Tensor, database_q: torch.Tensor, db_scales: torch.Tensor,
                     bias: torch.Tensor, k: int):
    """Exact masked top-k over int8 rows (``pallas_topk_int8_pruned``).

    queries [q, d] float, quantized per row (``quantize_rows_int8``; on CUDA
    inside the kernel, which takes them as f32); database_q [N, d] int8
    contiguous with d % 128 == 0; db_scales [N] f32; bias [N] f32;
    1 <= k <= N. On CUDA: the ring's ``topk_pruned_int8``
    (``csrc/ivf_topk_int8.cu``), as ``topk_pruned``."""
    _rows_k("topk_int8_pruned", k, database_q.shape[0])
    if _device_of("topk_int8_pruned", queries, database_q, db_scales, bias) == "cpu":
        return topk_int8_pruned_reference(queries, database_q, db_scales, bias, k)
    d = database_q.shape[1]
    n = _check_cuda("topk_int8_pruned", queries, database_q, bias, torch.int8, d, db_scales)
    return _ring_tiles(topk_int8_pruned, queries, database_q, db_scales, bias, k, d, n, n)


def topk_int4_pruned(queries: torch.Tensor, database_p: torch.Tensor, db_scales: torch.Tensor,
                     bias: torch.Tensor, k: int):
    """Exact masked top-k over int4-packed rows (``pallas_topk_int4_pruned``).

    queries [q, d] float, quantized per row to int8 (``quantize_rows_int8``;
    on CUDA inside the kernel, which takes them as f32); database_p [N, d/2]
    int8 packed nibbles (``quantize_rows_int4``) with (d/2) % 128 == 0;
    db_scales [N] f32 (amax/7); bias [N] f32; 1 <= k <= N. On CUDA: the
    ring's ``topk_pruned_int4`` (``csrc/ivf_topk_int4.cu``), as
    ``topk_pruned``."""
    _rows_k("topk_int4_pruned", k, database_p.shape[0])
    if _device_of("topk_int4_pruned", queries, database_p, db_scales, bias) == "cpu":
        return topk_int4_pruned_reference(queries, database_p, db_scales, bias, k)
    d = 2 * database_p.shape[1]
    n = _check_cuda("topk_int4_pruned", queries, database_p, bias, torch.int8, d, db_scales)
    return _ring_tiles(topk_int4_pruned, queries, database_p, db_scales, bias, k, d, n, n)


# The scan-and-merge ring, csrc/ivf_topk_<tier>.cu (csrc/ivf_scan_tma.cuh):
# one launch per MAX_Q queries that prepares the queries, scans, selects and
# merges, after a memset of its counters. ops/ivf.py's wrappers take a probe
# plan to it; topk and topk_int8 take their merged calls and the pruned
# scans every call (the identity plan). Each wrapper's entry, and the
# library (one source per tier) that holds it:
_TMA_ENTRY = {"ivf_topk_dma": "ivf_topk_bf16", "ivf_topk_int8_dma": "ivf_topk_int8",
              "ivf_topk_int4_dma": "ivf_topk_int4", "ivf_topk": "ivf_blocks_bf16",
              "ivf_topk_int8": "ivf_blocks_int8", "topk": "topk_merged_bf16",
              "topk_int8": "topk_merged_int8", "topk_pruned": "topk_pruned_bf16",
              "topk_int8_pruned": "topk_pruned_int8", "topk_int4_pruned": "topk_pruned_int4"}
_TMA_LIB = {entry: "ivf_topk_" + entry.rsplit("_", 1)[1] for entry in _TMA_ENTRY.values()}
_FIRST_COLS = 16  # the per-block entries' counters past [2, tiles]: [tiles, 8 queries, 2]
# Rows each CTA of a launch takes at least: a probe plan's max_blocks *
# block_rows only bound the rows it probes, so 512 each; the identity plan's
# are exact, so one ring's fill (4 stages of 32 rows), which spreads a small
# index's stream and selection over more CTAs (2,048 rows: 16, not 4)
_PLAN_ROWS_PER_CTA, _IDENTITY_ROWS_PER_CTA = 512, 128


def _tma_library(entry: str) -> ctypes.CDLL:
    """The loaded library of the ring that holds ``entry``, every entry of it typed."""
    lib = _build.load(_TMA_LIB[entry])
    if getattr(lib, f"{entry}_launch").argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        for name in _TMA_LIB:
            if _TMA_LIB[name] != _TMA_LIB[entry]:
                continue
            launch = getattr(lib, f"{name}_launch")
            launch.argtypes = [p, i] + [p] * 10 + [i] * 7 + [p]
            launch.restype = i
            per_sm = getattr(lib, f"{name}_ctas_per_sm")
            per_sm.argtypes = [i, i]
            per_sm.restype = i
            plan = getattr(lib, f"{name}_plan")
            plan.argtypes = [i, i, p]
            plan.restype = i
        lib.ivf_topk_error_string.argtypes = [i]
        lib.ivf_topk_error_string.restype = ctypes.c_char_p
    return lib


def load_kernel(fn) -> None:
    """Build (if need be) and load the ring library that holds ``fn``'s
    entry, every entry of it typed: what a first launch of the wrapper
    ``fn`` would pay before launching. The index's tier warm-up calls it."""
    _tma_library(_TMA_ENTRY[fn.__name__])


def _tma_error(lib: ctypes.CDLL, entry: str, err: int) -> RuntimeError:
    return RuntimeError(f"{entry} failed: CUDA error {err} "
                        f"({lib.ivf_topk_error_string(err).decode()})")


@functools.lru_cache(maxsize=None)
def scan_plan(entry: str, d: int, k: int) -> tuple[int, int, int, int]:
    """The shared-memory plan of an entry of the ring at (d, k):
    (rows per stage, stages, lists in device memory, wide). A wide plan
    (bf16 only) reads the query tile from device memory and takes bf16
    queries (``csrc/ivf_scan_tma.cuh``, 9.); rows 0: none fits."""
    lib = _tma_library(entry)
    out = (ctypes.c_int * 4)()
    err = getattr(lib, f"{entry}_plan")(d, k, out)
    if err != 0:
        raise _tma_error(lib, entry, err)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _tma_ctas_per_sm(entry: str, d: int, k: int) -> int:
    """Scan CTAs one SM holds at (d, k), at most two (the register cap)."""
    lib = _tma_library(entry)
    per_sm = getattr(lib, f"{entry}_ctas_per_sm")(d, k)
    if per_sm < 0:
        raise _tma_error(lib, entry, -per_sm)
    if per_sm == 0:
        raise RuntimeError(f"{entry}: d={d}, k={k} needs more shared memory than one SM has")
    return min(per_sm, 2)


def _tma_n_cta(entry: str, d: int, k: int, qn: int, rows: int, device, tiles: int = 1,
               least: int = _PLAN_ROWS_PER_CTA) -> int:
    """Scan CTAs per 8-query tile: as many as fit at once on the card
    (shared by ``tiles`` query tiles), at least ``least`` rows of the
    longest plan each (fewer above SHARED_K: _list_ctas)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    wave = _tma_ctas_per_sm(entry, d, k) * sms // tiles
    return _list_ctas(max(1, min(wave, -(-rows // least))), qn, k)


def _launch_tma(fn, queries, x, xscale, bias, block_ids, nv, k: int, d: int, n: int,
                block_rows: int):
    """Launch ``fn``'s entry of the ring (one kernel that
    prepares the queries, scans and merges, after a memset of its counters)
    on the current stream (no sync) for one tile of at most MAX_Q queries,
    as the caller gives them: f32, or bf16 for a bf16 entry (another float
    type is cast here; a wide plan takes them cast here to bf16, as the
    kernel would round them). ``block_ids`` and ``nv`` are a probe plan
    (int32 [max_blocks] and [1]), or None for the identity plan of
    ``topk`` / ``topk_int8`` and the pruned scans: every block of
    ``block_rows`` rows, in order, nothing of it on the device."""
    entry = _TMA_ENTRY[fn.__name__]
    lib = _tma_library(entry)
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
    max_blocks = n // block_rows if block_ids is None else block_ids.numel()
    tiles = -(-qn // 8)
    # one wave: the card's CTAs split over the launch's 8-query tiles
    n_cta = _tma_n_cta(entry, d, k, 8 * tiles, max_blocks * block_rows, dev, tiles,
                       _PLAN_ROWS_PER_CTA if block_ids is not None else _IDENTITY_ROWS_PER_CTA)
    # the CTAs' lists, [tiles, n_cta, 8, k rounded up to 4]
    cand = (tiles, n_cta, 8, -(-k // 4) * 4)
    cand_s = torch.empty(cand, dtype=torch.float32, device=dev)
    cand_i = torch.empty(cand, dtype=torch.int32, device=dev)
    # tickets, stage pairs, the per-block entries' first columns
    counter = torch.empty((2 + _FIRST_COLS) * tiles, dtype=torch.int32, device=dev)
    out_s = torch.empty((qn, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, k), dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = getattr(lib, f"{entry}_launch")(
        queries.data_ptr(), int(queries.dtype == torch.bfloat16), x.data_ptr(), ptr(xscale),
        bias.data_ptr(), ptr(block_ids), ptr(nv), cand_s.data_ptr(), cand_i.data_ptr(),
        counter.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), qn, n, d, k, max_blocks,
        block_rows, n_cta, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise _tma_error(lib, entry, err)
    fn.launches += 1
    return out_s, out_i


_BLOCKS_LIB = "topk_blocks"
_BLOCKS_ENTRIES = ("topk_blocks_bf16", "topk_blocks_int8", "ivf_topk_blocks_bf16",
                   "ivf_topk_blocks_int8")


def _blocks_library() -> ctypes.CDLL:
    lib = _build.load(_BLOCKS_LIB)
    if lib.topk_blocks_error_string.restype is not ctypes.c_char_p:
        p, i = ctypes.c_void_p, ctypes.c_int
        for entry in _BLOCKS_ENTRIES:
            launch = getattr(lib, f"{entry}_launch")
            launch.argtypes = [p] * 9 + [i] * 7 + [p]
            launch.restype = i
        lib.topk_blocks_error_string.argtypes = [i]
        lib.topk_blocks_error_string.restype = ctypes.c_char_p
    return lib


def _launch_blocks(fn, entry: str, queries, qscale, x, xscale, bias, k: int, d: int, n: int,
                   block_rows: int, block_ids=None, n_valid=None):
    """Launch ``entry`` of ``csrc/topk_blocks.cu`` on the current stream
    (no sync) for one tile of at most MAX_Q queries; returns its
    candidates [blocks, q, k_pad] (f32, int32)."""
    lib = _blocks_library()
    dev = x.device
    qn = queries.shape[0]
    n_blocks = n // block_rows if block_ids is None else block_ids.numel()
    k_pad = _round_up(k, _LANE)
    cand_s = torch.empty((n_blocks, qn, k_pad), dtype=torch.float32, device=dev)
    cand_i = torch.empty((n_blocks, qn, k_pad), dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = getattr(lib, f"{entry}_launch")(
        queries.data_ptr(), ptr(qscale), x.data_ptr(), ptr(xscale), bias.data_ptr(),
        ptr(block_ids), ptr(n_valid), cand_s.data_ptr(), cand_i.data_ptr(),
        qn, n, d, k, k_pad, n_blocks, block_rows, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err} "
                           f"({lib.topk_blocks_error_string(err).decode()})")
    fn.launches += 1
    return cand_s, cand_i


def _blocks_tiles(fn, entry: str, queries, quantized: bool, x, xscale, bias, k: int, d: int,
                  n: int, block_rows: int, block_ids=None, n_valid=None):
    """The candidates of a per-block kernel of ``csrc/topk_blocks.cu`` over
    MAX_Q-query tiles (``_query_tiles``), [blocks, q, k_pad] joined along q."""
    n_blocks = n // block_rows if block_ids is None else block_ids.numel()

    def launch(qt):
        return _launch_blocks(fn, entry, *_kernel_queries(qt, quantized), x, xscale, bias, k, d,
                              n, block_rows, block_ids, n_valid)

    return _query_tiles(launch, queries, _empty((n_blocks, 0, _round_up(k, _LANE)), x.device),
                        dim=1)


def _ring_tiles(fn, queries, x, xscale, bias, k: int, d: int, n: int, block_rows: int,
                block_ids=None, nv=None):
    """``fn``'s entry of the ring over MAX_Q-query tiles
    (``_launch_tma``; no plan: the identity plan)."""
    return _query_tiles(lambda qt: _launch_tma(fn, qt, x, xscale, bias, block_ids, nv, k, d, n,
                                               block_rows),
                        queries, _empty((0, k), x.device))


def topk(queries: torch.Tensor, database: torch.Tensor, bias: torch.Tensor, k: int, *,
         block_rows: int = 1024, candidates: bool = False):
    """Masked top-k through per-block candidates (``pallas_topk``):
    (scores [q, k] f32 desc, rows [q, k] int32), or with ``candidates`` the
    unmerged lists [N / block_rows, q, k_pad] (module docstring).

    queries [q, d] (cast to bf16); database [N, d] (bf16; another float
    type is cast to bf16, as JAX does) with d % 128 == 0 and
    N % block_rows == 0; bias [N] f32; 1 <= k <= block_rows. On CUDA: one
    launch per MAX_Q queries on the current stream, without a sync; merged,
    the ring's ``topk_merged_bf16`` (scan, selection and merge
    in the one kernel), the candidates ``csrc/topk_blocks.cu``."""
    n, d = database.shape
    _check_blocks("topk", n, d, k, block_rows)
    if _device_of("topk", queries, database, bias) == "cpu":
        return topk_reference(queries, database, bias, k, block_rows=block_rows,
                              candidates=candidates)
    x = database.to(torch.bfloat16).contiguous()
    n = _check_cuda("topk", queries, x, bias, torch.bfloat16, d)
    if candidates:
        return _blocks_tiles(topk, "topk_blocks_bf16", queries, False, x, None, bias, k, d, n,
                             block_rows)
    return _ring_tiles(topk, queries, x, None, bias, k, d, n, block_rows)


def topk_int8(queries: torch.Tensor, database_q: torch.Tensor, db_scales: torch.Tensor,
              bias: torch.Tensor, k: int, *, block_rows: int = 2048, candidates: bool = False):
    """The int8 form of ``topk`` (``pallas_topk_int8``): database_q [N, d]
    int8, db_scales [N] f32; queries quantized per row here
    (``quantize_rows_int8``; the merged call on CUDA inside the kernel)."""
    n, d = database_q.shape
    _check_blocks("topk_int8", n, d, k, block_rows)
    if _device_of("topk_int8", queries, database_q, db_scales, bias) == "cpu":
        return topk_int8_reference(queries, database_q, db_scales, bias, k,
                                   block_rows=block_rows, candidates=candidates)
    n = _check_cuda("topk_int8", queries, database_q, bias, torch.int8, d, db_scales)
    if candidates:
        return _blocks_tiles(topk_int8, "topk_blocks_int8", queries, True, database_q, db_scales,
                             bias, k, d, n, block_rows)
    return _ring_tiles(topk_int8, queries, database_q, db_scales, bias, k, d, n, block_rows)


def fused_topk(queries: torch.Tensor, database: torch.Tensor, bias: torch.Tensor, k: int, *,
               block_rows: int = 1024, backend: str = "auto"):
    """JAX's ``fused_topk``: dispatch between the per-block kernel and the
    XLA path. ``backend``:

    - ``"auto"``: ``topk`` for CUDA tensors when N >= 4 * block_rows (JAX's
      rule, with the card in the TPU's place), else ``xla_topk``;
    - ``"pallas"``: ``topk`` (the kernel on CUDA tensors, its plain version
      on CPU ones);
    - ``"pallas_interpret"``: ``topk_reference`` on any device;
    - ``"xla"``: ``xla_topk``.

    Takes any number of queries, none included (``[0, k]`` results, as JAX).
    Returns (scores [q, k] f32 desc, rows [q, k] int32)."""
    if backend == "auto":
        backend = "pallas" if database.is_cuda and database.shape[0] >= 4 * block_rows else "xla"
    if backend == "xla":
        return xla_topk(queries, database, bias, k)
    fn = {"pallas": topk, "pallas_interpret": topk_reference}.get(backend)
    if fn is None:
        raise ValueError(f"unknown backend {backend!r}")
    return fn(queries, database, bias, k, block_rows=block_rows)


topk_pruned.launches = 0
topk_int8_pruned.launches = 0
topk_int4_pruned.launches = 0
topk.launches = 0
topk_int8.launches = 0
