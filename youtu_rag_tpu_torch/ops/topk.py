"""Fused masked score + exact top-k over a bf16, int8 or int4 index.

Counterpart of ``youtu_rag_tpu/ops/topk.py``'s pruned kernels
(``pallas_topk_pruned``, ``pallas_topk_int8_pruned``,
``pallas_topk_int4_pruned``) and of its quantizers. The contract is the
JAX kernels':

- bf16: scores are ``f32(bf16(q)) · f32(bf16(x))`` summed in f32, plus
  ``bias[row]`` (0 for live rows, ``NEG_INF`` for tombstones, padding and
  filtered-out rows);
- int8 / int4: queries are quantized per row to int8
  (``quantize_rows_int8``), the dot with the stored int8 rows (or the
  packed int4 nibbles) is an exact int32, and the score is
  ``f32(acc) * (qs[q] * xs[row]) + bias[row]``, each operation rounded on
  its own;
- the result is the exact top k per query ordered by (score desc, row
  asc): lower rows win ties; 1 <= k <= ``MAX_K`` on every device;
- slots no live row fills carry a score of ``NEG_INF`` (or ``-inf`` where
  a filter added ``NEG_INF`` to a ``NEG_INF`` bias); their row is not
  specified, and callers drop any slot with ``score <= NEG_INF / 2``.

Each wrapper (``topk_pruned``, ``topk_int8_pruned``, ``topk_int4_pruned``)
launches its hand-written CUDA kernel (``csrc/<name>.cu``) for CUDA tensors
and counts the launch in its ``.launches``; for CPU tensors it runs its
plain PyTorch version (``*_reference``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

NEG_INF = float(np.finfo(np.float32).min)

MAX_K = 1024  # the JAX kernels' limit (k <= block_rows) at the default block_rows
MAX_Q = 64  # the store's search coalescer merges at most 64 queries
_LANE = 128


def _check_k(name: str, k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{name}: k={k} outside 1..{MAX_K}, the most the kernel keeps")


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


def topk_pruned_reference(queries: torch.Tensor, database: torch.Tensor,
                          bias: torch.Tensor, k: int):
    """Plain PyTorch version of the bf16 kernel: full score matrix, stable
    sort. Casts to bf16 and back to f32 before the matmul (a bf16 matmul
    would round the scores to bf16), with TF32 off.
    Returns (scores [q, k] f32 desc, rows [q, k] int32)."""
    if database.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    q = queries.to(torch.bfloat16).float()
    x = database.to(torch.bfloat16).float()
    return _sorted_topk(q @ x.T + bias.float()[None, :], k)


def _exact_dot(qq: torch.Tensor, xq: torch.Tensor, x_max: int) -> torch.Tensor:
    """The exact integer dot ``qq · xqᵀ`` as f32 (``f32(acc)``, rounded to
    nearest). In f32 with TF32 off while every partial sum stays below 2²⁴
    (then any summation order is exact), else in float64."""
    if qq.shape[1] * 127 * x_max < 2**24:
        if xq.is_cuda:
            torch.backends.cuda.matmul.allow_tf32 = False
        return qq.float() @ xq.float().T
    return (qq.double() @ xq.double().T).float()


def _scaled_topk(queries, x_int, x_max, db_scales, bias, k):
    qq, qs = quantize_rows_int8(queries)
    acc = _exact_dot(qq, x_int, x_max)
    # two f32 operations, in the TPU kernels' order
    scores = acc * (qs[:, None] * db_scales.float()[None, :]) + bias.float()[None, :]
    return _sorted_topk(scores, k)


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


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _library(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    launch = getattr(lib, f"{name}_launch")
    if launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        launch.argtypes = [p] * 9 + [i] * 5 + [p]
        launch.restype = ctypes.c_int
        per_sm = getattr(lib, f"{name}_ctas_per_sm")
        per_sm.argtypes = [i, i]
        per_sm.restype = i
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [i]
        err.restype = ctypes.c_char_p
    return lib


def _cuda_error(lib: ctypes.CDLL, name: str, err: int) -> RuntimeError:
    msg = getattr(lib, f"{name}_error_string")(err).decode()
    return RuntimeError(f"{name} failed: CUDA error {err} ({msg})")


@functools.lru_cache(maxsize=None)
def _ctas_per_sm(name: str, d: int, k: int) -> int:
    """Scan CTAs one SM holds at (d, k): two (the kernel's register cap)
    unless the shared memory of k's lists leaves room for fewer."""
    lib = _library(name)
    per_sm = getattr(lib, f"{name}_ctas_per_sm")(d, k)
    if per_sm < 0:
        raise _cuda_error(lib, name, -per_sm)
    if per_sm == 0:
        raise RuntimeError(f"{name}: d={d}, k={k} needs more shared memory than one SM has")
    return min(per_sm, 2)


def _scan_ctas(name: str, n: int, d: int, k: int, device: torch.device) -> int:
    """Row-range CTAs of the scan kernel: as many as fit at once on the
    card, at least 512 rows each."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(_ctas_per_sm(name, d, k) * sms, -(-n // 512)))


def _check_cuda(name: str, queries, x, bias, dtype, width, scales=None) -> tuple[int, int]:
    """Shape, type and layout checks of a CUDA launch; returns (n, q)."""
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
    qn = queries.shape[0]
    if not 1 <= qn <= MAX_Q:
        raise ValueError(f"{name}: {qn} queries; the kernel takes 1..{MAX_Q} per call")
    return n, qn


def _launch(fn, queries, qscale, x, xscale, bias, k: int, d: int, n: int, qn: int):
    """Launch ``csrc/<fn.__name__>.cu`` on the current stream (no sync)."""
    name = fn.__name__
    if k > n:
        raise ValueError(f"{name}: k={k} above the index's {n} rows")
    lib = _library(name)
    dev = x.device
    n_cta = _scan_ctas(name, n, d, k, dev)
    cand_s = torch.empty((n_cta, qn, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((n_cta, qn, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((qn, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, k), dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = getattr(lib, f"{name}_launch")(
        queries.data_ptr(), ptr(qscale), x.data_ptr(), ptr(xscale), bias.data_ptr(),
        cand_s.data_ptr(), cand_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
        qn, n, d, k, n_cta, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise _cuda_error(lib, name, err)
    fn.launches += 1
    return out_s, out_i


def _device_of(name: str, *tensors: torch.Tensor) -> str:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on different devices {devices}")
    kind = devices.pop().type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {kind}")
    return kind


def topk_pruned(queries: torch.Tensor, database: torch.Tensor, bias: torch.Tensor, k: int):
    """Exact masked top-k over bf16 rows: (scores [q, k] f32 desc, rows [q, k] int32).

    queries [q, d] (any float dtype; cast to bf16), database [N, d] bf16
    contiguous with d % 128 == 0, bias [N] f32. On CUDA: 1 <= q <= 64 and
    k <= N. Launches on the current stream and does not synchronize."""
    _check_k("topk_pruned", k)
    if _device_of("topk_pruned", queries, database, bias) == "cpu":
        return topk_pruned_reference(queries, database, bias, k)
    n, qn = _check_cuda("topk_pruned", queries, database, bias, torch.bfloat16, database.shape[1])
    q16 = queries.to(torch.bfloat16).contiguous()
    return _launch(topk_pruned, q16, None, database, None, bias, k, database.shape[1], n, qn)


def topk_int8_pruned(queries: torch.Tensor, database_q: torch.Tensor, db_scales: torch.Tensor,
                     bias: torch.Tensor, k: int):
    """Exact masked top-k over int8 rows (``pallas_topk_int8_pruned``).

    queries [q, d] float, quantized per row here (``quantize_rows_int8``);
    database_q [N, d] int8 contiguous with d % 128 == 0; db_scales [N] f32;
    bias [N] f32. On CUDA: 1 <= q <= 64 and k <= N."""
    _check_k("topk_int8_pruned", k)
    if _device_of("topk_int8_pruned", queries, database_q, db_scales, bias) == "cpu":
        return topk_int8_pruned_reference(queries, database_q, db_scales, bias, k)
    d = database_q.shape[1]
    n, qn = _check_cuda("topk_int8_pruned", queries, database_q, bias, torch.int8, d, db_scales)
    qq, qs = quantize_rows_int8(queries)
    return _launch(topk_int8_pruned, qq, qs, database_q, db_scales, bias, k, d, n, qn)


def topk_int4_pruned(queries: torch.Tensor, database_p: torch.Tensor, db_scales: torch.Tensor,
                     bias: torch.Tensor, k: int):
    """Exact masked top-k over int4-packed rows (``pallas_topk_int4_pruned``).

    queries [q, d] float, quantized per row to int8 here; database_p
    [N, d/2] int8 packed nibbles (``quantize_rows_int4``) with
    (d/2) % 128 == 0; db_scales [N] f32 (amax/7); bias [N] f32. On CUDA:
    1 <= q <= 64 and k <= N."""
    _check_k("topk_int4_pruned", k)
    if _device_of("topk_int4_pruned", queries, database_p, db_scales, bias) == "cpu":
        return topk_int4_pruned_reference(queries, database_p, db_scales, bias, k)
    d = 2 * database_p.shape[1]
    n, qn = _check_cuda("topk_int4_pruned", queries, database_p, bias, torch.int8, d, db_scales)
    qq, qs = quantize_rows_int8(queries)
    return _launch(topk_int4_pruned, qq, qs, database_p, db_scales, bias, k, d, n, qn)


topk_pruned.launches = 0
topk_int8_pruned.launches = 0
topk_int4_pruned.launches = 0
