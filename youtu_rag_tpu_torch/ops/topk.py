"""Fused masked score + exact top-k over a bf16 index.

Counterpart of ``youtu_rag_tpu/ops/topk.py::pallas_topk_pruned``. The
contract is the JAX kernel's:

- scores are ``f32(bf16(q)) · f32(bf16(x))`` summed in f32, plus
  ``bias[row]`` (0 for live rows, ``NEG_INF`` for tombstones, padding and
  filtered-out rows);
- the result is the exact top k per query ordered by (score desc, row
  asc): lower rows win ties;
- slots no live row fills carry a score of ``NEG_INF`` (or ``-inf`` where
  a filter added ``NEG_INF`` to a ``NEG_INF`` bias); their row is not
  specified, and callers drop any slot with ``score <= NEG_INF / 2``.

``topk_pruned`` launches the hand-written CUDA kernel
(``csrc/topk_pruned.cu``) for CUDA tensors and runs
``topk_pruned_reference``, the plain PyTorch version, for CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

NEG_INF = float(np.finfo(np.float32).min)

MAX_K = 128  # the JAX kernel pads k to one 128-lane register row
MAX_Q = 64  # the store's search coalescer merges at most 64 queries
_LANE = 128


def topk_pruned_reference(queries: torch.Tensor, database: torch.Tensor,
                          bias: torch.Tensor, k: int):
    """Plain PyTorch version of the kernel: full score matrix, stable sort.

    Casts to bf16 and back to f32 before the matmul (a bf16 matmul would
    round the scores to bf16), and sorts with ``stable=True`` because
    ``torch.topk`` promises no tie order.
    Returns (scores [q, k] f32 desc, rows [q, k] int32)."""
    if database.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    q = queries.to(torch.bfloat16).float()
    x = database.to(torch.bfloat16).float()
    scores = q @ x.T + bias.float()[None, :]
    s, i = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :k].contiguous(), i[:, :k].to(torch.int32).contiguous()


def _library() -> ctypes.CDLL:
    lib = _build.load("topk_pruned")
    if lib.topk_pruned_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.topk_pruned_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
        lib.topk_pruned_launch.restype = ctypes.c_int
        lib.topk_pruned_error_string.argtypes = [ctypes.c_int]
        lib.topk_pruned_error_string.restype = ctypes.c_char_p
    return lib


def _scan_ctas(n: int, device: torch.device) -> int:
    """Row-range CTAs of the scan kernel: two per SM, at least 512 rows each."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(2 * sms, -(-n // 512)))


def topk_pruned(queries: torch.Tensor, database: torch.Tensor, bias: torch.Tensor, k: int):
    """Exact masked top-k: (scores [q, k] f32 desc, rows [q, k] int32).

    queries [q, d] (any float dtype; cast to bf16), database [N, d] bf16
    contiguous with d % 128 == 0, bias [N] f32. On CUDA: 1 <= q <= 64 and
    1 <= k <= 128. Launches on the current stream and does not
    synchronize."""
    devices = {queries.device, database.device, bias.device}
    if len(devices) != 1:
        raise ValueError(f"topk_pruned: tensors on different devices {devices}")
    if database.device.type == "cpu":
        return topk_pruned_reference(queries, database, bias, k)
    if database.device.type != "cuda":
        raise ValueError(f"topk_pruned: unsupported device {database.device}")
    if database.dtype != torch.bfloat16 or database.dim() != 2 or not database.is_contiguous():
        raise ValueError("topk_pruned: database must be a contiguous 2-D bf16 tensor")
    n, d = database.shape
    if d % _LANE or database.data_ptr() % 16:
        raise ValueError(f"topk_pruned: width {d} must be a multiple of {_LANE}, rows 16-byte aligned")
    if queries.dim() != 2 or queries.shape[1] != d:
        raise ValueError(f"topk_pruned: queries {tuple(queries.shape)} do not match width {d}")
    if bias.dtype != torch.float32 or tuple(bias.shape) != (n,) or not bias.is_contiguous():
        raise ValueError(f"topk_pruned: bias must be contiguous f32 [{n}]")
    qn = queries.shape[0]
    if not 1 <= qn <= MAX_Q:
        raise ValueError(f"topk_pruned: {qn} queries; the kernel takes 1..{MAX_Q} per call")
    if not 1 <= k <= min(MAX_K, n):
        raise ValueError(f"topk_pruned: k={k} outside 1..{min(MAX_K, n)}")

    lib = _library()
    dev = database.device
    n_cta = _scan_ctas(n, dev)
    q16 = queries.to(torch.bfloat16).contiguous()
    cand_s = torch.empty((n_cta, qn, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((n_cta, qn, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((qn, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, k), dtype=torch.int32, device=dev)
    err = lib.topk_pruned_launch(
        q16.data_ptr(), database.data_ptr(), bias.data_ptr(),
        cand_s.data_ptr(), cand_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
        qn, n, d, k, n_cta, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        msg = lib.topk_pruned_error_string(err).decode()
        raise RuntimeError(f"topk_pruned launch failed: CUDA error {err} ({msg})")
    topk_pruned.launches += 1
    return out_s, out_i


topk_pruned.launches = 0
