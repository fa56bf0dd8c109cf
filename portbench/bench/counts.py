"""The yardstick's arithmetic: the published peaks of one NVIDIA H100 SXM
(NVIDIA's data sheet, dense rates, at the full 700 W) and the operations
and bytes the metrics count."""

from __future__ import annotations

BF16_FLOPS = 989e12  # dense bf16 tensor-core operations a second
HBM_BYTES = 3.35e12  # HBM3 bytes a second


def bert_flops(cfg: dict, tokens: float, sq_tokens: float) -> float:
    """Model operations of one BERT forward over sequences of ``tokens``
    tokens in all and ``sq_tokens`` summed squares of their lengths: in
    every layer the q, k, v and output projections (8 n d^2), the FFN
    (4 n d f) and attention's two products (4 n^2 d); multiply-adds count
    two. The embedding lookups, norms and pooler are left out."""
    d, f, layers = int(cfg["hidden_size"]), int(cfg["intermediate_size"]), \
        int(cfg["num_hidden_layers"])
    return layers * (8 * tokens * d * d + 4 * tokens * d * f + 4 * sq_tokens * d)


def attention_bound_s(b: int, h: int, t: int, t_kv: int, hd: int, elem: int) -> float:
    """The least time one attention call needs: the larger of its
    operations (4 B H T T_kv hd) at the bf16 peak and its bytes (q and the
    output [B, H, T, hd], k and v [B, H, T_kv, hd], the f32 bias [B, T_kv])
    at the HBM rate."""
    ops = 4 * b * h * t * t_kv * hd
    nbytes = elem * b * h * hd * (2 * t + 2 * t_kv) + 4 * b * t_kv
    return max(ops / BF16_FLOPS, nbytes / HBM_BYTES)


def scan_bytes(rows: int, row_bytes: int) -> int:
    """Bytes a top-k scan reads once: each scanned row's stored vector,
    scale and bias (``row_bytes``)."""
    return rows * row_bytes
