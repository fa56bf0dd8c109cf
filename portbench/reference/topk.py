"""Plain exact top-k by inner product over rows stored at a given
precision, and the stored forms themselves: bf16 rows, symmetric int8
rows with one scale a row (``amax / 127``), and int4 likewise
(``amax / 7``), all as f32 values. Rows arrive in slices from a callable,
so an index of any size fits. Imports nothing of the program."""

from __future__ import annotations

import torch


def stored(x: torch.Tensor, tier: str) -> torch.Tensor:
    """Unit rows ``x`` [n, d] f32 as the tier stores them, back in f32."""
    if tier == "bfloat16":
        return x.to(torch.bfloat16).float()
    if tier == "float8":
        from .bert import fp8_round

        return fp8_round(x, -1)
    levels = {"int8": 127.0, "int4": 7.0}[tier]
    scale = torch.clamp_min(x.abs().amax(dim=1, keepdim=True), 1e-12) / levels
    return torch.clamp(torch.round(x / scale), -levels, levels) * scale


def exact_topk(queries: torch.Tensor, slices, tier: str, k: int):
    """(scores [q, k], row ids [q, k]) of the best ``k`` rows for each
    query, best first (ties by the lower row id), over every slice that
    ``slices`` yields as (first row id, unit rows f32)."""
    q = queries.float()
    best_s = torch.full((q.shape[0], 0), float("-inf"), device=q.device)
    best_i = torch.zeros((q.shape[0], 0), dtype=torch.long, device=q.device)
    for start, x in slices:
        s = q @ stored(x, tier).T
        ids = torch.arange(start, start + x.shape[0], device=q.device).expand(q.shape[0], -1)
        cand_s = torch.cat([best_s, s], dim=1)
        cand_i = torch.cat([best_i, ids], dim=1)
        # stable: among equal scores the earlier (lower) row id stays first
        order = torch.sort(cand_s, dim=1, descending=True, stable=True).indices[:, :k]
        best_s, best_i = cand_s.gather(1, order), cand_i.gather(1, order)
    return best_s, best_i


def row_scores(queries: torch.Tensor, rows: torch.Tensor, tier: str) -> torch.Tensor:
    """Scores [q, m] of each query against its own stored rows ``rows``
    [q, m, d] (unit f32)."""
    x = stored(rows.reshape(-1, rows.shape[-1]), tier).view(rows.shape)
    return torch.einsum("qd,qmd->qm", queries.float(), x)
