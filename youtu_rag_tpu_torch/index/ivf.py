"""IVF state for DeviceVectorIndex: build (cluster sort) and probe planning.

The port's copy of ``youtu_rag_tpu/index/ivf.py``:
- ``build_ivf_state``: spherical k-means on a sample of the live vectors,
  a full assignment, a stable argsort → ``index.reorder``, so each cluster
  is a contiguous row range; the cluster → block ranges are recorded, and
  rows appended after the freeze live in tail blocks that every search
  probes (deletes stay tombstone biases);
- ``probe_blocks``: queries × centroids → the top ``n_probe`` clusters per
  query → the union of their blocks (plus the tail) → a block-id list of
  static length ``max_blocks``, selected blocks first in ascending id, and
  the device scalar ``n_valid``. It runs on the index's device with no
  host sync, so the scan kernel follows it directly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.kmeans import kmeans_assign, kmeans_fit
from ..ops.precision import f32_matmul
from ..utils.log import get_logger

logger = get_logger("index.ivf")


@dataclass
class IVFState:
    centroids: torch.Tensor  # [C, d] f32, unit norm
    cluster_block_start: torch.Tensor  # [C] int32: first block of each cluster
    cluster_block_count: torch.Tensor  # [C] int32: blocks it spans
    max_cluster_blocks: int  # bound on blocks per cluster
    frozen_blocks: int  # blocks covered by the freeze (the tail lies beyond)
    n_lists: int
    n_probe: int


def fit_sample_indices(n: int, seed: int, cap: int = 131072) -> np.ndarray | None:
    """Row sample for the k-means fit (None → fit on everything);
    deterministic per seed, as the JAX package draws it."""
    if n <= cap:
        return None
    sel = np.random.default_rng(seed).choice(n, cap, replace=False)
    return np.sort(sel).astype(np.int32)


def fit_and_assign(index, n_lists: int, seed: int, fit_sample: int = 131072):
    """k-means fit and full assignment with bounded device memory: the
    assignment dequantizes 2²⁰ rows at a time (a full f32 view is 4x the
    int8 bytes). Returns (centroids [C, d] on the index's device, assign
    np.int32 [size])."""
    n = index.size
    sel = fit_sample_indices(n, seed, fit_sample)
    fit_on = index.dequantize_take(sel if sel is not None else np.arange(n, dtype=np.int32))
    centroids = kmeans_fit(fit_on, n_lists, iters=index.config.kmeans_iters, seed=seed)
    del fit_on
    chunk = 1 << 20
    assigns = []
    for i in range(0, n, chunk):
        rows = np.arange(i, min(i + chunk, n), dtype=np.int64)
        part, n_valid = index.dequantize_take_padded(rows)
        assigns.append(kmeans_assign(part, centroids).cpu().numpy()[:n_valid])
    return centroids, np.concatenate(assigns)


def build_ivf_state(index, n_lists: int | None = None, seed: int = 0,
                    fit_sample: int = 131072) -> IVFState:
    """Cluster, reorder the index in place, and return the probe metadata."""
    cfg = index.config
    n_lists = n_lists or min(cfg.n_lists, max(index.size // 64, 1))
    block_rows = cfg.block_rows
    n = index.size
    if n <= 0:
        raise ValueError("cannot build IVF over an empty index")
    centroids, assign = fit_and_assign(index, n_lists, seed, fit_sample)

    index.reorder(np.argsort(assign, kind="stable"))

    counts = np.bincount(assign, minlength=n_lists)
    row_start = np.concatenate([[0], np.cumsum(counts)])
    block_start = (row_start[:-1] // block_rows).astype(np.int32)
    block_end = np.ceil(row_start[1:] / block_rows).astype(np.int32)
    block_count = np.maximum(block_end - block_start, 0).astype(np.int32)
    block_count = np.where(counts > 0, block_count, 0).astype(np.int32)
    max_cb = int(block_count.max()) if len(block_count) else 1

    state = IVFState(
        centroids=centroids,
        cluster_block_start=torch.from_numpy(block_start).to(index.device),
        cluster_block_count=torch.from_numpy(block_count).to(index.device),
        max_cluster_blocks=max(max_cb, 1),
        frozen_blocks=-(-n // block_rows),
        n_lists=n_lists,
        n_probe=min(cfg.n_probe, n_lists),
    )
    logger.info("IVF built: %d lists over %d rows (max %d blocks/cluster)", n_lists, n, max_cb)
    return state


def _pow2_at_least(x: int, floor: int = 8) -> int:
    c = floor
    while c < x:
        c *= 2
    return c


def plan_max_blocks(state: IVFState, qn: int, total_blocks: int) -> int:
    """Static bound of the probed-block list (pow2-bucketed)."""
    tail = total_blocks - state.frozen_blocks
    est = qn * state.n_probe * state.max_cluster_blocks + tail + 4
    return min(_pow2_at_least(est), max(total_blocks, 1))


def probe_blocks(
    queries: torch.Tensor,
    centroids: torch.Tensor,
    cluster_block_start: torch.Tensor,
    cluster_block_count: torch.Tensor,
    *,
    n_probe: int,
    max_cluster_blocks: int,
    total_blocks: int,
    frozen_blocks: int,
    max_blocks: int,
    adaptive_margin: float | None = None,
    min_probe: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Union of the probed clusters' blocks (and always the tail) → padded
    ids. With ``adaptive_margin`` a query keeps only the clusters whose
    centroid score is within the margin of its best (never fewer than
    ``min_probe``, default 1); dropped clusters contribute no blocks.

    Returns (block_ids int32 [max_blocks], n_valid int32 0-d), both on the
    queries' device: the selected blocks in ascending id, then the others."""
    dev = queries.device
    with f32_matmul():
        sims = queries.float() @ centroids.float().T  # [q, C]
    # a stable descending sort: torch.topk promises no tie order, and
    # jax.lax.top_k puts the lower cluster first
    top_sims, top_c = torch.sort(sims, dim=1, descending=True, stable=True)
    top_sims, top_c = top_sims[:, :n_probe], top_c[:, :n_probe]
    sel = top_c.reshape(-1)
    starts = cluster_block_start[sel].long()
    counts = cluster_block_count[sel].long()
    if adaptive_margin is not None:
        floor = 1 if min_probe is None else min_probe
        margin = torch.tensor(adaptive_margin, dtype=torch.float32, device=dev)  # f32, as JAX
        rank = torch.arange(n_probe, device=dev)[None, :]
        keep = (top_sims >= top_sims[:, :1] - margin) | (rank < floor)
        counts = torch.where(keep.reshape(-1), counts, torch.zeros_like(counts))
    offs = torch.arange(max_cluster_blocks, device=dev)[None, :]
    blocks = torch.where(offs < counts[:, None], starts[:, None] + offs,
                         torch.full_like(offs, total_blocks))  # out of range → dropped
    mask = torch.zeros(total_blocks + 1, dtype=torch.int32, device=dev)
    mask[blocks.reshape(-1)] = 1  # the .at[].max(1) union
    mask = mask[:total_blocks]
    # the fresh tail (blocks appended after the freeze) is always probed
    ar = torch.arange(total_blocks, device=dev)
    mask = torch.maximum(mask, (ar >= frozen_blocks).to(torch.int32))
    # selected first (ascending id), the rest after
    order = torch.argsort(torch.where(mask > 0, ar, total_blocks + ar))
    ids = order[:max_blocks].to(torch.int32)
    n_valid = torch.clamp(mask.sum(), max=max_blocks).to(torch.int32)
    return ids, n_valid
