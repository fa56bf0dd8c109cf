"""Spherical k-means for IVF partitioning, in plain PyTorch.

Counterpart of ``youtu_rag_tpu/ops/kmeans.py`` (XLA there, so plain torch
here). ``kmeans_fit`` is the init draw (``kmeans_init``) followed by
Lloyd's iterations (``kmeans_lloyd``):

- assignment: argmax of ``x @ centᵀ``, ties to the first centroid, as
  ``jnp.argmax``;
- update: the segment sum of each cluster's rows over its count; an empty
  cluster keeps its old centroid; every centroid is L2-normalized, the
  norm clamped at 1e-12.

One deliberate difference: JAX draws the init rows with
``jax.random.choice(PRNGKey(seed), ...)``, which torch cannot reproduce;
the port draws them on the host with
``np.random.default_rng(seed).choice(n, C, replace=n < C)``, the same on
every device. Lloyd's iterations from the same init agree with JAX's.
"""

from __future__ import annotations

import numpy as np
import torch

from .precision import f32_matmul


def kmeans_init(n: int, n_clusters: int, seed: int) -> np.ndarray:
    """Rows of the initial centroids (host draw, deterministic per seed)."""
    return np.random.default_rng(seed).choice(n, n_clusters, replace=n < n_clusters)


def kmeans_lloyd(x: torch.Tensor, init_centroids: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` Lloyd steps of spherical k-means from ``init_centroids``
    [C, d]; returns the centroids [C, d] f32, unit norm."""
    x = x.float()
    cent = init_centroids.float()
    c = cent.shape[0]
    for _ in range(iters):
        with f32_matmul():
            assign = torch.argmax(x @ cent.T, dim=1)
        sums = torch.zeros_like(cent).index_add_(0, assign, x)
        counts = torch.bincount(assign, minlength=c).float()[:, None]
        new = torch.where(counts > 0, sums / counts.clamp_min(1.0), cent)
        cent = new / torch.linalg.vector_norm(new, dim=1, keepdim=True).clamp_min(1e-12)
    return cent


def kmeans_fit(x: torch.Tensor, n_clusters: int, iters: int = 10, seed: int = 0) -> torch.Tensor:
    """Centroids [n_clusters, d] f32 (unit norm) of ``x`` [N, d], which
    should be L2-normalized for the cosine metric."""
    idx = torch.as_tensor(kmeans_init(x.shape[0], n_clusters, seed), device=x.device)
    return kmeans_lloyd(x, x.float()[idx], iters)


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid by inner product for each row of ``x`` [N, d] (int32)."""
    with f32_matmul():
        return torch.argmax(x.float() @ centroids.float().T, dim=1).to(torch.int32)
