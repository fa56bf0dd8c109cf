"""Carry an index's state across as numpy arrays.

``index_from_numpy`` builds the port's ``DeviceVectorIndex`` from the
arrays of an index of the JAX package, so both answer the same queries
identically. The state is a dict:

- ``dim``: the index's width;
- ``config``: the index's whole ``IndexConfig.model_dump()``, as a
  snapshot carries it (storage tier, block size, IVF knobs, compaction
  ratio, ...);
- ``vectors``: the stored rows, ``[capacity, d_pad]`` f32 holding the
  stored (bf16) values; for int8 the raw int8 ``[capacity, d_pad]``, for
  int4 the raw packed nibbles ``[capacity, d_pad/2]``;
- ``scales``: f32 ``[capacity]`` (int8 and int4 only);
- ``host_q8`` int8 ``[capacity, d_pad]`` and ``host_s8`` f32 ``[capacity]``:
  the int4 re-rank's host shadow (int4 with a multiplier above 1 only);
- ``bias``: f32 ``[capacity]``; ``cols``: int32 ``[capacity, C]``;
- ``chunks``: one entry per appended row, ``None`` for a tombstone, else a
  chunk object with ``id``, ``document_id``, ``content``, ``chunk_index``
  and ``metadata`` (the JAX package's ``Chunk`` qualifies);
- ``size``, ``live_count``, ``capacity``;
- ``schema``: ``MetadataSchema.to_dict()`` (key → slot and type);
- ``ivf`` (optional): the IVF state of an index whose rows the arrays
  above hold cluster-sorted: ``centroids`` f32 [C, d_pad],
  ``cluster_block_start`` and ``cluster_block_count`` int32 [C],
  ``max_cluster_blocks``, ``frozen_blocks``, ``n_lists`` and ``n_probe``.

The port imports nothing of the JAX package: whoever holds a JAX index
extracts these arrays on its side.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.config import IndexConfig
from ..core.types import Chunk
from .device_index import DeviceVectorIndex
from .ivf import IVFState
from .metadata import MetadataSchema

_CHUNK_FIELDS = ("id", "document_id", "content", "chunk_index", "metadata")


def _chunk(c: Any) -> Chunk | None:
    return None if c is None else Chunk(*(getattr(c, f) for f in _CHUNK_FIELDS))


def _array(state: dict, key: str, dtype, shape: tuple) -> np.ndarray:
    a = np.array(state[key], dtype)  # a writable copy
    if a.shape != shape:
        raise ValueError(f"{key} {a.shape} != {shape}")
    return a


def index_from_numpy(state: dict, device: str | torch.device | None = None) -> DeviceVectorIndex:
    """Build a port index of ``state``'s storage tier holding exactly its rows."""
    schema = MetadataSchema.from_dict(state["schema"])
    idx = DeviceVectorIndex(int(state["dim"]), IndexConfig.model_validate(state["config"]),
                            device=device)
    cap = int(state["capacity"])
    if idx._quant:
        vectors = torch.from_numpy(_array(state, "vectors", np.int8, (cap, idx._vec_cols)))
        scales = torch.from_numpy(_array(state, "scales", np.float32, (cap,))).to(idx.device)
    else:
        vectors = torch.from_numpy(_array(state, "vectors", np.float32, (cap, idx.d_pad)))
        scales = None
    if idx._host_rerank:
        host_q8 = _array(state, "host_q8", np.int8, (cap, idx.d_pad))
        host_s8 = _array(state, "host_s8", np.float32, (cap,))
    with idx._lock:
        idx.capacity = cap
        # f32 → bf16 rounds to nearest even, as jnp.asarray does
        idx._vectors = vectors.to(idx.device).to(idx._store_dtype)
        idx._scales = scales
        if idx._host_rerank:
            idx._host_q8, idx._host_s8 = host_q8, host_s8
        idx._bias = torch.from_numpy(np.array(state["bias"], np.float32)).to(idx.device)
        idx._cols = torch.from_numpy(np.array(state["cols"], np.int32)).to(idx.device)
        idx._chunks = [_chunk(c) for c in state["chunks"]]
        idx.size = int(state["size"])
        idx.live_count = int(state["live_count"])
        idx.schema = schema
        idx._rebuild_host_maps()
        ivf = state.get("ivf")
        if ivf is not None:
            n_lists = int(ivf["n_lists"])
            idx._ivf = IVFState(
                centroids=torch.from_numpy(
                    _array(ivf, "centroids", np.float32, (n_lists, idx.d_pad))).to(idx.device),
                cluster_block_start=torch.from_numpy(
                    _array(ivf, "cluster_block_start", np.int32, (n_lists,))).to(idx.device),
                cluster_block_count=torch.from_numpy(
                    _array(ivf, "cluster_block_count", np.int32, (n_lists,))).to(idx.device),
                max_cluster_blocks=int(ivf["max_cluster_blocks"]),
                frozen_blocks=int(ivf["frozen_blocks"]),
                n_lists=n_lists,
                n_probe=int(ivf["n_probe"]),
            )
    return idx
