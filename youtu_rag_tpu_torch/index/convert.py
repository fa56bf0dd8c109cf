"""Carry an index's state across as numpy arrays.

``index_from_numpy`` builds the port's ``DeviceVectorIndex`` from the
arrays of an index of the JAX package, so both answer the same queries
identically. The state is a dict:

- ``dim``, ``metric``: the index's width and metric;
- ``vectors``: f32 ``[capacity, d_pad]`` holding the stored (bf16) values;
- ``bias``: f32 ``[capacity]``; ``cols``: int32 ``[capacity, C]``;
- ``chunks``: one entry per appended row, ``None`` for a tombstone, else a
  chunk object with ``id``, ``document_id``, ``content``, ``chunk_index``
  and ``metadata`` (the JAX package's ``Chunk`` qualifies);
- ``size``, ``live_count``, ``capacity``;
- ``schema``: ``MetadataSchema.to_dict()`` (key → slot and type).

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
from .metadata import MetadataSchema

_CHUNK_FIELDS = ("id", "document_id", "content", "chunk_index", "metadata")


def _chunk(c: Any) -> Chunk | None:
    return None if c is None else Chunk(*(getattr(c, f) for f in _CHUNK_FIELDS))


def index_from_numpy(state: dict, device: str | torch.device | None = None) -> DeviceVectorIndex:
    """Build a bf16 port index holding exactly ``state``'s rows."""
    schema = MetadataSchema.from_dict(state["schema"])
    cfg = IndexConfig(metric=state["metric"], max_metadata_columns=schema.max_columns)
    idx = DeviceVectorIndex(int(state["dim"]), cfg, device=device)
    cap = int(state["capacity"])
    vectors = np.array(state["vectors"], np.float32)  # a writable copy
    if vectors.shape != (cap, idx.d_pad):
        raise ValueError(f"vectors {vectors.shape} != ({cap}, {idx.d_pad})")
    with idx._lock:
        idx.capacity = cap
        idx._vectors = torch.from_numpy(vectors).to(idx.device).to(idx._store_dtype)
        idx._bias = torch.from_numpy(np.array(state["bias"], np.float32)).to(idx.device)
        idx._cols = torch.from_numpy(np.array(state["cols"], np.int32)).to(idx.device)
        idx._chunks = [_chunk(c) for c in state["chunks"]]
        idx.size = int(state["size"])
        idx.live_count = int(state["live_count"])
        idx.schema = schema
        idx._rebuild_host_maps()
    return idx
