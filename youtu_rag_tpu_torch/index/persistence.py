"""Index persistence: snapshot + restore + incremental-build manifest.

The port's copy of ``youtu_rag_tpu/index/persistence.py``, writing and
reading the same layout, so a snapshot written by either package loads in
the other, onto one device or a mesh:

- ``save_index``/``load_index``: one ``.npz`` with the live rows' arrays
  (``vectors`` as f32 for bf16/f32 storage, ``vectors_q`` + ``scales`` for
  int8, ``vectors_p4`` + ``scales`` for int4, and ``cols``) plus a JSON
  sidecar with chunks, metadata schema and config. Snapshots are atomic
  (tmp + rename). ``load_index`` re-inserts the dequantized rows through
  ``add``, so a quantized index re-quantizes them (the int4 host shadow is
  rebuilt from int4 precision, as in JAX). IVF is positional (cluster-sorted
  rows, block ranges), which a save/load cycle invalidates, so the sidecar
  records only that it was built (``"ivf": {"n_lists": ...}``) and
  ``load_index`` clusters again, on the index's device, as JAX does.
- ``BuildManifest``: content-hash manifest for incremental re-embedding:
  a source is skipped when its (etag, metadata_hash) pair is unchanged.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..core.config import IndexConfig
from ..core.types import Chunk
from ..utils.hashing import content_etag, md5_hex
from ..utils.log import get_logger
from .device_index import DeviceVectorIndex
from .metadata import MetadataSchema

logger = get_logger("index.persistence")

_FORMAT_VERSION = 1


def save_index(index: DeviceVectorIndex, path: str | Path) -> None:
    """Write a snapshot: ``<path>.npz`` (arrays) + ``<path>.json`` (host state)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    with index._lock:
        live = [(r, c) for r, c in enumerate(index._chunks) if c is not None]
        vectors, scales, cols = index._stored_rows([r for r, _ in live])
    if not index._quant:  # bf16 or f32 storage, as f32 at the index's width
        vectors = vectors[:, : index.dim]
    arrays: dict[str, np.ndarray] = {}
    if index._int4:
        # raw packed nibbles at their full width (the columns interleave
        # across the low and high halves, so a [:, :dim] slice means nothing)
        arrays["vectors_p4"] = vectors
        arrays["scales"] = scales
    elif index._int8:
        arrays["vectors_q"] = vectors[:, : index.dim]
        arrays["scales"] = scales
    else:
        arrays["vectors"] = vectors

    meta = {
        "format_version": _FORMAT_VERSION,
        "dim": index.dim,
        "metric": index.metric,
        "config": index.config.model_dump(),
        "schema": index.schema.to_dict(),
        "ivf": {"n_lists": index._ivf.n_lists} if index._ivf is not None else None,
        "chunks": [
            {
                "id": c.id,
                "document_id": c.document_id,
                "content": c.content,
                "chunk_index": c.chunk_index,
                "metadata": c.metadata,
            }
            for _, c in live
        ],
    }

    tmp_npz = tempfile.NamedTemporaryFile(dir=path.parent, suffix=".npz.tmp", delete=False)
    try:
        np.savez_compressed(tmp_npz, cols=cols, **arrays)
        tmp_npz.close()
        os.replace(tmp_npz.name, f"{path}.npz")
    except BaseException:
        tmp_npz.close()
        os.unlink(tmp_npz.name)
        raise
    tmp_json = Path(f"{path}.json.tmp")
    tmp_json.write_text(json.dumps(meta, ensure_ascii=False))
    os.replace(tmp_json, f"{path}.json")
    logger.info("saved index snapshot: %d chunks -> %s", len(live), path)


def load_index(path: str | Path, config: IndexConfig | None = None,
               device: str | torch.device | None = None, mesh=None) -> DeviceVectorIndex:
    """Restore a snapshot onto ``device`` (``None`` → the CUDA card), or,
    given a ``mesh`` (``parallel.mesh``), into a ``ShardedVectorIndex`` over
    its ``db`` axis on the mesh's devices."""
    path = Path(path)
    meta = json.loads(Path(f"{path}.json").read_text())
    if meta["format_version"] != _FORMAT_VERSION:
        raise ValueError(f"snapshot format {meta['format_version']} != {_FORMAT_VERSION}")
    with np.load(f"{path}.npz") as data:
        if "vectors_p4" in data:  # int4 snapshot: unpack + dequantize
            packed = data["vectors_p4"]
            hi = packed >> 4
            lo = (packed.astype(np.int8) << 4).astype(np.int8) >> 4
            nib = np.concatenate([lo, hi], axis=1).astype(np.float32)
            vectors = (nib * data["scales"][:, None])[:, : meta["dim"]]
        elif "vectors_q" in data:  # int8 snapshot: dequantize for re-insert
            vectors = data["vectors_q"].astype(np.float32) * data["scales"][:, None]
        else:
            vectors = data["vectors"].astype(np.float32)

    cfg = config or IndexConfig.model_validate(meta["config"])
    if mesh is not None:
        from ..parallel.sharded_index import ShardedVectorIndex

        index = ShardedVectorIndex(meta["dim"], cfg, mesh=mesh)
    else:
        index = DeviceVectorIndex(meta["dim"], cfg, device=device)
    index.schema = MetadataSchema.from_dict(meta["schema"])
    chunks = [
        Chunk(c["id"], c["document_id"], c["content"], c["chunk_index"], c["metadata"])
        for c in meta["chunks"]
    ]
    if chunks:
        index.add(chunks, vectors)
    if meta.get("ivf") and chunks:
        index.build_ivf(n_lists=meta["ivf"]["n_lists"])
    logger.info("loaded index snapshot: %d chunks <- %s", len(chunks), path)
    return index


# ---------------------------------------------------------------------------
# Incremental-build manifest
# ---------------------------------------------------------------------------


@dataclass
class SourceRecord:
    source_id: str
    etag: str
    metadata_hash: str = ""
    derived_files_hash: str = ""
    chunk_count: int = 0


@dataclass
class BuildManifest:
    sources: dict[str, SourceRecord] = field(default_factory=dict)

    @staticmethod
    def hash_metadata(metadata: dict[str, Any] | None) -> str:
        return md5_hex(json.dumps(metadata or {}, sort_keys=True, ensure_ascii=False))

    @staticmethod
    def hash_content(data: bytes | str) -> str:
        return content_etag(data)

    def needs_rebuild(
        self, source_id: str, etag: str, metadata_hash: str = "", derived_files_hash: str = ""
    ) -> bool:
        rec = self.sources.get(source_id)
        if rec is None:
            return True
        return (
            rec.etag != etag
            or rec.metadata_hash != metadata_hash
            or rec.derived_files_hash != derived_files_hash
        )

    def record(
        self,
        source_id: str,
        etag: str,
        metadata_hash: str = "",
        derived_files_hash: str = "",
        chunk_count: int = 0,
    ) -> None:
        self.sources[source_id] = SourceRecord(
            source_id, etag, metadata_hash, derived_files_hash, chunk_count
        )

    def forget(self, source_id: str) -> None:
        self.sources.pop(source_id, None)

    def save(self, path: str | Path) -> None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = Path(f"{p}.tmp")
        tmp.write_text(
            json.dumps({sid: vars(r) for sid, r in self.sources.items()}, ensure_ascii=False)
        )
        os.replace(tmp, p)

    @classmethod
    def load(cls, path: str | Path) -> "BuildManifest":
        p = Path(path)
        if not p.exists():
            return cls()
        data = json.loads(p.read_text())
        return cls(sources={sid: SourceRecord(**r) for sid, r in data.items()})
