"""The JAX package's side of ``tests/torch_sharded_workers.py``'s
scenarios, and their comparison (for ``tests/test_torch_sharded_
multiproc*.py``)."""

from types import SimpleNamespace

import numpy as np

import torch_sharded_workers as workers
from youtu_rag_tpu.core.config import IndexConfig as JaxIndexConfig
from youtu_rag_tpu.core.types import Chunk as JaxChunk
from youtu_rag_tpu.index.persistence import load_index as jax_load
from youtu_rag_tpu.index.persistence import save_index as jax_save
from youtu_rag_tpu.parallel.mesh import get_hybrid_mesh, get_mesh
from youtu_rag_tpu.parallel.sharded_index import ShardedVectorIndex as JaxSharded

TOL = 1e-5


def jax_twin(mode: str, devices, tmp_path, search=None) -> dict:
    """The scenario on the JAX package's sharded index over ``devices``."""
    pkg = SimpleNamespace(IndexConfig=JaxIndexConfig, Chunk=JaxChunk, index=JaxSharded,
                          save=jax_save, load=jax_load, search=search or {})
    if mode == "hybrid":
        mesh, axis = get_hybrid_mesh({"ici": -1}, {"dcn": 2}, devices=devices), ("dcn", "ici")
    else:
        mesh, axis = get_mesh({"db": len(devices)}, devices=devices), "db"
    d = tmp_path / f"jax-{mode}"
    d.mkdir()
    return workers.scenario(mode, mesh, axis, str(d), pkg=pkg, one_process=True)


def compare(got: dict, want: dict, exact: bool) -> None:
    """Every step's hits: the same ids in order, scores equal or within TOL."""
    assert got.keys() == want.keys()
    assert got["size"] == want["size"]
    for step in got:
        if step in ("size", "capacity"):
            continue
        for g, w in zip(got[step], want[step], strict=True):
            assert [h[0] for h in g] == [h[0] for h in w], step
            gs, ws = np.asarray([h[1] for h in g]), np.asarray([h[1] for h in w])
            if exact:
                np.testing.assert_array_equal(gs, ws, err_msg=step)
            else:
                np.testing.assert_allclose(gs, ws, rtol=0, atol=TOL, err_msg=step)
