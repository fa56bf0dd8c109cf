"""``VectorStoreFactory`` in both packages, on the CPU.

- the port exports it (``from youtu_rag_tpu_torch.retrieval import
  VectorStoreFactory``) and it returns a ``TorchVectorStore`` on the named
  device; without a device it means the CUDA card, which this host lacks;
- stores built through either package's factory (the default device
  index, bf16 rows; JAX on its CPU backend) return the same hits for the
  same rows, with and without a filter;
- the port's ``KnowledgeBase`` builds its store through the factory, as
  JAX's does.

Tolerance: ids exactly, scores within 1e-5 (the same bf16 rows and
queries; f32 sums in another order).
"""

import asyncio

import numpy as np
import pytest
import torch

from youtu_rag_tpu.core.config import VectorStoreConfig as JaxStoreConfig
from youtu_rag_tpu.core.types import Chunk as JaxChunk
from youtu_rag_tpu.retrieval.store import VectorStoreFactory as JaxFactory
from youtu_rag_tpu_torch.core.config import VectorStoreConfig
from youtu_rag_tpu_torch.core.types import Chunk
from youtu_rag_tpu_torch.retrieval import TorchVectorStore, VectorStoreFactory
from torch_native_helpers import jax_tracer_restored  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("jax_tracer_restored")

SCORE_TOL = 1e-5
QUERIES = np.random.default_rng(7).standard_normal((4, 32)).astype(np.float32)


def run(coro):
    return asyncio.run(coro)


def chunk(cls, i):
    rng = np.random.default_rng(i)
    return cls(f"c{i}", f"d{i // 8}", f"text {i}", i % 8, metadata={"group": i % 3},
               embedding=rng.standard_normal(32).astype(np.float32).tolist())


def test_factory_is_exported_and_defaults_to_cuda():
    store = VectorStoreFactory.create(device="cpu")
    assert isinstance(store, TorchVectorStore) and store.device.type == "cpu"
    assert VectorStoreFactory.create(dim=32, device="cpu").index is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            VectorStoreFactory.create()


@pytest.mark.parametrize("filters", [None, {"group": 1}], ids=["none", "eq"])
def test_both_factories_return_the_same_hits(filters):
    jax_store = JaxFactory.create(JaxStoreConfig())
    port_store = VectorStoreFactory.create(VectorStoreConfig(), device="cpu")
    run(jax_store.add_chunks([chunk(JaxChunk, i) for i in range(96)]))
    run(port_store.add_chunks([chunk(Chunk, i) for i in range(96)]))
    want = run(jax_store.search_batch(QUERIES, top_k=6, filters=filters))
    got = run(port_store.search_batch(QUERIES, top_k=6, filters=filters))
    assert [[c.id for c, _ in r] for r in got] == [[c.id for c, _ in r] for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=0, atol=SCORE_TOL)


def test_the_kb_builds_its_store_through_the_factory(monkeypatch):
    from youtu_rag_tpu_torch.retrieval import kb as port_kb

    made = []
    real = VectorStoreFactory.create
    monkeypatch.setattr(port_kb.VectorStoreFactory, "create",
                        staticmethod(lambda *a, **k: made.append(k) or real(*a, **k)))
    kb = port_kb.KnowledgeBase("factory", device="cpu")
    assert made == [{"mesh": None, "device": "cpu"}]
    assert isinstance(kb.store, TorchVectorStore) and kb.store.device.type == "cpu"
