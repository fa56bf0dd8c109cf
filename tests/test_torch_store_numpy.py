"""The port's store with ``VectorStoreConfig(backend="numpy")`` against the
JAX package's, on the CPU.

- the config validates on the port (it raised before), reads "tpu" as
  "torch" still, and the store serves it with the port's own
  ``NumpyVectorIndex`` on any device;
- the same chunks give the same ids and scores through ``search``, the
  coalescer (window 2 ms), filters, deletes and ``iter_live``;
- ``health``, ``update_metadata`` and ``reserve`` follow JAX's store for
  the numpy index;
- the cases of ``tests/index/test_scan_page.py`` and the numpy-backend
  cases of ``tests/ingest/test_lexical_hybrid.py`` run on both packages
  with the same pages, the same hybrid results and the same BM25 hits.

Tolerance: ids, pages and texts exactly; scores within 1e-6 (both sides
are f32 numpy products of the same rows)."""

import asyncio

import numpy as np
import pytest

from youtu_rag_tpu.core.config import IndexConfig as JaxIndexConfig
from youtu_rag_tpu.core.config import RetrieverConfig as JaxRetrieverConfig
from youtu_rag_tpu.core.config import VectorStoreConfig as JaxStoreConfig
from youtu_rag_tpu.core.types import Chunk as JaxChunk
from youtu_rag_tpu.index.numpy_ref import NumpyVectorIndex as JaxNumpyIndex
from youtu_rag_tpu.retrieval.monitoring import StorageMonitor as JaxMonitor
from youtu_rag_tpu.retrieval.retriever import HybridRetriever as JaxHybrid
from youtu_rag_tpu.retrieval.store import TpuVectorStore
from youtu_rag_tpu_torch.core.config import IndexConfig, RetrieverConfig, VectorStoreConfig
from youtu_rag_tpu_torch.core.types import Chunk
from youtu_rag_tpu_torch.index.numpy_ref import NumpyVectorIndex
from youtu_rag_tpu_torch.retrieval.monitoring import StorageMonitor
from youtu_rag_tpu_torch.retrieval.retriever import HybridRetriever
from youtu_rag_tpu_torch.retrieval.store import TorchVectorStore
from torch_native_helpers import jax_tracer_restored  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("jax_tracer_restored")

SCORE_TOL = 1e-6


def run(coro):
    return asyncio.run(coro)


def hits(results):
    return [[(c.id, s) for c, s in row] for row in results]


def assert_same_hits(got, want):
    assert [[i for i, _ in row] for row in got] == [[i for i, _ in row] for row in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], atol=SCORE_TOL)


def both_stores(chunk_fn, n, **cfg):
    """A JAX numpy store and the port's, filled with the same chunks."""
    index = cfg.pop("index", {})
    jax_store = TpuVectorStore(JaxStoreConfig(backend="numpy", index=JaxIndexConfig(**index),
                                              **cfg))
    port_store = TorchVectorStore(VectorStoreConfig(backend="numpy", index=IndexConfig(**index),
                                                    **cfg), device="cpu")
    run(jax_store.add_chunks([chunk_fn(JaxChunk, i) for i in range(n)]))
    run(port_store.add_chunks([chunk_fn(Chunk, i) for i in range(n)]))
    return jax_store, port_store


def test_numpy_backend_validates_and_builds_the_host_index():
    assert VectorStoreConfig(backend="numpy").backend == "numpy"
    assert VectorStoreConfig(backend="tpu").backend == "torch"
    assert VectorStoreConfig().backend == "torch"
    store = TorchVectorStore(VectorStoreConfig(backend="numpy"), dim=8, device="cpu")
    assert isinstance(store.index, NumpyVectorIndex)
    assert store.device.type == "cpu"
    with pytest.raises(Exception):
        VectorStoreConfig(backend="faiss")


# ---------------------------------------------------------------------------
# search, filters, deletes, the coalescer
# ---------------------------------------------------------------------------


def random_chunk(cls, i, dim=16):
    rng = np.random.default_rng(i)
    return cls(f"c{i}", f"d{i // 10}", f"text {i}", i % 10,
               metadata={"group": i % 3, "ts": float(i)},
               embedding=rng.standard_normal(dim).astype(np.float32).tolist())


QUERIES = np.random.default_rng(99).standard_normal((5, 16)).astype(np.float32)
FILTERS = [None, {"group": 1}, {"ts": {"$gte": 30.0}}, {"$or": [{"group": 0}, {"ts": {"$lt": 5}}]}]


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
@pytest.mark.parametrize("filters", FILTERS, ids=["none", "eq", "gte", "or"])
def test_search_same_ids_and_scores(metric, filters):
    jax_store, port_store = both_stores(random_chunk, 60, distance_metric=metric)
    want = hits(run(jax_store.search_batch(QUERIES, top_k=7, filters=filters)))
    got = hits(run(port_store.search_batch(QUERIES, top_k=7, filters=filters)))
    assert_same_hits(got, want)
    assert got and all(len(row) == len(w) for row, w in zip(got, want))


def test_deletes_and_iter_live_match():
    jax_store, port_store = both_stores(random_chunk, 60)
    for store in (jax_store, port_store):
        run(store.delete(["c3", "c4", "c50"]))
        assert run(store.delete_by_document_id("d2")) == 10
    assert [c.id for c in port_store.index.iter_live()] == [
        c.id for c in jax_store.index.iter_live()]
    assert run(port_store.count()) == run(jax_store.count()) == 47
    assert_same_hits(hits(run(port_store.search_batch(QUERIES, top_k=60))),
                     hits(run(jax_store.search_batch(QUERIES, top_k=60))))
    assert run(port_store.get_by_id("c3")) is None
    assert run(port_store.get_by_id("c5")).content == run(jax_store.get_by_id("c5")).content


def test_coalescer_merges_like_jax():
    jax_store, port_store = both_stores(random_chunk, 60, coalesce_window_ms=2.0)

    async def concurrent(store):
        return await asyncio.gather(*(store.search(q.tolist(), top_k=4) for q in QUERIES))

    want = run(concurrent(jax_store))
    got = run(concurrent(port_store))
    assert_same_hits([[(c.id, s) for c, s in row] for row in got],
                     [[(c.id, s) for c, s in row] for row in want])
    stats = port_store._search_coalescer.stats
    assert stats["queries"] == len(QUERIES) and stats["dispatches"] < len(QUERIES)


def test_health_update_metadata_and_reserve_follow_jax():
    jax_store, port_store = both_stores(random_chunk, 12)
    got, want = run(port_store.health()), run(jax_store.health())
    assert (got.is_healthy, got.backend, got.total_chunks, got.index_size_bytes) == (
        want.is_healthy, want.backend, want.total_chunks, want.index_size_bytes) == (
        True, "numpy", 12, 0)
    assert run(port_store.update_metadata(["c1"], [{"group": 9}])) == run(
        jax_store.update_metadata(["c1"], [{"group": 9}])) == 0
    run(port_store.reserve(1000))
    run(jax_store.reserve(1000))
    assert run(port_store.count()) == 12


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "bf16"])
def test_index_alone_matches(quantize):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((40, 24)).astype(np.float32)
    jax_index = JaxNumpyIndex(24, JaxIndexConfig(), quantize_bf16=quantize)
    port_index = NumpyVectorIndex(24, IndexConfig(), quantize_bf16=quantize)
    jax_index.add([JaxChunk(f"r{i}", "d", "", i) for i in range(40)], x)
    port_index.add([Chunk(f"r{i}", "d", "", i) for i in range(40)], x)
    np.testing.assert_array_equal(port_index._vectors, jax_index._vectors)
    q = rng.standard_normal((3, 24)).astype(np.float32)
    assert_same_hits(hits(port_index.search(q, top_k=9)), hits(jax_index.search(q, top_k=9)))
    port_index.clear()
    assert port_index.count() == 0 and port_index.search(q, top_k=3) == [[], [], []]


# ---------------------------------------------------------------------------
# tests/index/test_scan_page.py on both packages
# ---------------------------------------------------------------------------


def page_chunk(cls, i):
    rng = np.random.default_rng(i)
    return cls(f"c{i}", f"d{i // 100}",
               f"content number {i} " + ("needle" if i % 7 == 0 else "hay"), i % 100,
               metadata={"index_type": "index_content" if i % 2 == 0 else "index_summary"},
               embedding=rng.normal(size=8).astype(np.float32).tolist())


@pytest.fixture(scope="module")
def page_stores():
    return both_stores(page_chunk, 2000)


def page_ids(result):
    page, matched = result
    return [c.id for c in page], matched


@pytest.mark.parametrize("args", [
    ({"index_type": "index_content"}, 10, 20, None),
    ({"index_type": "index_content"}, 10, 30, None),
    (None, 5, 0, "NEEDLE"),
    ({"index_type": "index_summary"}, None, 990, None),
], ids=["offset20", "offset30", "text", "unlimited"])
def test_scan_page_matches_jax(page_stores, args):
    jax_store, port_store = page_stores
    filters, limit, offset, text = args
    got = page_ids(run(port_store.scan_page(filters, limit=limit, offset=offset, text=text)))
    want = page_ids(run(jax_store.scan_page(filters, limit=limit, offset=offset, text=text)))
    assert got == want


def test_scan_page_offset_count_and_text(page_stores):
    _, store = page_stores
    page, matched = run(store.scan_page({"index_type": "index_content"}, limit=10, offset=20))
    assert matched == 1000 and len(page) == 10 and page[0].id == "c40"
    page2, _ = run(store.scan_page({"index_type": "index_content"}, limit=10, offset=30))
    assert {c.id for c in page} & {c.id for c in page2} == set()
    page, matched = run(store.scan_page(None, limit=5, offset=0, text="NEEDLE"))
    assert matched == len([i for i in range(2000) if i % 7 == 0])
    assert len(page) == 5 and all("needle" in c.content for c in page)


def test_uncounted_scan_stops_early():
    _, store = both_stores(page_chunk, 200)
    seen = {"n": 0}
    orig = store._index.iter_live

    def counting_iter():
        for c in orig():
            seen["n"] += 1
            yield c

    store._index.iter_live = counting_iter
    page = run(store.get_by_filter({}, limit=10, offset=0))
    assert len(page) == 10 and seen["n"] == 10


def test_get_by_filter_compat(page_stores):
    jax_store, port_store = page_stores
    for store in (jax_store, port_store):
        out = run(store.get_by_filter({"index_type": "index_summary"}, limit=3))
        assert len(out) == 3 and all(c.metadata["index_type"] == "index_summary" for c in out)
        assert len(run(store.get_by_filter({}, limit=None))) == 2000
    assert [c.id for c in run(port_store.get_by_filter({"index_type": "index_summary"},
                                                       limit=7, offset=3))] == [
        c.id for c in run(jax_store.get_by_filter({"index_type": "index_summary"},
                                                  limit=7, offset=3))]


# ---------------------------------------------------------------------------
# tests/ingest/test_lexical_hybrid.py's numpy-backend cases on both packages
# ---------------------------------------------------------------------------


class WeakEmbedder:
    """Dense embeddings with no lexical signal (the JAX test's: a direction
    seeded by the text's length only)."""

    dimension = 32

    async def embed_texts(self, texts):
        out = []
        for t in texts:
            rng = np.random.default_rng(len(t) % 7)
            v = rng.standard_normal(32)
            out.append((v / np.linalg.norm(v)).tolist())
        return out

    async def embed_query(self, text):
        return (await self.embed_texts([text]))[0]


def corpus_chunk(cls, i, n_filler):
    if i == n_filler:
        return cls(id="c999", document_id="needle_doc",
                   content="The registry number assigned to artifact-Z9 is 71205.",
                   chunk_index=999, metadata={"kind": "needle"})
    return cls(id=f"c{i}", document_id=f"f{i}",
               content=f"routine observation {i} about field calibration and protocols",
               chunk_index=i, metadata={})


def corpus_stores(n_filler=120, lexical_index=True):
    emb = WeakEmbedder()

    def chunk(cls, i):
        c = corpus_chunk(cls, i, n_filler) if lexical_index else cls(
            id=f"c{i}", document_id=f"f{i}", content=f"filler text {i}", chunk_index=i,
            metadata={})
        c.embedding = run(emb.embed_texts([c.content]))[0]
        return c

    n = n_filler + 1 if lexical_index else n_filler
    jax_store, port_store = both_stores(chunk, n, lexical_index=lexical_index,
                                        index={"min_capacity": 256, "block_rows": 128})
    return jax_store, port_store, emb


def hybrid(store, emb, cls, query, top_k=5, filters=None):
    r = cls(store, emb, (RetrieverConfig if cls is HybridRetriever else JaxRetrieverConfig)(
        top_k=top_k, similarity_threshold=0.0))
    return [(res.chunk.id, res.score, res.rank) for res in run(r.retrieve(query,
                                                                          filters=filters))]


def assert_same_results(got, want):
    assert [(i, r) for i, _, r in got] == [(i, r) for i, _, r in want]
    np.testing.assert_allclose([s for _, s, _ in got], [s for _, s, _ in want], atol=SCORE_TOL)


def test_hybrid_recovers_needle_with_weak_dense():
    jax_store, port_store, emb = corpus_stores()
    got = hybrid(port_store, emb, HybridRetriever, "registry number of artifact-Z9?")
    assert_same_results(got, hybrid(jax_store, emb, JaxHybrid, "registry number of artifact-Z9?"))
    assert any(i == "c999" for i, _, _ in got)
    assert all(-1.0 <= s <= 1.5 for _, s, _ in got)


def test_hybrid_pool_fallback_without_lexical_index():
    jax_store, port_store, emb = corpus_stores(n_filler=8, lexical_index=False)
    assert port_store._lexical is None
    got = hybrid(port_store, emb, HybridRetriever, "filler text 3", top_k=3)
    assert got
    assert_same_results(got, hybrid(jax_store, emb, JaxHybrid, "filler text 3", top_k=3))


def test_hybrid_respects_filters_on_lexical_side():
    jax_store, port_store, emb = corpus_stores(n_filler=30)
    f = {"kind": {"$eq": "needle"}}
    got = hybrid(port_store, emb, HybridRetriever, "registry number of artifact-Z9?", filters=f)
    assert got and [i for i, _, _ in got] == ["c999"]
    assert_same_results(got, hybrid(jax_store, emb, JaxHybrid, "registry number of artifact-Z9?",
                                    filters=f))


@pytest.mark.parametrize("how", ["delete", "delete_by_document"])
def test_store_delete_drops_lexical_hit(how):
    jax_store, port_store, _ = corpus_stores(n_filler=20)
    for store in (jax_store, port_store):
        if how == "delete":
            run(store.delete(["c999"]))
        else:
            run(store.delete_by_document_id("needle_doc"))
    got = [(c.id, s) for c, s in run(port_store.lexical_search("artifact-Z9 registry", top_k=5))]
    want = [(c.id, s) for c, s in run(jax_store.lexical_search("artifact-Z9 registry", top_k=5))]
    assert got == want and all(i != "c999" for i, _ in got)


def test_rebuild_lexical_from_live_chunks():
    jax_store, port_store, _ = corpus_stores(n_filler=10)
    for store in (jax_store, port_store):
        store._lexical.clear()
        assert run(store.lexical_search("artifact-Z9", top_k=3)) == []
        store.rebuild_lexical()
    got = [(c.id, s) for c, s in run(port_store.lexical_search("artifact-Z9", top_k=3))]
    assert got and got[0][0] == "c999"
    assert got == [(c.id, s) for c, s in run(jax_store.lexical_search("artifact-Z9", top_k=3))]
    assert ([(c.id, s) for c, s in run(port_store.rare_term_search("artifact-Z9"))]
            == [(c.id, s) for c, s in run(jax_store.rare_term_search("artifact-Z9"))])


def test_monitor_exposes_lexical_stats():
    jax_store, port_store, _ = corpus_stores(n_filler=10)
    got = run(StorageMonitor(port_store, name="kb").collect_metrics())
    want = run(JaxMonitor(jax_store, name="kb").collect_metrics())
    assert got["lexical_index"] == want["lexical_index"]
    assert got["lexical_index"]["documents"] == 11 and got["lexical_index"]["terms"] > 0
    assert (got["healthy"], got["total_chunks"], got["index_size_bytes"]) == (
        want["healthy"], want["total_chunks"], want["index_size_bytes"])
