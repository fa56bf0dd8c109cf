"""The port's KnowledgeBase and CLI against the JAX package's, on the CPU.

Both build the same corpus with the hash embedder; dense and hybrid
retrieval return the same chunks in the same order with scores within
1e-4 (bf16 index, f32 sums in another order)."""

import asyncio
import os
import subprocess
import sys

import numpy as np
import pytest

from youtu_rag_tpu.core.config import RAGConfig as JaxRAGConfig
from youtu_rag_tpu.models.embedder import HashEmbedder as JaxHashEmbedder
from youtu_rag_tpu.retrieval.kb import KnowledgeBase as JaxKB
from youtu_rag_tpu_torch.core.config import RAGConfig
from youtu_rag_tpu_torch.models.embedder import EmbedderFactory, HashEmbedder
from youtu_rag_tpu_torch.retrieval.kb import GLOBAL_KB_REGISTRY, KBRegistry, KnowledgeBase

TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DOCS = {
    "tpu.md": "# TPU\nHBM bandwidth on v5e is ~820 GB/s.\n",
    "cooking.md": "# Cooking\nBoil pasta for ten minutes in salted water, then drain it.",
    "astronomy.md": "# Astronomy\nJupiter has the largest moons; Ganymede is bigger than Mercury.",
    "gardening.md": "# Gardening\nTomato seedlings want compost, full sun and deep watering.",
    "cycling.md": "# Cycling\nInflate road bike tyres to eighty psi before a long ride.",
    "bread.md": "# Bread\nSourdough rises with a starter of wild yeast and lactobacilli.",
}
FILLER = "notes archive record paragraph section appendix summary outline draft figure".split()
QUERIES = [
    ("what bandwidth does v5e HBM have?", "tpu.md"),
    ("how long should pasta boil in salted water", "cooking.md"),
    ("which planet has moons bigger than Mercury", "astronomy.md"),
    ("tomato seedlings compost sun", "gardening.md"),
]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    for name, text in DOCS.items():
        body = text
        if name != "tpu.md":
            for _ in range(3):
                body += "\n\n" + " ".join(rng.choice(FILLER, size=150)) + "."
        (root / name).write_text(body)
    return root


@pytest.fixture(scope="module")
def kbs(corpus):
    files = sorted(str(p) for p in corpus.iterdir())
    port = KnowledgeBase("port", RAGConfig(name="port"), device="cpu")
    jax_kb = JaxKB("jax", JaxRAGConfig(name="jax"))
    ps = asyncio.run(port.build_files(files))
    js = asyncio.run(jax_kb.build_files(files))
    assert ps.total_chunks == js.total_chunks > len(DOCS)
    return port, jax_kb


def assert_same_results(got, want):
    assert [r.chunk.id for r in got] == [r.chunk.id for r in want]
    assert [r.rank for r in got] == [r.rank for r in want]
    np.testing.assert_allclose([r.score for r in got], [r.score for r in want], atol=TOL)


def test_hash_embedder_matches_jax():
    """Bit-equal to the JAX package's Python path; its native C path
    normalizes with another rounding (1 ulp, 3e-8 seen)."""
    texts = [q for q, _ in QUERIES] + list(DOCS.values()) + ["", "ünïcödé 中文 tokens!"]
    got = HashEmbedder(256).embed_batch(texts)
    np.testing.assert_array_equal(got, JaxHashEmbedder(256, use_native=False).embed_batch(texts))
    np.testing.assert_allclose(got, JaxHashEmbedder(256).embed_batch(texts), rtol=0, atol=1e-6)


@pytest.mark.parametrize("top_k", [1, 5, 20])
def test_dense_retrieval_matches_jax(kbs, top_k):
    port, jax_kb = kbs
    for query, doc in QUERIES:
        got = asyncio.run(port.retriever.retrieve(query, top_k=top_k, similarity_threshold=0.0))
        want = asyncio.run(jax_kb.retriever.retrieve(query, top_k=top_k, similarity_threshold=0.0))
        assert_same_results(got, want)
        assert got[0].chunk.document_id == doc


@pytest.mark.parametrize("top_k", [3, 10])
def test_hybrid_retrieval_matches_jax(kbs, top_k):
    port, jax_kb = kbs
    for query, doc in QUERIES:
        got = asyncio.run(port.hybrid_retriever.retrieve(query, top_k=top_k))
        want = asyncio.run(jax_kb.hybrid_retriever.retrieve(query, top_k=top_k))
        assert_same_results(got, want)
        assert got[0].chunk.document_id == doc


def test_batch_retrieve_and_filters_match_jax(kbs):
    port, jax_kb = kbs
    queries = [q for q, _ in QUERIES]
    for filters in (None, {"source": "cooking.md"}, {"file_type": {"$in": ["md"]}}):
        got = asyncio.run(port.retriever.batch_retrieve(queries, top_k=4, filters=filters))
        want = asyncio.run(jax_kb.retriever.batch_retrieve(queries, top_k=4, filters=filters))
        for g, w in zip(got, want):
            assert_same_results(g, w)


def test_kb_surface(kbs):
    port, jax_kb = kbs
    stats = asyncio.run(port.stats())
    assert stats["backend"] == "torch" and stats["device"] == "cpu"
    assert stats["chunks"] == asyncio.run(jax_kb.stats())["chunks"]
    health = asyncio.run(port.store.health())
    assert health.backend == "torch" and health.index_size_bytes == port.store.index.nbytes() > 0
    hits = asyncio.run(port.search("boil pasta in salted water", top_k=2))
    assert hits[0].chunk.document_id == "cooking.md"
    text = port.assembler.assemble(hits, format_style="markdown")
    assert text.startswith("## Context 1 (Relevance: ")
    reg = KBRegistry()
    assert reg.get_or_create("x", device="cpu") is reg.get_or_create("x")
    assert reg.names() == ["x"] and reg.remove("x") and not reg.remove("x")
    assert isinstance(GLOBAL_KB_REGISTRY, KBRegistry)


def test_unported_providers_raise():
    from youtu_rag_tpu_torch.core.config import EmbeddingConfig, RerankerConfig
    from youtu_rag_tpu_torch.models.reranker import RerankerFactory

    with pytest.raises(NotImplementedError):
        EmbedderFactory.create(EmbeddingConfig(provider="tpu"))
    with pytest.raises(NotImplementedError):
        RerankerFactory.create(RerankerConfig(provider="tpu"))
    assert RerankerFactory.create(RerankerConfig(provider="none")) is None


def test_warmup_propagates_search_failures(kbs, monkeypatch):
    port, _ = kbs

    def broken(*a, **k):
        raise RuntimeError("kernel failed")

    monkeypatch.setattr(port.store.index, "search", broken)
    with pytest.raises(RuntimeError, match="kernel failed"):
        asyncio.run(port.warmup())


def test_search_coalescer_merges_concurrent_searches(corpus):
    """Concurrent single-query searches inside the window share one index
    search and get the same hits as one-by-one searches."""
    from youtu_rag_tpu_torch.core.config import VectorStoreConfig

    cfg = RAGConfig(name="co", vector_store=VectorStoreConfig(coalesce_window_ms=20.0))
    kb = KnowledgeBase("co", cfg, device="cpu")
    asyncio.run(kb.build_files(sorted(str(p) for p in corpus.iterdir())))
    embs = kb.embedder.embed_batch([q for q, _ in QUERIES])

    async def burst():
        return await asyncio.gather(*(kb.store.search(e.tolist(), top_k=5) for e in embs))

    before = dict(kb.store._coalescer().stats)
    got = asyncio.run(burst())
    stats = kb.store._search_coalescer.stats
    assert stats["queries"] - before["queries"] == len(QUERIES)
    assert stats["dispatches"] - before["dispatches"] < len(QUERIES)
    for e, hits in zip(embs, got):
        want = kb.store.index.search(e, top_k=5)[0]
        assert [c.id for c, _ in hits] == [c.id for c, _ in want]


def test_coalescing_embedder_merges_concurrent_calls():
    from youtu_rag_tpu_torch.core.config import EmbeddingConfig
    from youtu_rag_tpu_torch.models.embedder import CoalescingEmbedder

    emb = EmbedderFactory.create(EmbeddingConfig(provider="hash", coalesce_window_ms=20.0))
    assert isinstance(emb, CoalescingEmbedder)
    texts = [q for q, _ in QUERIES]

    async def burst():
        return await asyncio.gather(*(emb.embed_query(t) for t in texts))

    got = asyncio.run(burst())
    np.testing.assert_array_equal(np.asarray(got, np.float32), HashEmbedder(256).embed_batch(texts))
    assert emb.stats["items"] == len(texts) and emb.stats["dispatches"] < len(texts)


def run_cli(corpus, *extra):
    return subprocess.run(
        [sys.executable, "-m", "youtu_rag_tpu_torch.cli_chat", "--paths", str(corpus),
         "--provider", "hash", "--device", "cpu", *extra],
        input="what bandwidth does v5e HBM have?\n", capture_output=True, text=True,
        cwd=REPO, timeout=120,
    )


@pytest.mark.parametrize("extra", [(), ("--hybrid",)], ids=["dense", "hybrid"])
def test_cli_answers_from_tpu_md(corpus, extra):
    out = run_cli(corpus, *extra)
    assert out.returncode == 0, out.stderr
    assert "built: " in out.stdout
    first = out.stdout.split("## Context 1 (Relevance: ", 1)[1].split("## Context 2")[0]
    assert "source=tpu.md" in first and "HBM bandwidth on v5e is ~820 GB/s." in first
