"""The port's KnowledgeBase and CLI against the JAX package's, on the CPU.

Both build the same corpus with the hash embedder; dense and hybrid
retrieval return the same chunks in the same order with scores within
1e-4 (bf16 index, f32 sums in another order), and within 1e-5 on the int8
and int4 tiers (exact integer dots). Snapshots written by either package
load in the other and answer the same. With the trained encoder
(``provider="tpu"``, the committed ``yrt_tiny_lex``) both return the same
top documents, with scores within 3e-2 (the JAX package's bf16 encoder
tolerance: the two frameworks round bf16 at other places)."""

import asyncio
import os
import subprocess
import sys

import numpy as np
import pytest

from youtu_rag_tpu.core.config import IndexConfig as JaxIndexConfig
from youtu_rag_tpu.core.config import RAGConfig as JaxRAGConfig
from youtu_rag_tpu.core.config import VectorStoreConfig as JaxVectorStoreConfig
from youtu_rag_tpu.index.persistence import BuildManifest as JaxBuildManifest
from youtu_rag_tpu.models.embedder import HashEmbedder as JaxHashEmbedder
from youtu_rag_tpu.retrieval.kb import KnowledgeBase as JaxKB
from youtu_rag_tpu_torch.core.config import IndexConfig, RAGConfig, VectorStoreConfig
from youtu_rag_tpu_torch.index.persistence import BuildManifest
from youtu_rag_tpu_torch.models.embedder import EmbedderFactory, HashEmbedder
from youtu_rag_tpu_torch.retrieval.kb import GLOBAL_KB_REGISTRY, KBRegistry, KnowledgeBase

TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "benchmarks", "models", "yrt_tiny_lex")
ENCODER_TOL = 3e-2

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


def assert_same_results(got, want, tol=TOL):
    assert [r.chunk.id for r in got] == [r.chunk.id for r in want]
    assert [r.rank for r in got] == [r.rank for r in want]
    np.testing.assert_allclose([r.score for r in got], [r.score for r in want], rtol=0, atol=tol)


QTOL = 1e-5
TIERS = ["bfloat16", "int8", "int4"]


def tier_configs(name, storage_dtype):
    return (RAGConfig(name=name, vector_store=VectorStoreConfig(
                index=IndexConfig(storage_dtype=storage_dtype))),
            JaxRAGConfig(name=name, vector_store=JaxVectorStoreConfig(
                index=JaxIndexConfig(storage_dtype=storage_dtype))))


def jax_kb_on_the_python_hash_path(name, config):
    """A JAX KB whose hash embedder runs its Python path, which the port
    copies bit for bit: the native C path normalizes 1 ulp apart, and a
    quantized tier can turn that ulp into another level where a value
    sits exactly halfway between two."""
    kb = JaxKB(name, config)
    kb.embedder._use_native = False
    return kb


@pytest.fixture(scope="module", params=["int8", "int4"])
def quant_kbs(request, corpus):
    files = sorted(str(p) for p in corpus.iterdir())
    port_cfg, jax_cfg = tier_configs("q", request.param)
    port = KnowledgeBase("port", port_cfg, device="cpu")
    jax_kb = jax_kb_on_the_python_hash_path("jax", jax_cfg)
    asyncio.run(port.build_files(files))
    asyncio.run(jax_kb.build_files(files))
    assert port.store.index._int4 == (request.param == "int4")
    return port, jax_kb


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


@pytest.mark.parametrize("top_k", [1, 5, 20])
def test_quantized_dense_retrieval_matches_jax(quant_kbs, top_k):
    port, jax_kb = quant_kbs
    for query, doc in QUERIES:
        got = asyncio.run(port.retriever.retrieve(query, top_k=top_k, similarity_threshold=0.0))
        want = asyncio.run(jax_kb.retriever.retrieve(query, top_k=top_k, similarity_threshold=0.0))
        assert_same_results(got, want, QTOL)
        assert got[0].chunk.document_id == doc


@pytest.mark.parametrize("top_k", [3, 10])
def test_quantized_hybrid_retrieval_matches_jax(quant_kbs, top_k):
    port, jax_kb = quant_kbs
    for query, doc in QUERIES:
        got = asyncio.run(port.hybrid_retriever.retrieve(query, top_k=top_k))
        want = asyncio.run(jax_kb.hybrid_retriever.retrieve(query, top_k=top_k))
        assert_same_results(got, want, QTOL)
        assert got[0].chunk.document_id == doc


async def answers(kb):
    dense = [await kb.retriever.retrieve(q, top_k=5, similarity_threshold=0.0) for q, _ in QUERIES]
    hybrid = [await kb.hybrid_retriever.retrieve(q, top_k=5) for q, _ in QUERIES]
    return dense + hybrid


@pytest.mark.parametrize("storage_dtype", TIERS)
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshots_cross_between_the_packages(corpus, tmp_path, storage_dtype, direction):
    """A KB saved by one package loads in the other (on the port's KB's
    own device) and answers as the KB that saved it."""
    files = sorted(str(p) for p in corpus.iterdir())
    port_cfg, jax_cfg = tier_configs("snap", storage_dtype)
    port = KnowledgeBase("port", port_cfg, device="cpu")
    jax_kb = jax_kb_on_the_python_hash_path("jax", jax_cfg)
    src, dst = (jax_kb, port) if direction == "jax_to_port" else (port, jax_kb)
    asyncio.run(src.build_files(files))
    saved = src.save(str(tmp_path / "kb"))
    assert {"index.npz", "index.json", "kb.json"} <= {p.name for p in (tmp_path / "kb").iterdir()}
    loaded = dst.load(str(tmp_path / "kb"))
    assert loaded["chunks"] == saved["chunks"] == asyncio.run(src.store.count())
    if dst is port:
        assert port.store.index.device.type == "cpu"
    assert dst.store.index.config.storage_dtype == storage_dtype
    tol = TOL if storage_dtype == "bfloat16" else QTOL
    for got, want in zip(asyncio.run(answers(dst)), asyncio.run(answers(src))):
        if storage_dtype == "bfloat16":
            assert_same_results(got, want, tol)
        else:
            # a reloaded quantized index re-quantizes its dequantized rows
            # (both packages do, and int4's re-rank then sees int4
            # precision), so near-ties may reorder: the top chunk stays
            assert got[0].chunk.id == want[0].chunk.id
    # and the snapshot round-trips: the loading side's answers match the
    # other package loading the same snapshot
    twin = (jax_kb_on_the_python_hash_path("twin", jax_cfg) if dst is port
            else KnowledgeBase("twin", port_cfg, device="cpu"))
    twin.load(str(tmp_path / "kb"))
    for got, want in zip(asyncio.run(answers(port if dst is port else twin)),
                         asyncio.run(answers(twin if dst is port else jax_kb))):
        assert_same_results(got, want, tol)


@pytest.mark.parametrize("storage_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_ivf_snapshots_reload_with_ivf(corpus, tmp_path, storage_dtype, direction):
    """A snapshot of a KB with IVF built records it; loading it builds IVF
    again (with the same n_lists) in the port and in the JAX package, and
    the reloaded KB answers from the same top chunks."""
    files = sorted(str(p) for p in corpus.iterdir())
    port_cfg, jax_cfg = tier_configs("ivf", storage_dtype)
    port = KnowledgeBase("port", port_cfg, device="cpu")
    jax_kb = jax_kb_on_the_python_hash_path("jax", jax_cfg)
    src, dst = (jax_kb, port) if direction == "jax_to_port" else (port, jax_kb)
    asyncio.run(src.build_files(files))
    src.store._index.build_ivf(n_lists=2)
    src.save(str(tmp_path / "kb"))
    dst.load(str(tmp_path / "kb"))
    for kb in (dst, KnowledgeBase("again", port_cfg, device="cpu")):
        if kb is not dst:
            kb.load(str(tmp_path / "kb"))  # the port reloads its own or JAX's snapshot
        assert kb.store._index._ivf is not None and kb.store._index._ivf.n_lists == 2
        for got, want in zip(asyncio.run(answers(kb)), asyncio.run(answers(src))):
            assert got[0].chunk.id == want[0].chunk.id


def test_port_snapshot_of_an_empty_kb_raises(tmp_path):
    with pytest.raises(RuntimeError, match="empty"):
        KnowledgeBase("e", device="cpu").save(str(tmp_path / "e"))


def test_build_manifest_round_trips_and_crosses(tmp_path):
    m = BuildManifest()
    etag = BuildManifest.hash_content("some text")
    meta = BuildManifest.hash_metadata({"b": 1, "a": [1, 2]})
    assert etag == JaxBuildManifest.hash_content("some text")
    assert meta == JaxBuildManifest.hash_metadata({"a": [1, 2], "b": 1})
    m.record("a.md", etag, meta, chunk_count=3)
    m.record("b.md", "e2")
    m.forget("b.md")
    m.save(tmp_path / "m.json")
    back = BuildManifest.load(tmp_path / "m.json")
    assert back == m
    assert not back.needs_rebuild("a.md", etag, meta)
    assert back.needs_rebuild("a.md", etag, "other") and back.needs_rebuild("b.md", "e2")
    jax_back = JaxBuildManifest.load(tmp_path / "m.json")
    assert {k: vars(v) for k, v in jax_back.sources.items()} == {
        k: vars(v) for k, v in back.sources.items()}
    jax_back.save(tmp_path / "j.json")
    assert BuildManifest.load(tmp_path / "j.json") == m
    assert BuildManifest.load(tmp_path / "missing.json") == BuildManifest()


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
    """Every provider is ported now: what raises is what the JAX package
    raises (a missing checkpoint, a remote provider without a URL)."""
    from youtu_rag_tpu_torch.core.config import EmbeddingConfig, RerankerConfig
    from youtu_rag_tpu_torch.models.embedder import RemoteEmbedder
    from youtu_rag_tpu_torch.models.reranker import RemoteReranker, RerankerFactory

    with pytest.raises(FileNotFoundError):
        EmbedderFactory.create(EmbeddingConfig(provider="tpu", pretrained_dir="/nowhere"),
                               device="cpu")
    for provider in ("openai", "service"):
        emb = EmbedderFactory.create(EmbeddingConfig(provider=provider, base_url="http://x"))
        assert isinstance(emb, RemoteEmbedder)
    assert isinstance(RerankerFactory.create(RerankerConfig(provider="jina", base_url="http://x")),
                      RemoteReranker)
    assert RerankerFactory.create(RerankerConfig(provider="none")) is None


def tpu_config(cls, name):
    cfg = cls(name=name)
    cfg.knowledge_builder.embedding = cfg.knowledge_builder.embedding.model_copy(
        update={"provider": "tpu", "weights_dir": WEIGHTS})
    return cfg


@pytest.fixture(scope="module")
def encoder_kbs(corpus):
    files = sorted(str(p) for p in corpus.iterdir())
    port = KnowledgeBase("port", tpu_config(RAGConfig, "enc"), device="cpu")
    jax_kb = JaxKB("jax", tpu_config(JaxRAGConfig, "enc"))
    ps = asyncio.run(port.build_files(files))
    js = asyncio.run(jax_kb.build_files(files))
    assert ps.total_chunks == js.total_chunks > len(DOCS)
    return port, jax_kb


def test_encoder_kb_serves_the_committed_model(encoder_kbs):
    from youtu_rag_tpu_torch.models.embedder import TorchEmbedder

    port, jax_kb = encoder_kbs
    assert isinstance(port.embedder, TorchEmbedder) and port.embedder.device.type == "cpu"
    assert port.embedder.dimension == jax_kb.embedder.dimension == 1152
    assert port.store.index.dim == 1152


@pytest.mark.parametrize("hybrid", [False, True], ids=["dense", "hybrid"])
def test_encoder_kb_returns_the_jax_kb_top_documents(encoder_kbs, hybrid):
    port, jax_kb = encoder_kbs
    for query, _ in QUERIES:
        if hybrid:
            got = asyncio.run(port.hybrid_retriever.retrieve(query, top_k=5))
            want = asyncio.run(jax_kb.hybrid_retriever.retrieve(query, top_k=5))
        else:
            got = asyncio.run(port.retriever.retrieve(query, top_k=5, similarity_threshold=0.0))
            want = asyncio.run(jax_kb.retriever.retrieve(query, top_k=5,
                                                        similarity_threshold=0.0))
        assert got[0].chunk.id == want[0].chunk.id
        assert got[0].chunk.document_id == want[0].chunk.document_id
        if not hybrid:  # fused scores are rank-based; dense ones are cosines
            np.testing.assert_allclose([r.score for r in got], [r.score for r in want],
                                       rtol=0, atol=ENCODER_TOL)


def test_torch_embedder_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from youtu_rag_tpu_torch.core.config import EmbeddingConfig
    from youtu_rag_tpu_torch.models.embedder import TorchEmbedder

    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    for make in (TorchEmbedder, lambda: EmbedderFactory.create(EmbeddingConfig(provider="tpu")),
                 lambda: TorchEmbedder.from_weights_dir(WEIGHTS)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


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
    if "--provider" not in extra:
        extra = ("--provider", "hash", *extra)
    return subprocess.run(
        [sys.executable, "-m", "youtu_rag_tpu_torch.cli_chat", "--paths", str(corpus),
         "--device", "cpu", *extra],
        input="what bandwidth does v5e HBM have?\n", capture_output=True, text=True,
        cwd=REPO, timeout=120,
    )


@pytest.mark.parametrize("extra", [(), ("--hybrid",),
                                   ("--provider", "tpu", "--weights-dir", WEIGHTS)],
                         ids=["dense", "hybrid", "encoder"])
def test_cli_answers_from_tpu_md(corpus, extra):
    out = run_cli(corpus, *extra)
    assert out.returncode == 0, out.stderr
    assert "built: " in out.stdout
    first = out.stdout.split("## Context 1 (Relevance: ", 1)[1].split("## Context 2")[0]
    assert "source=tpu.md" in first and "HBM bandwidth on v5e is ~820 GB/s." in first
