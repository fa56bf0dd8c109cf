"""The port's rerankers, remote adapters and provider factories against the
JAX package's, on the CPU.

- ``TorchReranker``: seeded (the repo's trunk, the JAX parameters carried
  across) and ``from_pretrained`` (a BERT cross-encoder written by
  ``transformers``): scores within 1e-4 of ``TpuReranker``'s in f32 (values
  up to ~4; sums in another order), bf16 within 3e-2, the same order where
  the JAX scores lie further apart than that;
- ``RemoteEmbedder`` / ``RemoteReranker`` and ``post_json_with_retry``:
  each package's adapter against one ``httpx.MockTransport`` (no sockets),
  the same requests and the same answers;
- the factories: every provider branch and the environment fallbacks.
"""

import asyncio
import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youtu_rag_tpu.core.config import EmbeddingConfig as JaxEmbeddingConfig
from youtu_rag_tpu.core.config import RerankerConfig as JaxRerankerConfig
from youtu_rag_tpu.core.types import Chunk as JaxChunk
from youtu_rag_tpu.core.types import RetrievalResult as JaxResult
from youtu_rag_tpu.models import embedder as jax_embedder_mod
from youtu_rag_tpu.models import encoder as jax_encoder
from youtu_rag_tpu.models import reranker as jax_reranker_mod
from youtu_rag_tpu.utils import http as jax_http
from youtu_rag_tpu_torch.core.config import EmbeddingConfig, RerankerConfig
from youtu_rag_tpu_torch.core.types import Chunk, RetrievalResult
from youtu_rag_tpu_torch.models import embedder as port_embedder_mod
from youtu_rag_tpu_torch.models import encoder as port_encoder
from youtu_rag_tpu_torch.models import reranker as port_reranker_mod
from youtu_rag_tpu_torch.models.convert import encoder_params_from_numpy
from youtu_rag_tpu_torch.utils import http as port_http
from torch_native_helpers import jax_tracer_restored  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("jax_tracer_restored")

sys.path.insert(0, os.path.dirname(__file__))
from torch_bert_checkpoint import write_bert_dir  # noqa: E402

httpx = pytest.importorskip("httpx")

F32_SCORE, BF16_SCORE = 1e-4, 3e-2
QUERY = "quick brown fox"
DOCS = ["the quick brown fox jumps", "lazy dog", "hello world " * 40, "", "中国人 fox",
        "un ##want ed running " * 10, "a b c 1 2 3", "fox fox fox", "dog over the fox",
        "the the the"]


def results(docs, pkg="port"):
    chunk, result = (Chunk, RetrievalResult) if pkg == "port" else (JaxChunk, JaxResult)
    return [result(chunk=chunk(id=f"c{i}", document_id=f"d{i}", content=t, chunk_index=i),
                   score=0.0, rank=i + 1) for i, t in enumerate(docs)]


def assert_scores(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    order = np.argsort(-want, kind="stable")
    for a, b in zip(order, order[1:]):
        if want[a] - want[b] > 2 * tol:
            assert got[a] > got[b]


# ---------------------------------------------------------------------------
# TorchReranker
# ---------------------------------------------------------------------------

SMALL = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=1, d_ff=128, max_len=256,
             out_dim=32)


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_seeded_reranker_matches_tpu_reranker(dtype, impl):
    """The repo's trunk with the JAX parameters carried across; hd 64 and a
    256-token bucket, so "pallas_interpret" takes the kernels' branch."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                       torch.bfloat16)
    jcfg = jax_encoder.EncoderConfig(**SMALL, dtype=jdt, attention_impl=impl)
    tcfg = port_encoder.EncoderConfig(**SMALL, dtype=tdt, attention_impl=impl)
    jparams = jax_encoder.init_encoder_params(jcfg, seed=1)
    tparams = encoder_params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    jr = jax_reranker_mod.TpuReranker(config=jcfg, params=jparams, batch_size=4)
    tr = port_reranker_mod.TorchReranker(config=tcfg, params=tparams, batch_size=4, device="cpu")
    docs = DOCS + ["word " * 150]  # the T = 256 bucket
    assert_scores(tr.score(QUERY, docs), jr.score(QUERY, docs),
                  F32_SCORE if dtype == "float32" else BF16_SCORE)


@pytest.mark.parametrize("num_labels", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pretrained_reranker_matches_tpu_reranker(tmp_path, dtype, num_labels):
    """A ``transformers`` cross-encoder: WordPiece pairs with token types
    after the first [SEP], the pooler and the head, the buckets (T from 16,
    batches from 8; batch_size 4 splits the documents)."""
    transformers = pytest.importorskip("transformers")
    from torch_bert_checkpoint import VOCAB

    torch.manual_seed(num_labels)
    cfg = transformers.BertConfig(vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=2,
                                  num_attention_heads=4, intermediate_size=64,
                                  max_position_embeddings=128, num_labels=num_labels)
    d = tmp_path / "rr"
    transformers.BertForSequenceClassification(cfg).eval().save_pretrained(
        str(d), safe_serialization=True)
    (d / "vocab.txt").write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                       torch.bfloat16)
    jr = jax_reranker_mod.TpuReranker.from_pretrained(d, dtype=jdt, batch_size=4)
    tr = port_reranker_mod.TorchReranker.from_pretrained(d, dtype=tdt, batch_size=4,
                                                         device="cpu")
    assert tr.cfg.arch == "bert" and tr.cfg.attention_impl == "xla"
    assert_scores(tr.score(QUERY, DOCS), jr.score(QUERY, DOCS),
                  F32_SCORE if dtype == "float32" else BF16_SCORE)
    got = asyncio.run(tr.rerank(QUERY, results(DOCS), top_k=3))
    want = asyncio.run(jr.rerank(QUERY, results(DOCS, "jax"), top_k=3))
    if dtype == "float32":
        assert [r.chunk.id for r in got] == [r.chunk.id for r in want]
    assert [r.rank for r in got] == [1, 2, 3]
    assert asyncio.run(tr.rerank(QUERY, [])) == []


def test_from_pretrained_refuses_an_embedding_checkpoint(tmp_path):
    d = write_bert_dir(tmp_path / "emb", seed=3)
    with pytest.raises(ValueError, match="no classifier head"):
        port_reranker_mod.TorchReranker.from_pretrained(d, device="cpu")


def test_seeded_reranker_defaults(no_cuda_host):
    r = port_reranker_mod.TorchReranker(config=port_encoder.EncoderConfig(**SMALL), device="cpu")
    assert r.device.type == "cpu" and r.params["layers"]["wq"].dtype == torch.float32
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_reranker_mod.TorchReranker(config=port_encoder.EncoderConfig(**SMALL))


@pytest.fixture
def no_cuda_host(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


# ---------------------------------------------------------------------------
# the remote adapters, on one mock transport
# ---------------------------------------------------------------------------


def mock_service(log):
    """A stand-in for an OpenAI-style /embeddings, a service /embed and a
    Jina-style /rerank endpoint (its results carry two indices no caller
    may trust)."""

    def handler(request):
        body = json.loads(request.content)
        log.append((request.url.path, request.headers.get("authorization"), body))
        if request.url.path.endswith("/embeddings"):
            return httpx.Response(200, json={"data": [
                {"embedding": [float(len(t)), 1.0, 0.5]} for t in body["input"]]})
        if request.url.path.endswith("/embed"):
            return httpx.Response(200, json={"embeddings": [[float(len(t)), 2.0]
                                                            for t in body["texts"]]})
        n = len(body["documents"])
        return httpx.Response(200, json={"results": [
            {"index": i, "relevance_score": float((i * 7) % n)} for i in range(n)
        ] + [{"index": n + 3, "relevance_score": 99.0}, {"index": -1, "relevance_score": 98.0}]})

    return httpx.MockTransport(handler)


@pytest.fixture
def mocked(monkeypatch):
    """Each package's ``post_json_with_retry``, in the adapters' modules,
    bound to one mock transport; returns the request logs (port, jax)."""
    logs = {"port": [], "jax": []}
    for pkg, http, mods in (("port", port_http, (port_embedder_mod, port_reranker_mod)),
                            ("jax", jax_http, (jax_embedder_mod, jax_reranker_mod))):
        post = functools.partial(http.post_json_with_retry, transport=mock_service(logs[pkg]),
                                 backoff=0.0)
        for mod in mods:
            monkeypatch.setattr(mod, "post_json_with_retry", post)
    return logs


@pytest.mark.parametrize("provider", ["openai", "service"])
def test_remote_embedder_matches_jax(mocked, provider):
    texts = [f"text {i} " * i for i in range(7)]
    kw = dict(provider=provider, base_url="http://svc/v1/", api_key="k", batch_size=3,
              model="m")
    port = port_embedder_mod.EmbedderFactory.create(EmbeddingConfig(**kw))
    jax_ = jax_embedder_mod.EmbedderFactory.create(JaxEmbeddingConfig(**kw))
    assert isinstance(port, port_embedder_mod.RemoteEmbedder)
    got = asyncio.run(port.embed_texts(texts))
    assert got == asyncio.run(jax_.embed_texts(texts))
    assert asyncio.run(port.embed_query("q")) == asyncio.run(jax_.embed_query("q"))
    assert port.dimension == jax_.dimension == len(got[0])
    assert mocked["port"] == mocked["jax"] and len(mocked["port"]) == 4  # 3 batches + 1
    assert mocked["port"][0][1] == "Bearer k"


@pytest.mark.parametrize("top_k", [None, 2])
@pytest.mark.parametrize("provider", ["openai", "service", "jina", "tione"])
def test_remote_reranker_matches_jax(mocked, provider, top_k):
    kw = dict(provider=provider, base_url="http://svc", model="rr")
    port = port_reranker_mod.RerankerFactory.create(RerankerConfig(**kw))
    jax_ = jax_reranker_mod.RerankerFactory.create(JaxRerankerConfig(**kw))
    assert isinstance(port, port_reranker_mod.RemoteReranker)
    assert port.top_field == ("top_k" if provider == "tione" else "top_n")
    got = asyncio.run(port.rerank(QUERY, results(DOCS), top_k=top_k))
    want = asyncio.run(jax_.rerank(QUERY, results(DOCS, "jax"), top_k=top_k))
    assert [(r.chunk.id, r.score, r.rank) for r in got] == [
        (r.chunk.id, r.score, r.rank) for r in want]
    assert max(r.score for r in got) < 98.0  # the untrusted indices were ignored
    assert mocked["port"] == mocked["jax"]
    assert asyncio.run(port.rerank(QUERY, [])) == []


def _transport(script):
    calls = {"n": 0}

    def handler(request):
        status, body = script[min(calls["n"], len(script) - 1)]
        calls["n"] += 1
        return httpx.Response(status, json=body)

    return httpx.MockTransport(handler), calls


@pytest.mark.parametrize("script, outcome, calls", [
    ([(503, {}), (502, {}), (200, {"ok": True})], {"ok": True}, 3),
    ([(404, {"detail": "no"})], httpx.HTTPStatusError, 1),
    ([(503, {})], RuntimeError, 3),
    ([(429, {}), (200, {"ok": 1})], {"ok": 1}, 2),
])
def test_post_json_with_retry_matches_jax(script, outcome, calls):
    for http in (port_http, jax_http):
        t, seen = _transport(script)
        run = http.post_json_with_retry("http://svc/x", {}, transport=t, backoff=0.0)
        if isinstance(outcome, dict):
            assert asyncio.run(run) == outcome
        else:
            with pytest.raises(outcome):
                asyncio.run(run)
        assert seen["n"] == calls


# ---------------------------------------------------------------------------
# the factories
# ---------------------------------------------------------------------------

ENV = ("YRT_EMBEDDING_URL", "UTU_EMBEDDING_URL", "YRT_EMBEDDING_API_KEY", "UTU_EMBEDDING_API_KEY",
       "YRT_RERANKER_URL", "UTU_RERANKER_URL", "YRT_RERANKER_API_KEY", "UTU_RERANKER_API_KEY")


@pytest.fixture
def clean_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def test_embedder_factory_env_fallbacks(clean_env):
    for provider in ("openai", "service"):
        with pytest.raises(ValueError, match="needs base_url"):
            port_embedder_mod.EmbedderFactory.create(EmbeddingConfig(provider=provider))
    clean_env.setenv("UTU_EMBEDDING_URL", "http://env")
    clean_env.setenv("YRT_EMBEDDING_API_KEY", "secret")
    emb = port_embedder_mod.EmbedderFactory.create(EmbeddingConfig(provider="openai"))
    assert emb.config.base_url == "http://env" and emb.config.api_key == "secret"
    emb = port_embedder_mod.EmbedderFactory.create(
        EmbeddingConfig(provider="service", base_url="http://cfg"))
    assert emb.config.base_url == "http://cfg" and emb.config.api_key == "secret"
    # auto: a URL in the environment selects the service provider
    emb = port_embedder_mod.EmbedderFactory.create(EmbeddingConfig(provider="auto"))
    assert isinstance(emb, port_embedder_mod.RemoteEmbedder)
    assert emb.config.provider == "service" and emb.config.base_url == "http://env"
    wrapped = port_embedder_mod.EmbedderFactory.create(
        EmbeddingConfig(provider="service", base_url="http://x", coalesce_window_ms=5.0))
    assert isinstance(wrapped, port_embedder_mod.CoalescingEmbedder)
    with pytest.raises(ValueError, match="unknown embedding provider"):
        port_embedder_mod.EmbedderFactory.create(EmbeddingConfig.model_construct(provider="x"))


def test_embedder_factory_auto_without_url_is_the_encoder(clean_env, no_cuda_host):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_embedder_mod.EmbedderFactory.create(EmbeddingConfig(provider="auto"))
    emb = port_embedder_mod.EmbedderFactory.create(EmbeddingConfig(provider="auto"),
                                                   device="cpu")
    assert isinstance(emb, port_embedder_mod.TorchEmbedder) and emb.device.type == "cpu"


def test_reranker_factory_branches(clean_env):
    create = port_reranker_mod.RerankerFactory.create
    assert create(RerankerConfig(provider="none")) is None
    assert isinstance(create(RerankerConfig(provider="lexical")),
                      port_reranker_mod.LexicalReranker)
    tpu = create(RerankerConfig(provider="tpu"), device="cpu", batch_size=16)  # the default trunk
    assert isinstance(tpu, port_reranker_mod.TorchReranker) and tpu.device.type == "cpu"
    assert tpu.cfg == port_encoder.EncoderConfig(attention_impl="xla") and tpu.batch_size == 16
    for provider in ("openai", "service", "jina", "tione"):
        with pytest.raises(ValueError, match="needs base_url"):
            create(RerankerConfig(provider=provider))
    clean_env.setenv("YRT_RERANKER_URL", "http://rr")
    clean_env.setenv("UTU_RERANKER_API_KEY", "key")
    rr = create(RerankerConfig(provider="tione"))
    assert (rr.config.base_url, rr.config.api_key, rr.top_field) == ("http://rr", "key", "top_k")
    with pytest.raises(ValueError, match="unknown reranker provider"):
        create(RerankerConfig.model_construct(provider="x"))
