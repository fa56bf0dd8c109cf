"""The check rejects a broken timed path: each fault a one-chip cell can
have is planted under the harness (which runs the rest of a run as it
does on the card), and ``correct`` comes out false: a search that returns
its state unchanged, half a batch unanswered or unstored, embeddings
altered where they are produced, a cross-encoder's order or cut broken,
BM25 left out of an ingest. One chip: no exchange between chips to leave
out."""

import numpy as np
import pytest

from youtu_rag_tpu_torch.index.device_index import DeviceVectorIndex
from youtu_rag_tpu_torch.models.embedder import TorchEmbedder
from youtu_rag_tpu_torch.models.reranker import TorchReranker
from youtu_rag_tpu_torch.retrieval.lexical import LexicalInvertedIndex
from youtu_rag_tpu_torch.retrieval.store import TorchVectorStore

from .test_portbench_cells import run_line


def stale_search(monkeypatch):
    """A search that returns its previous call's answers (state unchanged)."""
    real, last = DeviceVectorIndex.search, {}

    def search(self, q, top_k=5, **kw):
        out = real(self, q, top_k=top_k, **kw)
        prev = last.get("out")
        last["out"] = out
        if prev is None:
            return out
        return [prev[i % len(prev)] for i in range(len(out))]

    monkeypatch.setattr(DeviceVectorIndex, "search", search)


def half_search(monkeypatch):
    """A search that answers the first half of its batch only."""
    real = DeviceVectorIndex.search

    def search(self, q, top_k=5, **kw):
        out = real(self, q, top_k=top_k, **kw)
        return out[: (len(out) + 1) // 2] + [[] for _ in out[(len(out) + 1) // 2:]]

    monkeypatch.setattr(DeviceVectorIndex, "search", search)


def altered_embedding(monkeypatch):
    """Embeddings altered where they are produced."""
    real = TorchEmbedder.embed_batch

    def embed_batch(self, texts):
        out = real(self, texts)
        out[:, 0] += 0.1
        return out / np.linalg.norm(out, axis=1, keepdims=True)

    monkeypatch.setattr(TorchEmbedder, "embed_batch", embed_batch)


def add_nothing(monkeypatch):
    """A store whose add leaves its state unchanged."""
    async def add_chunks(self, chunks):
        return None

    monkeypatch.setattr(TorchVectorStore, "add_chunks", add_chunks)


def half_add(monkeypatch):
    """A store that keeps half of each batch of chunks."""
    real = TorchVectorStore.add_chunks

    async def add_chunks(self, chunks):
        await real(self, chunks[: (len(chunks) + 1) // 2])

    monkeypatch.setattr(TorchVectorStore, "add_chunks", add_chunks)


def rerank_ascending(monkeypatch):
    """A cross-encoder that serves its lowest scores, lowest first."""
    real = TorchReranker.rerank

    async def rerank(self, query, results, top_k=None):
        out = await real(self, query, results, top_k=None)
        return out[::-1][:top_k]

    monkeypatch.setattr(TorchReranker, "rerank", rerank)


def rerank_no_cut(monkeypatch):
    """A cross-encoder that serves the first k dense candidates in the
    order of its scores, not its top k."""
    real = TorchReranker.rerank

    async def rerank(self, query, results, top_k=None):
        out = await real(self, query, results, top_k=None)
        if top_k is None:
            return out
        keep = {r.chunk.id for r in results[:top_k]}
        return [r for r in out if r.chunk.id in keep]

    monkeypatch.setattr(TorchReranker, "rerank", rerank)


def bm25_skipped(monkeypatch):
    """A store that leaves its BM25 index unchanged on add."""
    monkeypatch.setattr(LexicalInvertedIndex, "add", lambda self, chunks: None)


CASES = [("tiny.dense", stale_search), ("tiny.dense", half_search),
         ("tiny.dense", altered_embedding), ("tiny.rerank", stale_search),
         ("tiny.rerank", half_search), ("tiny.rerank", altered_embedding),
         ("tiny.rerank", rerank_ascending), ("tiny.rerank", rerank_no_cut),
         ("tiny.ingest", add_nothing), ("tiny.ingest", half_add),
         ("tiny.ingest", altered_embedding), ("tiny.ingest", bm25_skipped)]


@pytest.mark.parametrize("name,fault", CASES, ids=[f"{c}-{f.__name__}" for c, f in CASES])
def test_fault_is_not_correct(tiny_tree, monkeypatch, name, fault):
    fault(monkeypatch)
    try:
        _, _, line = run_line(tiny_tree, name, 11, False)
    except RuntimeError as e:  # nothing finished or stored: no result at all
        assert "inside the window" in str(e)
        return
    assert not line["correct"], line["checks"]
