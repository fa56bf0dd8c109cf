"""The cases of ``tests/api/test_query_modes.py`` on the port (its ``ApiState`` on the CPU).

Query modes on the KB query route (dense | hybrid | lexical) and the
kb_hybrid_search agent tool — serving surface for retrieval/lexical.py."""

import asyncio
import json

import pytest
from tornado.testing import AsyncHTTPTestCase

from youtu_rag_tpu_torch.api.app import create_app
from youtu_rag_tpu_torch.core.config import IndexConfig, RAGConfig, VectorStoreConfig
from torch_api_helpers import port_registry  # noqa: F401 - a fixture

# the KBs a test registers leave the port's process-wide registry with it
pytestmark = pytest.mark.usefixtures("port_registry")


def _state():
    import tempfile

    from youtu_rag_tpu_torch.api.state import ApiState

    rag = RAGConfig(
        vector_store=VectorStoreConfig(index=IndexConfig(min_capacity=256, block_rows=128))
    )
    return ApiState(device="cpu", data_dir=tempfile.mkdtemp(prefix="yrt-api-qm-"), rag_config=rag)


DOCS = [
    {"id": "a.md", "content": "the moon orbits the earth. " * 5, "metadata": {"topic": "space"}},
    {"id": "b.md", "content": "registry code ZX-9981 belongs to the vault door. " * 3,
     "metadata": {"topic": "codes"}},
]


class QueryModesTest(AsyncHTTPTestCase):
    def get_app(self):
        self.state = _state()
        return create_app(self.state)

    def _json(self, resp):
        return json.loads(resp.body)

    def _build(self):
        r = self.fetch("/api/knowledge-bases", method="POST", body=json.dumps({"name": "kbq"}))
        assert r.code == 201
        r = self.fetch(
            "/api/knowledge-bases/kbq/build", method="POST",
            body=json.dumps({"documents": DOCS}),
        )
        assert r.code == 200

    def test_hybrid_and_lexical_modes(self):
        self._build()
        for mode in ("hybrid", "lexical"):
            r = self.fetch(
                "/api/knowledge-bases/kbq/query", method="POST",
                body=json.dumps({"query": "what is code ZX-9981?", "mode": mode, "top_k": 2}),
            )
            assert r.code == 200, (mode, r.body)
            data = self._json(r)
            assert data["results"], mode
            assert data["results"][0]["document_id"] == "b.md", mode

    def test_bad_mode_rejected(self):
        self._build()
        r = self.fetch(
            "/api/knowledge-bases/kbq/query", method="POST",
            body=json.dumps({"query": "x", "mode": "telepathy"}),
        )
        assert r.code == 400

    def test_lexical_mode_respects_filters(self):
        self._build()
        r = self.fetch(
            "/api/knowledge-bases/kbq/query", method="POST",
            body=json.dumps({
                "query": "ZX-9981 moon", "mode": "lexical",
                "filters": {"topic": "space"},
            }),
        )
        data = self._json(r)
        assert data["results"]
        assert all(res["metadata"]["topic"] == "space" for res in data["results"])


def test_kb_hybrid_search_tool():
    from youtu_rag_tpu_torch.core.config import RAGConfig
    from youtu_rag_tpu_torch.core.types import Document
    from youtu_rag_tpu_torch.retrieval.kb import KnowledgeBase
    from youtu_rag_tpu_torch.tools.base import ToolkitConfig
    from youtu_rag_tpu_torch.tools.kb_search import KBSearchToolkit

    rag = RAGConfig(
        vector_store=VectorStoreConfig(index=IndexConfig(min_capacity=256, block_rows=128))
    )
    kb = KnowledgeBase("tool_kb", rag, device="cpu")
    docs = [Document(d["id"], d["content"], d["metadata"]) for d in DOCS]
    asyncio.run(kb.build_documents(docs))
    tk = KBSearchToolkit(ToolkitConfig(name="kb_search", config={"kb": kb}))
    assert "kb_hybrid_search" in tk.tools_map
    out = asyncio.run(tk.call_tool("kb_hybrid_search", {"query": "code ZX-9981", "top_k": 1}))
    assert "vault door" in out
    out = asyncio.run(
        tk.call_tool(
            "kb_hybrid_search",
            {"query": "ZX-9981", "filters": json.dumps({"topic": "space"})},
        )
    )
    assert "vault door" not in out


def test_kb_embedding_search_hybrid_mode_config():
    """{"mode": "hybrid"} routes kb_embedding_search through the fusion
    retriever while keeping the tool name stable — rare-identifier queries
    then hit the exact-id guarantee even when dense similarity misses."""
    from youtu_rag_tpu_torch.core.config import RAGConfig
    from youtu_rag_tpu_torch.core.types import Document
    from youtu_rag_tpu_torch.retrieval.kb import KnowledgeBase
    from youtu_rag_tpu_torch.tools.base import ToolkitConfig
    from youtu_rag_tpu_torch.tools.kb_search import KBSearchToolkit

    rag = RAGConfig(
        vector_store=VectorStoreConfig(index=IndexConfig(min_capacity=256, block_rows=128))
    )
    kb = KnowledgeBase("tool_kb_mode", rag, device="cpu")
    docs = [Document(d["id"], d["content"], d["metadata"]) for d in DOCS]
    asyncio.run(kb.build_documents(docs))
    tk = KBSearchToolkit(
        ToolkitConfig(name="kb_search", config={"kb": kb, "mode": "hybrid"})
    )
    out = asyncio.run(
        tk.call_tool("kb_embedding_search", {"query": "code ZX-9981", "top_k": 1})
    )
    assert "vault door" in out


class Int4KbTest(AsyncHTTPTestCase):
    """The int4 storage tier is reachable from the serving surface: a KB
    created with storage_dtype=int4 builds, searches (two-stage host
    re-rank → int8-precision scores), and answers hybrid queries."""

    def get_app(self):
        self.state = _state()
        return create_app(self.state)

    def _json(self, resp):
        return json.loads(resp.body)

    def test_int4_kb_via_config(self):
        r = self.fetch(
            "/api/knowledge-bases", method="POST",
            body=json.dumps({
                "name": "kb4",
                "config": {"vector_store": {"index": {
                    "storage_dtype": "int4", "min_capacity": 256, "block_rows": 128,
                }}},
            }),
        )
        assert r.code == 201, r.body
        r = self.fetch(
            "/api/knowledge-bases/kb4/build", method="POST",
            body=json.dumps({"documents": DOCS}),
        )
        assert r.code == 200
        kb = self.state.kbs.get("kb4")
        assert kb.store.index._int4 and kb.store.index._host_q8 is not None
        q = self._json(self.fetch(
            "/api/knowledge-bases/kb4/query", method="POST",
            body=json.dumps({"query": "what is code ZX-9981?", "top_k": 2}),
        ))
        assert q["results"][0]["document_id"] == "b.md"
        qh = self._json(self.fetch(
            "/api/knowledge-bases/kb4/query", method="POST",
            body=json.dumps({"query": "ZX-9981", "mode": "hybrid", "top_k": 2}),
        ))
        assert qh["results"][0]["document_id"] == "b.md"


class HybridAlphaTest(AsyncHTTPTestCase):
    def get_app(self):
        self.state = _state()
        return create_app(self.state)

    def _json(self, resp):
        return json.loads(resp.body)

    def test_hybrid_alpha_override(self):
        r = self.fetch("/api/knowledge-bases", method="POST", body=json.dumps({"name": "kba"}))
        assert r.code == 201
        r = self.fetch(
            "/api/knowledge-bases/kba/build", method="POST",
            body=json.dumps({"documents": DOCS}),
        )
        assert r.code == 200
        # alpha=0 → pure-lexical ranking wins: the exact-code doc first
        q = self._json(self.fetch(
            "/api/knowledge-bases/kba/query", method="POST",
            body=json.dumps({"query": "ZX-9981", "mode": "hybrid",
                             "hybrid_alpha": 0.0, "top_k": 2}),
        ))
        assert q["results"][0]["document_id"] == "b.md"
        # out-of-range alpha rejected
        r = self.fetch(
            "/api/knowledge-bases/kba/query", method="POST",
            body=json.dumps({"query": "x", "mode": "hybrid", "hybrid_alpha": 2}),
        )
        assert r.code == 400
