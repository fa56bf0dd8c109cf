"""The cases of ``tests/api/test_memory_routes.py`` on the port (its ``ApiState`` on the CPU).

Memory browser routes: list / search / add / delete over real HTTP.

The management surface over the memory plane (SPA Memory tab) — the
reference reaches memories only through agent retrieval + an offline
export script (``tests/rag/export_memory_data.py``)."""

import json

import pytest
from tornado.testing import AsyncHTTPTestCase

from youtu_rag_tpu_torch.api.app import create_app
from youtu_rag_tpu_torch.api.state import ApiState
from youtu_rag_tpu_torch.core.config import IndexConfig, RAGConfig, VectorStoreConfig
from torch_api_helpers import port_registry  # noqa: F401 - a fixture

# the KBs a test registers leave the port's process-wide registry with it
pytestmark = pytest.mark.usefixtures("port_registry")


class MemoryRoutesTest(AsyncHTTPTestCase):
    def get_app(self):
        import tempfile

        rag = RAGConfig(
            vector_store=VectorStoreConfig(
                index=IndexConfig(min_capacity=256, block_rows=128)
            )
        )
        self.state = ApiState(device="cpu", 
            data_dir=tempfile.mkdtemp(prefix="yrt-mem-api-"), rag_config=rag
        )
        return create_app(self.state)

    def _json(self, resp):
        return json.loads(resp.body)

    def _add(self, content, memory_type="semantic", importance=0.5):
        r = self.fetch(
            "/api/memory/items",
            method="POST",
            body=json.dumps(
                {"content": content, "memory_type": memory_type,
                 "importance": importance}
            ),
        )
        assert r.code == 200, r.body
        return self._json(r)

    def test_add_list_stats(self):
        self._add("the capital of France is Paris", "semantic")
        self._add("user asked about quarterly revenue", "episodic")
        self._add("to export a chart, call viz.render then save", "procedural")
        data = self._json(self.fetch("/api/memory/items"))
        assert data["total"] == 3
        assert data["stats"]["semantic"] == 1
        assert data["stats"]["total"] == 3
        assert {m["memory_type"] for m in data["items"]} == {
            "semantic", "episodic", "procedural",
        }
        # newest-first ordering
        times = [m["created_at"] for m in data["items"]]
        assert times == sorted(times, reverse=True)

    def test_type_filter_and_pagination(self):
        for i in range(5):
            self._add(f"fact {i}", "semantic")
        self._add("one episode", "episodic")
        data = self._json(self.fetch("/api/memory/items?types=semantic&limit=2"))
        assert data["total"] == 5
        assert len(data["items"]) == 2
        assert all(m["memory_type"] == "semantic" for m in data["items"])
        page2 = self._json(
            self.fetch("/api/memory/items?types=semantic&limit=2&offset=4")
        )
        assert len(page2["items"]) == 1

    def test_semantic_search_ranks_relevant_first(self):
        self._add("the TPU index uses int4 packed nibbles", "semantic")
        self._add("lunch menu has pasta on fridays", "semantic")
        data = self._json(
            self.fetch("/api/memory/items?q=TPU%20int4%20packed%20nibbles")
        )
        assert data["items"], "search returned nothing"
        assert "int4" in data["items"][0]["content"]
        assert "score" in data["items"][0]

    def test_delete_single_and_batch(self):
        self._add("a", "semantic")
        self._add("b", "semantic")
        self._add("c", "working")
        items = self._json(self.fetch("/api/memory/items"))["items"]
        ids = [m["id"] for m in items]
        r = self.fetch(
            "/api/memory/items", method="DELETE",
            body=json.dumps({"ids": ids[:2]}), allow_nonstandard_methods=True,
        )
        assert self._json(r)["deleted"] == 2
        left = self._json(self.fetch("/api/memory/items"))
        assert left["total"] == 1

    def test_validation_errors(self):
        r = self.fetch(
            "/api/memory/items", method="POST", body=json.dumps({"content": ""})
        )
        assert r.code == 400
        r = self.fetch(
            "/api/memory/items", method="POST",
            body=json.dumps({"content": "x", "memory_type": "bogus"}),
        )
        assert r.code == 400
        r = self.fetch(
            "/api/memory/items", method="DELETE",
            body=json.dumps({"ids": "not-a-list"}),
            allow_nonstandard_methods=True,
        )
        assert r.code == 400
