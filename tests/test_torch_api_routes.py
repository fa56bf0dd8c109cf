"""The cases of ``tests/api/test_api.py`` on the port (its ``ApiState`` on the CPU).

API service tests over real HTTP (tornado AsyncHTTPTestCase)."""

import json

import pytest
from tornado.testing import AsyncHTTPTestCase

from youtu_rag_tpu_torch.agents.config import AgentConfig
from youtu_rag_tpu_torch.agents.llm import FakeChatClient
from youtu_rag_tpu_torch.agents.simple_agent import SimpleAgent
from youtu_rag_tpu_torch.api.app import create_app
from youtu_rag_tpu_torch.api.state import ApiState
from youtu_rag_tpu_torch.core.config import IndexConfig, RAGConfig, VectorStoreConfig
from youtu_rag_tpu_torch.core.types import Document
from torch_api_helpers import port_registry  # noqa: F401 - a fixture

# the KBs a test registers leave the port's process-wide registry with it
pytestmark = pytest.mark.usefixtures("port_registry")


def _state(tmp_suffix="t"):
    import tempfile

    rag = RAGConfig(vector_store=VectorStoreConfig(index=IndexConfig(min_capacity=256, block_rows=128)))
    state = ApiState(device="cpu", data_dir=tempfile.mkdtemp(prefix=f"yrt-api-{tmp_suffix}-"), rag_config=rag)
    # hermetic agent: scripted LLM
    state.agent = SimpleAgent(
        AgentConfig(),
        client=FakeChatClient(rule_fn=lambda m, t: FakeChatClient.text_response("agent answer")),
    )
    return state


class ApiTest(AsyncHTTPTestCase):
    def get_app(self):
        self.state = _state()
        return create_app(self.state)

    def _json(self, resp):
        return json.loads(resp.body)

    # -- health / agents ---------------------------------------------------

    def test_health(self):
        r = self.fetch("/health")
        assert r.code == 200
        data = self._json(r)
        assert data["status"] == "healthy"

    def test_agents_info_and_switch(self):
        data = self._json(self.fetch("/api/agents"))
        assert data["current"]["type"] == "simple"
        r = self.fetch(
            "/api/agents/switch", method="POST", body=json.dumps({"type": "orchestra"})
        )
        assert r.code == 200
        data = self._json(self.fetch("/api/agents"))
        assert data["current"]["type"] == "orchestra"
        r = self.fetch("/api/agents/switch", method="POST", body=json.dumps({"type": "bogus"}))
        assert r.code == 400

    # -- kb lifecycle ------------------------------------------------------

    def test_kb_crud_build_query(self):
        r = self.fetch("/api/knowledge-bases", method="POST", body=json.dumps({"name": "kb1"}))
        assert r.code == 201
        # duplicate
        r = self.fetch("/api/knowledge-bases", method="POST", body=json.dumps({"name": "kb1"}))
        assert r.code == 409

        docs = [
            {"id": "a.md", "content": "the moon orbits the earth. " * 5, "metadata": {"topic": "space"}},
            {"id": "b.md", "content": "pasta needs boiling water. " * 5, "metadata": {"topic": "food"}},
        ]
        r = self.fetch(
            "/api/knowledge-bases/kb1/build", method="POST", body=json.dumps({"documents": docs})
        )
        assert r.code == 200
        build = self._json(r)
        assert build["status"]["status"] == "completed"
        assert build["status"]["total_chunks"] >= 2

        r = self.fetch(
            "/api/knowledge-bases/kb1/query",
            method="POST",
            body=json.dumps({"query": "what orbits the earth", "top_k": 1}),
        )
        data = self._json(r)
        assert data["results"][0]["document_id"] == "a.md"
        assert data["retrieval_time_ms"] > 0

        # filtered query
        r = self.fetch(
            "/api/knowledge-bases/kb1/query",
            method="POST",
            body=json.dumps({"query": "moon", "filters": {"topic": "food"}}),
        )
        data = self._json(r)
        assert all(res["metadata"]["topic"] == "food" for res in data["results"])

        logs = self._json(self.fetch("/api/knowledge-bases/kb1/build-logs"))
        assert logs["logs"] and logs["logs"][0]["status"] == "completed"

        r = self.fetch("/api/knowledge-bases/kb1", method="DELETE")
        assert r.code == 200
        assert self.fetch("/api/knowledge-bases/kb1").code == 404

    def test_kb_build_missing_file(self):
        r = self.fetch(
            "/api/knowledge-bases/kbx/build",
            method="POST",
            body=json.dumps({"files": ["ghost.md"]}),
        )
        assert r.code == 200
        data = self._json(r)
        assert any("ghost.md" in e for e in data["status"]["errors"])

    # -- files -------------------------------------------------------------

    def _multipart(self, filename, content: bytes):
        boundary = "xyzboundary"
        body = (
            f"--{boundary}\r\n"
            f'Content-Disposition: form-data; name="file"; filename="{filename}"\r\n'
            f"Content-Type: text/plain\r\n\r\n"
        ).encode() + content + f"\r\n--{boundary}--\r\n".encode()
        headers = {"Content-Type": f"multipart/form-data; boundary={boundary}"}
        return body, headers

    def test_file_upload_list_download_delete(self):
        body, headers = self._multipart("notes.md", b"# hello\nfile content")
        r = self.fetch("/api/files/upload", method="POST", body=body, headers=headers)
        assert r.code == 201
        meta = self._json(r)
        assert meta["name"] == "notes.md" and meta["size"] > 0

        files = self._json(self.fetch("/api/files"))["files"]
        assert any(f["name"] == "notes.md" for f in files)

        r = self.fetch("/api/files/notes.md")
        assert r.code == 200 and b"file content" in r.body

        # build a KB from the uploaded file
        r = self.fetch(
            "/api/knowledge-bases/kbf/build", method="POST", body=json.dumps({"files": ["notes.md"]})
        )
        assert self._json(r)["status"]["total_chunks"] >= 1

        # referenced file: delete refuses without force (ref reference checks)
        refs = self._json(self.fetch("/api/files/notes.md/references"))
        assert refs["is_referenced"] and refs["references"][0]["kb"] == "kbf"
        blocked = self.fetch("/api/files/notes.md", method="DELETE")
        assert blocked.code == 409
        assert self.fetch("/api/files/notes.md?force=true", method="DELETE").code == 200
        assert self.fetch("/api/files/notes.md").code == 404

    def test_upload_with_progress(self):
        body, headers = self._multipart("p.md", b"progress tracked")
        r = self.fetch("/api/files/upload-with-progress", method="POST", body=body, headers=headers)
        assert r.code == 202
        task_id = self._json(r)["task_id"]
        # background task runs on the same loop; by the time we fetch it is done
        r = self.fetch(f"/api/files/upload-progress/{task_id}")
        data = self._json(r)
        assert data["status"] in ("COMPLETED", "UPLOADING", "METADATA_EXTRACTING", "CHUNK_PROCESSING", "PENDING")

    # -- embed / rerank ----------------------------------------------------

    def test_embed_and_rerank(self):
        r = self.fetch(
            "/api/embedding/embed", method="POST", body=json.dumps({"texts": ["hello world"]})
        )
        data = self._json(r)
        assert data["dimension"] > 0 and len(data["embeddings"]) == 1

        r = self.fetch(
            "/api/reranker/rerank",
            method="POST",
            body=json.dumps(
                {"query": "capital of france", "documents": ["paris is the capital of france", "bananas"]}
            ),
        )
        data = self._json(r)
        assert data["results"][0]["index"] == 0

    # -- chat --------------------------------------------------------------

    def test_chat_non_stream(self):
        r = self.fetch(
            "/api/chat", method="POST", body=json.dumps({"query": "hi", "stream": False})
        )
        data = self._json(r)
        assert data["answer"] == "agent answer"
        assert data["trace_id"]

    def test_chat_sse_stream(self):
        r = self.fetch("/api/chat", method="POST", body=json.dumps({"query": "hi"}))
        assert r.code == 200
        assert r.headers["Content-Type"].startswith("text/event-stream")
        events = [json.loads(line[5:]) for line in r.body.decode().split("\n") if line.startswith("data:")]
        types = [e["type"] for e in events]
        assert "text_delta" in types and types[-1] == "done"

    def test_agents_catalog_from_yaml(self):
        """/api/agents exposes the editable frontend catalog loaded from
        configs/rag/frontend_agents.yaml (ref routes/config.py)."""
        data = self._json(self.fetch("/api/agents"))
        names = [a["name"] for a in data["catalog"]]
        assert "kb_search" in names and "parallel" in names
        kb = next(a for a in data["catalog"] if a["name"] == "kb_search")
        assert kb["type"] == "simple" and kb["icon"]

    def test_chat_auto_select_stream(self):
        """Auto-select mode: LLM agent choice (falls back to kb_search with
        the scripted client), per-agent streaming, done carries the pick
        (ref routes/chat.py auto_select_and_stream)."""
        r = self.fetch(
            "/api/chat", method="POST", body=json.dumps({"query": "hi", "auto_select": True})
        )
        assert r.code == 200
        events = [json.loads(l[5:]) for l in r.body.decode().split("\n") if l.startswith("data:")]
        types = [e["type"] for e in events]
        plan = next(e for e in events if e["type"] == "plan")
        assert plan["data"]["selected_agents"] == ["kb_search"]
        assert "agent_switch" in types and "text_delta" in types
        assert events[-1]["type"] == "done"
        assert events[-1]["auto_selected"] == ["kb_search"]
        # non-streaming auto-select is rejected like the reference
        r = self.fetch(
            "/api/chat",
            method="POST",
            body=json.dumps({"query": "hi", "auto_select": True, "stream": False}),
        )
        assert r.code == 400

    def test_chat_missing_query(self):
        r = self.fetch("/api/chat", method="POST", body=json.dumps({}))
        assert r.code == 400
        assert "query" in self._json(r)["error"]

    # -- memory / monitor --------------------------------------------------

    def test_memory_toggle(self):
        assert self._json(self.fetch("/api/memory/config"))["memoryEnabled"] is False
        r = self.fetch(
            "/api/memory/config", method="POST", body=json.dumps({"memoryEnabled": True})
        )
        assert self._json(r)["memoryEnabled"] is True
        assert self.state.memory_toolkit is not None

    def test_monitor_endpoints(self):
        self.fetch("/api/knowledge-bases", method="POST", body=json.dumps({"name": "kbm"}))
        data = self._json(self.fetch("/api/monitor/health"))
        assert data["overall_healthy"] is True
        assert "kbm" in data["backends"]
        metrics = self._json(self.fetch("/api/monitor/metrics"))
        assert "kbm" in metrics["metrics"]


class UiTest(AsyncHTTPTestCase):
    def get_app(self):
        return create_app(_state("ui"))

    def test_index_page_served(self):
        r = self.fetch("/")
        assert r.code == 200
        assert b"youtu-rag-tpu" in r.body
        assert b"/static/app.js" in r.body  # SPA shell loads the module app


class QaRouteTest(AsyncHTTPTestCase):
    def get_app(self):
        return create_app(_state("qa"))

    def test_qa_route(self):
        import asyncio as _aio

        # build a KB with QA pairs through the builder agent path
        from youtu_rag_tpu_torch.ingest.agent import BuildRequest, KnowledgeBuilderAgent
        from youtu_rag_tpu_torch.ingest.processors import SourceTask

        state = self._app.settings["api_state"]
        kb = state.get_or_create_kb("kbqa")
        agent = KnowledgeBuilderAgent("kbqa", kb.store, kb.embedder)
        self.io_loop.run_sync(
            lambda: agent.build(
                BuildRequest(
                    kb_name="kbqa",
                    tasks=[
                        SourceTask(
                            "faq",
                            "qa",
                            qa_pairs=[
                                {"question": "what is the refund window?", "answer": "30 days"},
                                {"question": "who is the ceo?", "answer": "Jane Doe"},
                            ],
                        )
                    ],
                )
            )
        )
        r = self.fetch(
            "/api/knowledge-bases/kbqa/qa",
            method="POST",
            # hash-embedder similarities are modest; production encoders
            # clear the default 0.6 threshold
            body=json.dumps({"question": "refund window length?", "threshold": 0.25}),
        )
        data = json.loads(r.body)
        assert data["matched"] is not None
        assert data["matched"]["answer"] == "30 days"
        # low-similarity question → no confident match
        r = self.fetch(
            "/api/knowledge-bases/kbqa/qa",
            method="POST",
            body=json.dumps({"question": "zebra stripes pattern", "threshold": 0.9}),
        )
        data = json.loads(r.body)
        assert data["matched"] is None


class WsAndTrajectoryTest(AsyncHTTPTestCase):
    def get_app(self):
        import tempfile

        from youtu_rag_tpu_torch.db.service import DBService

        self.state = _state("ws")
        self.state.db = DBService(url=f"sqlite:///{tempfile.mkdtemp()}/t.db")
        self.state.agent = None  # force lazy creation with trajectory sink
        self.state.agent_config.model.model = "fake"
        return create_app(self.state)

    def test_ws_chat_and_trajectory_persist(self):
        from tornado.websocket import websocket_connect

        async def flow():
            # swap in a hermetic client after lazy agent creation
            agent = await self.state.get_agent()
            agent.client = FakeChatClient(
                rule_fn=lambda m, t: FakeChatClient.text_response("ws answer")
            )
            url = f"ws://127.0.0.1:{self.get_http_port()}/ws/chat"
            conn = await websocket_connect(url)
            await conn.write_message(json.dumps({"query": "hello ws"}))
            events = []
            while True:
                msg = await conn.read_message()
                assert msg is not None
                card = json.loads(msg)
                events.append(card["type"])
                if card["type"] in ("done", "error"):
                    break
            conn.close()
            return events

        events = self.io_loop.run_sync(flow)
        assert "text_delta" in events and events[-1] == "done"

        r = self.fetch("/api/trajectories")
        data = json.loads(r.body)
        assert data["available"] is True
        assert data["trajectories"][0]["output"] == "ws answer"


class ChunksRouteTest(AsyncHTTPTestCase):
    def get_app(self):
        return create_app(_state("chunks"))

    def test_chunks_browse(self):
        docs = [
            {"id": "a.md", "content": "alpha content " * 20, "metadata": {"topic": "x"}},
            {"id": "b.md", "content": "beta content " * 20, "metadata": {"topic": "y"}},
        ]
        self.fetch(
            "/api/knowledge-bases/kbc/build", method="POST", body=json.dumps({"documents": docs})
        )
        r = self.fetch("/api/knowledge-bases/kbc/chunks?limit=10")
        data = json.loads(r.body)
        assert data["total"] >= 2
        assert {c["document_id"] for c in data["chunks"]} >= {"a.md", "b.md"}
        # filter by document
        r = self.fetch("/api/knowledge-bases/kbc/chunks?document_id=a.md")
        data = json.loads(r.body)
        assert data["chunks"] and all(c["document_id"] == "a.md" for c in data["chunks"])
        assert self.fetch("/api/knowledge-bases/ghost/chunks").code == 404


class SnapshotRouteTest(AsyncHTTPTestCase):
    def get_app(self):
        return create_app(_state("snap"))

    def test_snapshot_save_restore(self):
        docs = [{"id": "s.md", "content": "snapshot me " * 30}]
        self.fetch(
            "/api/knowledge-bases/kbs/build", method="POST", body=json.dumps({"documents": docs})
        )
        r = self.fetch(
            "/api/knowledge-bases/kbs/snapshot", method="POST", body=json.dumps({"action": "save"})
        )
        assert r.code == 200
        data = json.loads(r.body)
        assert data["chunks"] >= 1

        # clear then restore
        state = self._app.settings["api_state"]
        kb = state.kbs.get("kbs")
        self.io_loop.run_sync(kb.store.clear)
        r = self.fetch(
            "/api/knowledge-bases/kbs/snapshot",
            method="POST",
            body=json.dumps({"action": "restore"}),
        )
        assert json.loads(r.body)["chunks"] >= 1
        r = self.fetch(
            "/api/knowledge-bases/kbs/query",
            method="POST",
            body=json.dumps({"query": "snapshot"}),
        )
        assert json.loads(r.body)["results"]

    def test_snapshot_empty_kb_clean_error(self):
        self.fetch("/api/knowledge-bases", method="POST", body=json.dumps({"name": "kbe"}))
        r = self.fetch(
            "/api/knowledge-bases/kbe/snapshot", method="POST", body=json.dumps({"action": "save"})
        )
        assert r.code == 400


class QaPairsMgmtTest(AsyncHTTPTestCase):
    def get_app(self):
        return create_app(_state("qamgmt"))

    def test_qa_pairs_add_list_search_delete(self):
        # add pairs through the management route (no prior KB needed)
        r = self.fetch(
            "/api/knowledge-bases/kbm/qa-pairs",
            method="POST",
            body=json.dumps({"source_id": "faq", "pairs": [
                {"question": "what is the refund window?", "answer": "30 days"},
                {"question": "who is the ceo?", "answer": "Jane Doe", "related_file": "org.md"},
            ]}),
        )
        assert r.code == 201, r.body
        assert json.loads(r.body)["added"] == 2

        # list
        r = self.fetch("/api/knowledge-bases/kbm/qa-pairs")
        data = json.loads(r.body)
        assert data["matched"] == 2
        byq = {p["question"]: p for p in data["qa_pairs"]}
        assert byq["who is the ceo?"]["answer"] == "Jane Doe"
        assert byq["who is the ceo?"]["related_file"] == "org.md"

        # substring search
        r = self.fetch("/api/knowledge-bases/kbm/qa-pairs?q=refund")
        data = json.loads(r.body)
        assert data["matched"] == 1 and data["qa_pairs"][0]["answer"] == "30 days"

        # the qa answering route sees the managed pairs
        r = self.fetch(
            "/api/knowledge-bases/kbm/qa",
            method="POST",
            body=json.dumps({"question": "refund window?", "threshold": 0.25}),
        )
        assert json.loads(r.body)["matched"]["answer"] == "30 days"

        # delete one by chunk id, rest by source
        cid = data["qa_pairs"][0]["id"]
        r = self.fetch(f"/api/knowledge-bases/kbm/qa-pairs?id={cid}", method="DELETE")
        assert json.loads(r.body)["deleted"] == 1
        r = self.fetch("/api/knowledge-bases/kbm/qa-pairs?source_id=faq", method="DELETE")
        assert json.loads(r.body)["deleted"] == 1
        r = self.fetch("/api/knowledge-bases/kbm/qa-pairs")
        assert json.loads(r.body)["matched"] == 0

    def test_qa_pairs_validation(self):
        r = self.fetch(
            "/api/knowledge-bases/kbv/qa-pairs", method="POST",
            body=json.dumps({"pairs": [{"answer": "no question"}]}),
        )
        assert r.code == 400
        r = self.fetch("/api/knowledge-bases/kbv/qa-pairs", method="DELETE")
        assert r.code == 404  # kb never created


class ChunkBrowseSearchTest(AsyncHTTPTestCase):
    def get_app(self):
        return create_app(_state("chbrowse"))

    def test_offset_and_text_search(self):
        state = self._app.settings["api_state"]
        kb = state.get_or_create_kb("kbc")
        docs = [Document(id=f"d{i}", content=f"chunk number {i} about {'tpu' if i % 2 else 'gpu'}")
                for i in range(10)]
        self.io_loop.run_sync(lambda: kb.build_documents(docs))

        r = json.loads(self.fetch("/api/knowledge-bases/kbc/chunks?limit=4").body)
        assert r["total"] == 10 and len(r["chunks"]) == 4 and r["matched"] == 10
        r2 = json.loads(self.fetch("/api/knowledge-bases/kbc/chunks?limit=4&offset=8").body)
        assert len(r2["chunks"]) == 2  # tail page
        ids = {c["id"] for c in r["chunks"]} | {c["id"] for c in r2["chunks"]}
        assert len(ids) == 6  # no overlap between pages

        r3 = json.loads(self.fetch("/api/knowledge-bases/kbc/chunks?q=tpu").body)
        assert r3["matched"] == 5
        assert all("tpu" in c["content"] for c in r3["chunks"])


class MetadataExportImportTest(AsyncHTTPTestCase):
    def get_app(self):
        return create_app(_state("metaio"))

    def test_csv_roundtrip_and_json_import(self):
        state = self._app.settings["api_state"]
        kb = state.get_or_create_kb("kbx")
        docs = [Document(id=f"d{i}", content=f"doc {i}", metadata={"lang": "en"}) for i in range(3)]
        self.io_loop.run_sync(lambda: kb.build_documents(docs))

        # export
        r = self.fetch("/api/knowledge-bases/kbx/metadata")
        assert r.code == 200 and r.headers["Content-Type"].startswith("text/csv")
        lines = r.body.decode().strip().splitlines()
        assert lines[0].startswith("chunk_id,document_id")
        assert len(lines) == 4  # header + 3 chunks

        # edit one row's metadata and re-import the CSV
        import csv as _csv
        import io as _io
        rows = list(_csv.DictReader(_io.StringIO(r.body.decode())))
        target = rows[0]["chunk_id"]
        rows[0]["metadata"] = json.dumps({"lang": "fr", "reviewed": True})
        buf = _io.StringIO()
        w = _csv.DictWriter(buf, fieldnames=rows[0].keys())
        w.writeheader(); w.writerows(rows)
        r2 = self.fetch(
            "/api/knowledge-bases/kbx/metadata", method="POST", body=buf.getvalue(),
            headers={"Content-Type": "text/csv"},
        )
        data = json.loads(r2.body)
        assert data["updated"] == 3 and data["submitted"] == 3

        # the edit is queryable through the filter path
        q = json.dumps({"query": "doc", "top_k": 5, "filters": {"lang": "fr"}})
        hits = json.loads(self.fetch("/api/knowledge-bases/kbx/query", method="POST", body=q).body)
        assert hits["total_results"] == 1 and hits["results"][0]["chunk_id"] == target

        # JSON import path
        r3 = self.fetch(
            "/api/knowledge-bases/kbx/metadata", method="POST",
            body=json.dumps({"updates": [{"id": target, "metadata": {"lang": "de"}}]}),
        )
        assert json.loads(r3.body)["updated"] == 1

    def test_import_validation(self):
        state = self._app.settings["api_state"]
        state.get_or_create_kb("kbv2")
        r = self.fetch(
            "/api/knowledge-bases/kbv2/metadata", method="POST",
            body="wrong,header\n1,2", headers={"Content-Type": "text/csv"},
        )
        assert r.code == 400 and b"chunk_id" in r.body
        r = self.fetch(
            "/api/knowledge-bases/kbv2/metadata", method="POST",
            body=json.dumps({"updates": [{"id": "x", "metadata": "not-a-dict"}]}),
        )
        assert r.code == 400
        r = self.fetch("/api/knowledge-bases/nope/metadata")
        assert r.code == 404


class IndexMgmtTest(AsyncHTTPTestCase):
    def get_app(self):
        return create_app(_state("idxmgmt"))

    def test_build_drop_ivf_and_compact(self):
        state = self._app.settings["api_state"]
        kb = state.get_or_create_kb("kbi")
        docs = [Document(id=f"d{i}", content=f"topic {i % 7} body {i}") for i in range(200)]
        self.io_loop.run_sync(lambda: kb.build_documents(docs))

        r = json.loads(self.fetch("/api/knowledge-bases/kbi/index").body)
        assert r["rows"] == 200 and r["ivf"] is None

        r = json.loads(self.fetch(
            "/api/knowledge-bases/kbi/index", method="POST",
            body=json.dumps({"action": "build_ivf", "n_lists": 4})).body)
        assert r["n_lists"] == 4
        r = json.loads(self.fetch("/api/knowledge-bases/kbi/index").body)
        assert r["ivf"]["n_lists"] == 4

        # searches still work through the IVF path
        q = json.loads(self.fetch(
            "/api/knowledge-bases/kbi/query", method="POST",
            body=json.dumps({"query": "topic 3", "top_k": 3})).body)
        assert q["total_results"] == 3

        # delete some rows -> compact reclaims them
        self.io_loop.run_sync(lambda: kb.store.delete_by_document_id("d0"))
        r = json.loads(self.fetch(
            "/api/knowledge-bases/kbi/index", method="POST",
            body=json.dumps({"action": "compact"})).body)
        assert r["rows_after"] == 199

        r = json.loads(self.fetch(
            "/api/knowledge-bases/kbi/index", method="POST",
            body=json.dumps({"action": "drop_ivf"})).body)
        assert r["action"] == "drop_ivf"
        assert json.loads(self.fetch("/api/knowledge-bases/kbi/index").body)["ivf"] is None

    def test_index_mgmt_validation(self):
        state = self._app.settings["api_state"]
        state.get_or_create_kb("kbe")
        r = self.fetch("/api/knowledge-bases/kbe/index", method="POST",
                       body=json.dumps({"action": "build_ivf"}))
        assert r.code == 400  # empty KB
        r = self.fetch("/api/knowledge-bases/nope/index")
        assert r.code == 404


UNKNOWN_KB_ROUTES = [
    ("GET", "/api/knowledge-bases/ghost", None),
    ("DELETE", "/api/knowledge-bases/ghost", None),
    ("POST", "/api/knowledge-bases/ghost/snapshot", {"action": "save"}),
    ("POST", "/api/knowledge-bases/ghost/query", {"query": "q"}),
    ("POST", "/api/knowledge-bases/ghost/qa", {"question": "q"}),
    ("GET", "/api/knowledge-bases/ghost/tables", None),
    ("GET", "/api/knowledge-bases/ghost/config", None),
    ("GET", "/api/knowledge-bases/ghost/qa-pairs", None),
    ("POST", "/api/knowledge-bases/ghost/qa/execute", {"id": "x"}),
    ("POST", "/api/knowledge-bases/ghost/qa/batch-execute", {"ids": ["x"]}),
    ("GET", "/api/knowledge-bases/ghost/metadata", None),
    ("GET", "/api/knowledge-bases/ghost/index", None),
    ("POST", "/api/knowledge-bases/ghost/index", {"action": "compact"}),
    ("GET", "/api/knowledge-bases/ghost/chunks", None),
    ("POST", "/api/chat", {"query": "q", "kb_id": "ghost", "stream": False}),
]


@pytest.mark.parametrize("method,path,body", UNKNOWN_KB_ROUTES,
                         ids=[f"{m} {p}" for m, p, _ in UNKNOWN_KB_ROUTES])
def test_unknown_kb_is_404_and_creates_nothing(method, path, body):
    """Every route that reads a KB answers 404 for a name it never made,
    and mints no KB for it."""
    import asyncio

    from torch_api_helpers import Served

    state = _state("ghost")

    async def go():
        app = Served(create_app(state))
        try:
            return await app.fetch(path, method, body)
        finally:
            await app.close()

    r = asyncio.run(go())
    assert r.code == 404, (r.code, r.body)
    assert "ghost" in json.loads(r.body)["error"]
    assert state.kbs.names() == []
