"""The cases of ``tests/api/test_staged_build.py`` on the port (its ``ApiState`` on the CPU).

API build route drives the STAGED knowledge builder (ingest agent):
extension routing to table/database processors, table registry shared with
text2sql, incremental skip on rebuild, and qa_pairs in the build body
(ref: the reference's KB build route drives its knowledge-builder pipeline,
utu/rag/api/routes/knowledge_base.py)."""

import json
import sqlite3
import tempfile
from pathlib import Path

import pytest
from tornado.testing import AsyncHTTPTestCase

from youtu_rag_tpu_torch.agents.config import AgentConfig
from youtu_rag_tpu_torch.agents.llm import FakeChatClient
from youtu_rag_tpu_torch.agents.simple_agent import SimpleAgent
from youtu_rag_tpu_torch.api.app import create_app
from youtu_rag_tpu_torch.api.state import ApiState
from youtu_rag_tpu_torch.core.config import IndexConfig, RAGConfig, VectorStoreConfig
from torch_api_helpers import port_registry  # noqa: F401 - a fixture

# the KBs a test registers leave the port's process-wide registry with it
pytestmark = pytest.mark.usefixtures("port_registry")


def _task(source_id: str, path: str):
    from youtu_rag_tpu_torch.ingest.processors import SourceTask

    return SourceTask(source_id, "text", path=path)


class StagedBuildTest(AsyncHTTPTestCase):
    def get_app(self):
        rag = RAGConfig(
            vector_store=VectorStoreConfig(index=IndexConfig(min_capacity=256, block_rows=128))
        )
        self.state = ApiState(device="cpu", 
            data_dir=tempfile.mkdtemp(prefix="yrt-staged-"), rag_config=rag
        )
        self.state.agent = SimpleAgent(
            AgentConfig(),
            client=FakeChatClient(rule_fn=lambda m, t: FakeChatClient.text_response("a")),
        )
        return create_app(self.state)

    def _json(self, resp):
        return json.loads(resp.body)

    def _multipart(self, filename, content: bytes):
        boundary = "xyzboundary"
        body = (
            f"--{boundary}\r\n"
            f'Content-Disposition: form-data; name="file"; filename="{filename}"\r\n'
            f"Content-Type: application/octet-stream\r\n\r\n"
        ).encode() + content + f"\r\n--{boundary}--\r\n".encode()
        headers = {"Content-Type": f"multipart/form-data; boundary={boundary}"}
        return body, headers

    def _upload(self, filename, content: bytes):
        body, headers = self._multipart(filename, content)
        r = self.fetch("/api/files/upload", method="POST", body=body, headers=headers)
        assert r.code == 201, r.body
        return self._json(r)

    # -- extension routing + table registry --------------------------------

    def test_csv_build_registers_tables_for_text2sql(self):
        self._upload(
            "sales.csv",
            b"region,revenue\nnorth,100\nsouth,80\neast,60\nwest,90\ncentral,70\n",
        )
        r = self.fetch(
            "/api/knowledge-bases/kbt/build",
            method="POST",
            body=json.dumps({"files": ["sales.csv"]}),
        )
        data = self._json(r)
        assert data["status"]["status"] == "completed", data
        assert data["report"]["tables"], data["report"]
        # the KB's own TableStore (the one text2sql reads) has the table
        kb = self.state.get_or_create_kb("kbt")
        tables = kb.tables.tables_for_kb("kbt")
        assert tables and "revenue" in tables[0]["columns"]

    def test_sqlite_db_build_routes_database_processor(self):
        with tempfile.NamedTemporaryFile(suffix=".db", delete=False) as f:
            db_path = f.name
        conn = sqlite3.connect(db_path)
        conn.execute("CREATE TABLE users (id INTEGER, name TEXT)")
        conn.execute("INSERT INTO users VALUES (1, 'ada'), (2, 'alan')")
        conn.commit()
        conn.close()
        self._upload("app.db", Path(db_path).read_bytes())
        r = self.fetch(
            "/api/knowledge-bases/kbd/build",
            method="POST",
            body=json.dumps({"files": ["app.db"]}),
        )
        data = self._json(r)
        assert data["status"]["status"] == "completed", data
        assert any("users" in t for t in data["report"]["tables"])
        kb = self.state.get_or_create_kb("kbd")
        assert any("users" in t["table_name"] for t in kb.tables.tables_for_kb("kbd"))

    # -- incremental manifest ----------------------------------------------

    def test_rebuild_skips_unchanged_sources(self):
        self._upload("doc.md", b"# doc\nsome stable content here")
        body = json.dumps({"files": ["doc.md"]})
        r1 = self._json(
            self.fetch("/api/knowledge-bases/kbi/build", method="POST", body=body)
        )
        assert r1["report"]["processed"] == 1 and r1["report"]["skipped"] == 0
        r2 = self._json(
            self.fetch("/api/knowledge-bases/kbi/build", method="POST", body=body)
        )
        assert r2["report"]["skipped"] == 1 and r2["report"]["processed"] == 0
        # rebuild=true forces reprocessing
        r3 = self._json(
            self.fetch(
                "/api/knowledge-bases/kbi/build",
                method="POST",
                body=json.dumps({"files": ["doc.md"], "rebuild": True}),
            )
        )
        assert r3["report"]["processed"] == 1
        # manifest persisted under the data dir
        assert (Path(self.state.data_dir) / "kbs" / "kbi" / "manifest.json").exists()

    # -- qa pairs through the build body ------------------------------------

    def test_qa_pairs_in_build_body(self):
        r = self._json(
            self.fetch(
                "/api/knowledge-bases/kbq/build",
                method="POST",
                body=json.dumps(
                    {
                        "documents": [{"id": "d1", "content": "context doc"}],
                        "qa_pairs": [{"question": "what is x?", "answer": "42"}],
                    }
                ),
            )
        )
        assert r["status"]["status"] == "completed"
        # qa association is queryable through the qa route
        qa = self._json(
            self.fetch(
                "/api/knowledge-bases/kbq/qa",
                method="POST",
                body=json.dumps({"question": "what is x?"}),
            )
        )
        assert qa["matched"] and qa["matched"]["answer"] == "42", qa

    # -- tables route --------------------------------------------------------

    def test_tables_list_preview_sql_drop(self):
        self._upload(
            "inv.csv",
            b"item,qty\npen,10\nbook,4\nmug,7\ndesk,2\nlamp,5\n",
        )
        self.fetch(
            "/api/knowledge-bases/kbs2/build",
            method="POST",
            body=json.dumps({"files": ["inv.csv"]}),
        )
        tables = self._json(self.fetch("/api/knowledge-bases/kbs2/tables"))["tables"]
        assert tables and tables[0]["n_rows"] == 5
        tname = tables[0]["table_name"]
        # preview
        r = self._json(
            self.fetch(f"/api/knowledge-bases/kbs2/tables?table={tname}&limit=3")
        )
        assert r["columns"] == ["item", "qty"] and r["row_count"] == 3
        # read-only SQL console
        r = self._json(
            self.fetch(
                "/api/knowledge-bases/kbs2/tables",
                method="POST",
                body=json.dumps({"sql": f'SELECT SUM(qty) FROM "{tname}"'}),
            )
        )
        assert r["rows"][0][0] == 28
        # writes rejected
        bad = self.fetch(
            "/api/knowledge-bases/kbs2/tables",
            method="POST",
            body=json.dumps({"sql": f'DELETE FROM "{tname}"'}),
        )
        assert bad.code == 400
        # drop
        assert (
            self.fetch(
                f"/api/knowledge-bases/kbs2/tables?table={tname}", method="DELETE"
            ).code
            == 200
        )
        assert not self._json(self.fetch("/api/knowledge-bases/kbs2/tables"))["tables"]
        # unknown table 404s
        assert self.fetch("/api/knowledge-bases/kbs2/tables?table=nope").code == 404

    # -- source configuration + cleanup --------------------------------------

    def test_config_put_cleans_removed_sources(self):
        self._upload("a.md", b"alpha document content")
        self._upload(
            "b.csv", b"k,v\n1,a\n2,b\n3,c\n4,d\n5,e\n"
        )
        self.fetch(
            "/api/knowledge-bases/kbc2/build",
            method="POST",
            body=json.dumps({"files": ["a.md", "b.csv"]}),
        )
        assert self._json(self.fetch("/api/knowledge-bases/kbc2/tables"))["tables"]
        # declare a config WITHOUT b.csv → its vectors + table are cleaned
        r = self._json(
            self.fetch(
                "/api/knowledge-bases/kbc2/config",
                method="PUT",
                body=json.dumps({"sources": {"files": ["a.md"]}}),
            )
        )
        cleaned_ids = [c["source"] for c in r["cleaned"]]
        assert "b.csv" in cleaned_ids and "a.md" not in cleaned_ids
        assert not self._json(self.fetch("/api/knowledge-bases/kbc2/tables"))["tables"]
        # config persisted and readable
        g = self._json(self.fetch("/api/knowledge-bases/kbc2/config"))
        assert g["sources"]["files"] == ["a.md"]
        # removed source reprocesses if re-added (manifest forgot it)
        r2 = self._json(
            self.fetch(
                "/api/knowledge-bases/kbc2/build",
                method="POST",
                body=json.dumps({"files": ["b.csv"]}),
            )
        )
        assert r2["report"]["processed"] == 1

    def test_build_from_config(self):
        self._upload("c1.md", b"config driven content")
        self.fetch(
            "/api/knowledge-bases/kbc3/config",
            method="PUT",
            body=json.dumps(
                {
                    "sources": {
                        "files": ["c1.md"],
                        "qa_pairs": [{"question": "q1", "answer": "a1"}],
                    }
                }
            ),
        )
        r = self._json(
            self.fetch(
                "/api/knowledge-bases/kbc3/build",
                method="POST",
                body=json.dumps({"from_config": True}),
            )
        )
        assert r["status"]["status"] == "completed"
        assert r["status"]["total_documents"] == 2  # file + qa task

    def test_db_connection_test(self):
        with tempfile.NamedTemporaryFile(suffix=".db", delete=False) as f:
            db_path = f.name
        conn = sqlite3.connect(db_path)
        conn.execute("CREATE TABLE t1 (a INTEGER)")
        conn.commit()
        conn.close()
        self._upload("probe.db", Path(db_path).read_bytes())
        r = self._json(
            self.fetch("/api/db/test", method="POST", body=json.dumps({"file": "probe.db"}))
        )
        assert r["ok"] and r["tables"][0]["table"] == "t1"
        assert "CREATE TABLE" in r["tables"][0]["ddl"]
        # gated mysql degrades with a clear error, not a crash
        bad = self.fetch(
            "/api/db/test",
            method="POST",
            body=json.dumps({"url": "mysql://u:p@nowhere:3306/db"}),
        )
        assert bad.code == 400 and "error" in self._json(bad)

    # -- restart durability --------------------------------------------------

    def test_kb_registry_survives_restart(self):
        self._upload(
            "facts.csv",
            b"topic,value\nhbm,820\nici,1600\nmxu,8\nvmem,128\ncores,2\n",
        )
        r = self._json(
            self.fetch(
                "/api/knowledge-bases/kbr/build",
                method="POST",
                body=json.dumps({"files": ["facts.csv"]}),
            )
        )
        assert r["status"]["status"] == "completed"
        # snapshot to the default location so the index also survives
        r = self.fetch(
            "/api/knowledge-bases/kbr/snapshot",
            method="POST",
            body=json.dumps({"action": "save"}),
        )
        assert r.code == 200, r.body

        # simulated restart: a fresh ApiState over the same data dir
        from youtu_rag_tpu_torch.retrieval.kb import GLOBAL_KB_REGISTRY

        GLOBAL_KB_REGISTRY.remove("kbr")
        state2 = ApiState(device="cpu", data_dir=self.state.data_dir, rag_config=self.state.rag_config)
        assert "kbr" in state2.kbs.names()
        kb2 = state2.kbs.get("kbr")
        # table registry rehydrated
        assert kb2.tables.tables_for_kb("kbr")
        # index auto-restored from the default snapshot
        import asyncio

        assert asyncio.get_event_loop().run_until_complete(kb2.store.count()) > 0
        # BM25 postings rebuilt from the restored chunks (kb.load →
        # rebuild_lexical): hybrid/lexical retrieval works after restart
        assert kb2.store._lexical is not None and len(kb2.store._lexical) > 0
        # manifest rehydrated: rebuilding skips the unchanged source
        report = asyncio.get_event_loop().run_until_complete(
            kb2.build_sources(
                [_task("facts.csv", str(Path(self.state.data_dir) / "files" / "uploads" / "facts.csv"))]
            )
        )
        assert report.skipped == 1

        # deleting the KB removes persisted state → no resurrection
        assert self.fetch("/api/knowledge-bases/kbr", method="DELETE").code == 200
        state3 = ApiState(device="cpu", data_dir=self.state.data_dir, rag_config=self.state.rag_config)
        assert "kbr" not in state3.kbs.names()

    # -- review-fix regressions ----------------------------------------------

    def test_kb_name_traversal_rejected(self):
        """KB names become data-dir path components; traversal must 400
        before any directory is created or deleted."""
        for bad in ("../files", "..", "a/b", ".hidden", "x" * 80):
            r = self.fetch(
                "/api/knowledge-bases", method="POST", body=json.dumps({"name": bad})
            )
            assert r.code == 400, (bad, r.code)
        # delete of a traversal name never reaches the filesystem
        marker = Path(self.state.data_dir) / "files" / "uploads"
        marker.mkdir(parents=True, exist_ok=True)
        (marker / "keep.txt").write_text("x")
        self.fetch("/api/knowledge-bases/..%2Ffiles%2Fuploads", method="DELETE")
        assert (marker / "keep.txt").exists()

    def test_drop_unregistered_table_is_noop(self):
        """DELETE ?table=kb_tables must not DROP the registry itself."""
        self._upload("reg.csv", b"c,v\n1,a\n2,b\n3,c\n4,d\n5,e\n")
        self.fetch(
            "/api/knowledge-bases/kbreg/build",
            method="POST",
            body=json.dumps({"files": ["reg.csv"]}),
        )
        r = self.fetch(
            "/api/knowledge-bases/kbreg/tables?table=kb_tables", method="DELETE"
        )
        assert r.code == 404
        # registry still intact and queryable
        assert self._json(self.fetch("/api/knowledge-bases/kbreg/tables"))["tables"]
        # malformed limit is a 400, not a 500
        t = self._json(self.fetch("/api/knowledge-bases/kbreg/tables"))["tables"][0]
        bad = self.fetch(
            f"/api/knowledge-bases/kbreg/tables?table={t['table_name']}&limit=abc"
        )
        assert bad.code == 400

    def test_config_save_preserves_route_minted_qa_pairs(self):
        """QA pairs added via the qa-pairs route are not config-managed and
        must survive a source-config save."""
        self.fetch(
            "/api/knowledge-bases/kbqp/qa-pairs",
            method="POST",
            body=json.dumps({"pairs": [{"question": "minted?", "answer": "kept"}]}),
        )
        r = self._json(
            self.fetch(
                "/api/knowledge-bases/kbqp/config",
                method="PUT",
                body=json.dumps({"sources": {"files": []}}),
            )
        )
        assert not any(c["source"].startswith("qa-") for c in r["cleaned"])
        qa = self._json(
            self.fetch(
                "/api/knowledge-bases/kbqp/qa",
                method="POST",
                body=json.dumps({"question": "minted?"}),
            )
        )
        assert qa["matched"] and qa["matched"]["answer"] == "kept"

    # -- qa file sources ------------------------------------------------------

    def test_qa_file_validate_and_build(self):
        self._upload(
            "faq.csv",
            "question,answer,howtofind\nwhat is hbm?,high bandwidth memory,glossary\n"
            "what is ici?,inter chip interconnect,glossary\n".encode(),
        )
        r = self._json(
            self.fetch(
                "/api/qa-files/validate", method="POST", body=json.dumps({"file": "faq.csv"})
            )
        )
        assert r["valid"] and r["row_count"] == 2
        assert r["sample_data"][0]["question"] == "what is hbm?"
        # zh header aliases accepted
        self._upload("faq_zh.csv", "问题,答案,查找方式\nq1,a1,h1\n".encode())
        r = self._json(
            self.fetch(
                "/api/qa-files/validate", method="POST",
                body=json.dumps({"file": "faq_zh.csv"}),
            )
        )
        assert r["valid"] and r["columns"] == ["question", "answer", "howtofind"]
        # missing columns rejected with precise errors
        self._upload("notqa.csv", b"a,b\n1,2\n")
        r = self._json(
            self.fetch(
                "/api/qa-files/validate", method="POST", body=json.dumps({"file": "notqa.csv"})
            )
        )
        assert not r["valid"] and "Missing required columns" in r["errors"][0]

        # build with the qa file → pairs answerable through the qa route
        b = self._json(
            self.fetch(
                "/api/knowledge-bases/kbqf/build",
                method="POST",
                body=json.dumps({"qa_files": ["faq.csv"]}),
            )
        )
        assert b["status"]["status"] == "completed"
        qa = self._json(
            self.fetch(
                "/api/knowledge-bases/kbqf/qa",
                method="POST",
                body=json.dumps({"question": "what is hbm?"}),
            )
        )
        assert qa["matched"]["answer"] == "high bandwidth memory"
        # invalid qa file becomes a build error, not a crash
        b2 = self._json(
            self.fetch(
                "/api/knowledge-bases/kbqf/build",
                method="POST",
                body=json.dumps({"qa_files": ["notqa.csv"]}),
            )
        )
        assert any("notqa.csv" in e for e in b2["status"]["errors"])

    # -- file references + packaged downloads --------------------------------

    def test_file_zip_and_unreferenced_delete(self):
        import io
        import zipfile

        self._upload("plain.md", b"# standalone document, never built")
        # fake OCR derivatives following the pipeline naming
        self._upload("page_1_plain_ocr.md", b"ocr page one")
        self._upload("plain_ocr.md", b"combined ocr")

        r = self._json(self.fetch("/api/files/plain.md/references"))
        assert not r["is_referenced"]

        z = self.fetch("/api/files/plain.md/download-with-ocr")
        assert z.code == 200
        names = set(zipfile.ZipFile(io.BytesIO(z.body)).namelist())
        assert names == {"plain.md", "page_1_plain_ocr.md", "plain_ocr.md"}

        # unreferenced delete needs no force and removes derivatives
        d = self._json(self.fetch("/api/files/plain.md", method="DELETE"))
        assert set(d["derived_deleted"]) == {"page_1_plain_ocr.md", "plain_ocr.md"}
        assert self.fetch("/api/files/page_1_plain_ocr.md").code == 404

    # -- progress + error isolation -----------------------------------------

    def test_progress_log_and_missing_file_error(self):
        self._upload("ok.md", b"fine content")
        r = self._json(
            self.fetch(
                "/api/knowledge-bases/kbe/build",
                method="POST",
                body=json.dumps({"files": ["ok.md", "ghost.md"]}),
            )
        )
        assert r["status"]["status"] == "completed"  # one source still built
        assert any("ghost.md" in e for e in r["status"]["errors"])
        logs = self._json(self.fetch("/api/knowledge-bases/kbe/build-logs"))["logs"]
        prog = logs[-1]["detail"]["progress"]
        assert prog and prog[-1]["done"] == prog[-1]["total"]
