"""Tornado HTTP/SSE service — the reference's FastAPI surface rebuilt
(``utu/rag/api/main.py:108-147`` routers; the reference itself ships
tornado UIs, ``utu/ui/``).

A port of ``youtu_rag_tpu/api/app.py``: the same 40 routes, card protocol
and responses; everything a route builds (KBs, catalog agents, memory
toolkits) lives on ``ApiState.device``.

Route surface parity:
  GET  /health                          agent + memory status (main.py:189-206)
  POST /api/chat                        SSE card stream (chat_service.py:92-485)
  GET/POST/DELETE /api/knowledge-bases[/{name}]   KB CRUD
  POST /api/knowledge-bases/{name}/build          staged build + logs
  GET  /api/knowledge-bases/{name}/build-logs
  POST /api/knowledge-bases/{name}/query          direct retrieval
  POST /api/knowledge-bases/{name}/qa             QA-association answering
  GET/POST/DELETE .../qa-pairs                    QA pair management
  GET/POST .../metadata                           CSV metadata export/import
  GET/POST .../index                              IVF build/drop + compact
  POST .../snapshot                               save/restore to disk
  POST /api/files/upload[-with-progress]          multipart upload (+tracker)
  GET  /api/files / DELETE /api/files/{name}
  GET  /api/files/upload-progress/{task_id}
  POST /api/embedding/embed, POST /api/reranker/rerank
  GET  /api/monitor/health, /api/monitor/metrics
  GET/POST /api/memory/config            runtime toggle (routes/memory.py:16-58)
  GET/POST/DELETE /api/memory/items      memory browser (list/search/add/delete)
  GET  /api/agents, POST /api/agents/switch
"""

from __future__ import annotations

import asyncio
import functools
import json
import re
import time
import traceback
from typing import Any

import tornado.web
import tornado.websocket

from ..agents.config import AgentConfig
from ..core.types import Document
from ..utils.log import get_logger
from .state import ApiState

logger = get_logger("api.app")


class BaseHandler(tornado.web.RequestHandler):
    @property
    def state(self) -> ApiState:
        return self.application.settings["api_state"]

    def set_default_headers(self):
        # CORS parity with the reference's permissive dev setup
        self.set_header("Access-Control-Allow-Origin", "*")
        self.set_header("Access-Control-Allow-Headers", "*")
        self.set_header("Access-Control-Allow-Methods", "GET, POST, PUT, DELETE, OPTIONS")

    def options(self, *args, **kwargs):
        self.set_status(204)
        self.finish()

    def write_json(self, data: Any, status: int = 200) -> None:
        self.set_status(status)
        self.set_header("Content-Type", "application/json")
        self.finish(json.dumps(data, ensure_ascii=False, default=str))

    def json_body(self) -> dict:
        try:
            return json.loads(self.request.body or b"{}")
        except json.JSONDecodeError:
            raise tornado.web.HTTPError(400, reason="invalid JSON body")

    def get_or_create_kb(self, name: str, config=None):
        """Create-or-fetch with the name guard surfaced as a 400 (names
        become data-dir path components; see ApiState.validate_kb_name)."""
        try:
            return self.state.get_or_create_kb(name, config)
        except ValueError as e:
            raise tornado.web.HTTPError(400, reason=str(e))

    def int_arg(self, value, name: str) -> int:
        try:
            return int(value)
        except (TypeError, ValueError):
            raise tornado.web.HTTPError(400, reason=f"{name} must be an integer")

    def write_error(self, status_code: int, **kwargs):
        detail = self._reason
        if "exc_info" in kwargs:
            exc = kwargs["exc_info"][1]
            if not isinstance(exc, tornado.web.HTTPError):
                detail = str(exc)
                logger.error("handler error: %s", "".join(traceback.format_exception(*kwargs["exc_info"]))[-2000:])
        self.write_json({"error": detail, "status": status_code}, status=status_code)


class HealthHandler(BaseHandler):
    async def get(self):
        self.write_json(
            {
                "status": "healthy",
                "agent_initialized": self.state.agent is not None,
                "agent_type": self.state.agent_config.type,
                "memory_enabled": self.state.memory_enabled,
                "knowledge_bases": self.state.kbs.names(),
            }
        )


# ---------------------------------------------------------------------------
# chat (SSE card protocol, ref: chat_service.py:124-485)
# ---------------------------------------------------------------------------


_TABLE_EXTS = (".csv", ".xlsx", ".xls")
_TEXT_EXTS = (".txt", ".md", ".markdown", ".json", ".jsonl", ".py", ".html")


def _deep_merge(base: dict, override: dict) -> dict:
    """Recursive dict merge: nested overrides replace leaves, not whole
    sections (pydantic would refill a replaced section with defaults)."""
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_merge(base[k], v)
        else:
            base[k] = v
    return base


def _modify_query(state, query: str, kb_id, file_ids) -> tuple[str, str | None]:
    """Inject kb/file context into the query (ref: ChatService.modify_query,
    chat_service.py:486-623 — kb reference + file download for Excel
    agents). Returns (augmented_query, spreadsheet_path_for_excel_agent)."""
    parts = []
    table_path = None
    if kb_id:
        # unknown kb must 404 like every other handler — get_or_create
        # here would mint (and permanently register) a junk empty KB for
        # every mistyped kb_id
        if state.kbs.get(kb_id) is None:
            raise tornado.web.HTTPError(404, reason=f"knowledge base {kb_id!r} not found")
        parts.append(f"[knowledge base: {kb_id}]")
    for fid in file_ids or []:
        if not state.files.exists("uploads", fid):
            raise tornado.web.HTTPError(400, reason=f"attached file not found: {fid}")
        path = str(state.files.local_path("uploads", fid))
        if table_path is None and fid.lower().endswith(_TABLE_EXTS):
            table_path = path  # spreadsheet → DTR excel agent (FILE_PATH analog)
        parts.append(f"[attached file: {path}]")
        if fid.lower().endswith(_TEXT_EXTS):
            try:
                preview = state.files.download("uploads", fid).decode("utf-8", errors="replace")
                parts.append(f"[file {fid} content]\n{preview[:4000]}")
            except Exception:  # noqa: BLE001 - preview is best-effort
                pass
    parts.append(query)
    return "\n".join(parts), table_path


def _agent_chat_fn(agent):
    """A plain async text→text chat callable over whatever client the
    configured agent holds (used for advisory LLM selections)."""
    chat = getattr(agent, "_chat", None)
    if chat is not None:
        return chat
    client = getattr(agent, "client", None)
    if client is None:
        return None
    from ..agents.llm import ChatMessage

    async def chat_fn(prompt, _c=client):
        resp = await _c.chat([ChatMessage("user", prompt)])
        return resp.message.content or ""

    return chat_fn


class ChatHandler(BaseHandler):
    async def post(self):
        body = self.json_body()
        query = body.get("query") or body.get("message")
        if not query:
            raise tornado.web.HTTPError(400, reason="missing 'query'")
        kb_id = body.get("kb_id")
        stream = body.get("stream", True)

        if body.get("auto_select"):
            # auto-select mode: an LLM picks agents from the frontend
            # catalog and each runs in turn, streaming (ref:
            # routes/chat.py:120-220 auto_select_and_stream; streaming only)
            if not stream:
                raise tornado.web.HTTPError(
                    400, reason="auto_select only supports streaming mode"
                )
            await self._auto_select_stream(query, kb_id, body.get("file_ids"))
            return

        query_aug, table_path = _modify_query(self.state, query, kb_id, body.get("file_ids"))
        agent = await self.state.get_agent()
        excel_routed = table_path is not None and hasattr(agent, "load_schema")
        if not stream:
            rec = await (agent.run(query_aug, table_path) if excel_routed else agent.run(query_aug))
            self.write_json({"answer": rec.final_output, "trace_id": rec.trace_id})
            return

        self.set_header("Content-Type", "text/event-stream")
        self.set_header("Cache-Control", "no-cache")
        recorder = (
            agent.run_streamed(query_aug, table_path) if excel_routed else agent.run_streamed(query_aug)
        )
        streamed_error = False
        async for ev in recorder.stream_events():
            card = {"type": ev.type}
            if ev.text:
                card["content"] = ev.text
            if ev.name:
                card["name"] = ev.name
            if ev.arguments:
                card["arguments"] = ev.arguments
            if ev.data:
                card["data"] = ev.data
            streamed_error = streamed_error or ev.type == "error"
            self.write(f"data: {json.dumps(card, ensure_ascii=False)}\n\n")
            try:
                await self.flush()
            except tornado.iostream.StreamClosedError:
                # client gone: cancel the in-flight run instead of letting
                # it burn model/TPU work into a queue nobody drains
                run_task = getattr(recorder, "run_task", None)
                if run_task is not None and not run_task.done():
                    run_task.cancel()
                return
        try:
            await recorder.wait()
        except RuntimeError as e:
            # the failure usually already streamed as an error card; don't
            # repeat it — but never swallow one that didn't stream
            if not streamed_error:
                self.write(
                    f"data: {json.dumps({'type': 'error', 'content': str(e)}, ensure_ascii=False)}\n\n"
                )
        # always terminate the stream with a done card so clients reset
        done = {"type": "done", "trace_id": getattr(recorder, "trace_id", None)}
        self.write(f"data: {json.dumps(done, ensure_ascii=False)}\n\n")
        await self.flush()

    async def _write_card(self, card: dict) -> bool:
        """One SSE card; False when the client is gone."""
        self.write(f"data: {json.dumps(card, ensure_ascii=False)}\n\n")
        try:
            await self.flush()
        except tornado.iostream.StreamClosedError:
            return False
        return True

    async def _auto_select_stream(self, query: str, kb_id, file_ids) -> None:
        self.set_header("Content-Type", "text/event-stream")
        self.set_header("Cache-Control", "no-cache")
        query_aug, table_path = _modify_query(self.state, query, kb_id, file_ids)
        live = await self.state.get_agent()
        # attached spreadsheet + an excel-capable live agent: route straight
        # to it like the default mode does — the catalog agents cannot open
        # the file and would degrade
        if table_path is not None and hasattr(live, "load_schema"):
            if not await self._write_card(
                {"type": "agent_switch", "content": "excel", "name": "excel"}
            ):
                return
            recorder = live.run_streamed(query_aug, table_path)
            out = await self._forward_run(recorder)
            if out is None:
                return
            await self._write_card(
                {"type": "done", "auto_selected": ["excel"], "content": out}
            )
            return
        chat = _agent_chat_fn(live)
        if not await self._write_card(
            {"type": "reasoning_delta", "content": "selecting agents…"}
        ):
            return
        selected = (
            await select_agents_for_qa(query, "", chat) if chat is not None else ["kb_search"]
        )
        if not await self._write_card(
            {"type": "plan", "data": {"selected_agents": selected}}
        ):
            return

        from ..agents.factory import get_agent as build_agent

        final = ""
        for agent_name in selected:
            spec = next(a for a in agent_catalog() if a["name"] == agent_name)
            if not await self._write_card(
                {"type": "agent_switch", "content": agent_name, "name": agent_name}
            ):
                return
            try:
                if spec["type"] == self.state.agent_config.type:
                    runner = live
                else:
                    cfg = self.state.agent_config.model_copy(update={"type": spec["type"]})
                    runner = build_agent(cfg, device=self.state.device)
                    if hasattr(runner, "build"):
                        await runner.build()
                recorder = runner.run_streamed(query_aug)
                out = await self._forward_run(recorder)
                if out is None:
                    return  # client gone
                final = out or final
            except Exception as e:  # noqa: BLE001 - per-agent isolation
                logger.exception("auto-select agent %s failed", agent_name)
                if not await self._write_card({"type": "error", "content": str(e)}):
                    return
        await self._write_card(
            {"type": "done", "auto_selected": selected, "content": final}
        )

    async def _forward_run(self, recorder) -> str | None:
        """Forward a recorder's cards (minus 'done'); returns the run's
        final output, '' when the run errored (already streamed), or None
        when the client disconnected (the run is cancelled)."""
        async for ev in recorder.stream_events():
            if ev.type == "done":
                continue
            card = {"type": ev.type}
            if ev.text:
                card["content"] = ev.text
            if ev.name:
                card["name"] = ev.name
            if ev.arguments:
                card["arguments"] = ev.arguments
            if ev.data:
                card["data"] = ev.data
            if not await self._write_card(card):
                run_task = getattr(recorder, "run_task", None)
                if run_task is not None and not run_task.done():
                    run_task.cancel()
                return None
        try:
            rec = await recorder.wait()
            return rec.final_output or ""
        except RuntimeError:
            return ""  # the failure already streamed as an error card


# ---------------------------------------------------------------------------
# knowledge bases
# ---------------------------------------------------------------------------


class KBCollectionHandler(BaseHandler):
    async def get(self):
        out = []
        for name in self.state.kbs.names():
            kb = self.state.kbs.get(name)
            out.append(await kb.stats())
        self.write_json({"knowledge_bases": out})

    async def post(self):
        body = self.json_body()
        name = body.get("name")
        if not name:
            raise tornado.web.HTTPError(400, reason="missing 'name'")
        if self.state.kbs.get(name) is not None:
            raise tornado.web.HTTPError(409, reason=f"knowledge base {name!r} exists")
        cfg = None
        # top-level description is sugar for a config override (ref:
        # create-KB modal fields in rag_webui's knowledge-base.js)
        if body.get("description"):
            body.setdefault("config", {})
            body["config"].setdefault("description", str(body["description"]))
        if body.get("config"):
            # per-KB config overrides (ref analog: per-KB YAML configs,
            # kb_config_routes.py) — e.g. {"knowledge_builder": {"embedding":
            # {"coalesce_window_ms": 3}}} enables request coalescing
            from ..core.config import RAGConfig

            base = self.state.rag_config.model_dump()
            _deep_merge(base, body["config"])  # shallow update would reset
            # every sibling field of a partially-overridden section
            base["name"] = name
            try:
                cfg = RAGConfig.model_validate(base)
            except Exception as e:  # noqa: BLE001 - surface validation detail
                # tornado reasons must be single-line; pydantic errors aren't
                detail = " | ".join(str(e).splitlines())[:300]
                raise tornado.web.HTTPError(400, reason=f"invalid config: {detail}") from None
        kb = self.get_or_create_kb(name, cfg)
        self.write_json(await kb.stats(), status=201)


class KBItemHandler(BaseHandler):
    async def get(self, name: str):
        kb = self.state.kbs.get(name)
        if kb is None:
            raise tornado.web.HTTPError(404, reason=f"knowledge base {name!r} not found")
        self.write_json(await kb.stats())

    async def delete(self, name: str):
        kb = self.state.kbs.get(name)
        if kb is None:
            raise tornado.web.HTTPError(404, reason=f"knowledge base {name!r} not found")
        await kb.store.clear()
        self.state.remove_kb(name)
        self.write_json({"deleted": name})


class KBBuildHandler(BaseHandler):
    async def post(self, name: str):
        """Build from uploaded files and/or inline documents through the
        STAGED knowledge builder (analyze → skip-unchanged → parallel
        process → QA stage): file sources route by extension to the
        text/table/database processors, registering spreadsheet and DB
        tables for text2sql; inline documents take the text path; repeated
        builds skip unchanged sources via the per-KB manifest
        (ref: utu/rag/api/routes/knowledge_base.py build route driving the
        knowledge builder pipeline).

        body: {"files": ["name", ...], "documents": [{"id","content","metadata"}],
               "qa_pairs": [{"question","answer"}], "rebuild": bool}
        """
        from ..ingest.processors import SourceTask

        body = self.json_body()
        kb = self.get_or_create_kb(name)
        if body.get("from_config"):
            # build from the declared source configuration (ref: the
            # config-driven build in kb_config_routes.py:627-680)
            cfg_sources = self.state.get_kb_sources(name)
            body = {**body}
            body.setdefault("files", list(cfg_sources.get("files") or []))
            body.setdefault("documents", list(cfg_sources.get("documents") or []))
            body.setdefault("qa_pairs", list(cfg_sources.get("qa_pairs") or []))
            body.setdefault("qa_files", list(cfg_sources.get("qa_files") or []))
            body["files"] = body["files"] + [
                db["file"] for db in cfg_sources.get("databases") or [] if db.get("file")
            ]
        tasks: list[SourceTask] = []
        errors: list[str] = []
        for fname in body.get("files", []):
            if not self.state.files.exists("uploads", fname):
                errors.append(f"file not found: {fname}")
                continue
            path = self.state.files.local_path("uploads", fname)
            meta = (self.state.files.stat("uploads", fname) or {}).get("user_metadata", {})
            tasks.append(SourceTask(fname, "text", path=str(path), metadata=dict(meta)))
        for d in body.get("documents", []):
            tasks.append(
                SourceTask(
                    d["id"], "text",
                    document=Document(d["id"], d["content"], d.get("metadata")),
                    metadata=d.get("metadata") or {},
                )
            )
        if body.get("qa_pairs"):
            tasks.append(SourceTask(f"qa-{name}", "qa", qa_pairs=body["qa_pairs"]))
        for qf in body.get("qa_files", []):
            # QA spreadsheet/CSV sources (ref: selectedQAFiles in the KB
            # configuration; parsed with the validate_qa_file conventions)
            if not self.state.files.exists("uploads", qf):
                errors.append(f"qa file not found: {qf}")
                continue
            from ..ingest.qa_file import parse_qa_file

            try:
                pairs = parse_qa_file(str(self.state.files.local_path("uploads", qf)))
            except ValueError as e:
                errors.append(f"{qf}: {e}")
                continue
            tasks.append(
                SourceTask(qf, "qa", qa_pairs=pairs, metadata={"related_file": qf})
            )

        if not tasks and not errors:
            raise tornado.web.HTTPError(400, reason="nothing to build")

        log = self.state.add_build_log(name, "running")
        progress = log["detail"].setdefault("progress", [])

        def on_progress(source: str, status: str, done: int, total: int) -> None:
            progress.append({"source": source, "status": status, "done": done, "total": total})

        report = await kb.build_sources(
            tasks, rebuild=bool(body.get("rebuild")), on_progress=on_progress
        )
        all_errors = report.errors + errors
        log["status"] = "failed" if (report.processed == 0 and all_errors) else "completed"
        log["detail"].update(
            {
                "processed_documents": report.processed,
                "skipped_documents": report.skipped,
                "total_chunks": report.total_chunks,
                "tables": report.tables,
                "errors": all_errors,
            }
        )
        # response keeps the BuildStatus shape older clients consume, with
        # the staged-builder report alongside
        status = {
            "status": log["status"],
            "total_documents": report.total_sources,
            "processed_documents": report.processed,
            "total_chunks": report.total_chunks,
            "errors": all_errors,
        }
        self.write_json({"build": log, "status": status, "report": report.summary()})


class KBSnapshotHandler(BaseHandler):
    """Persist/restore a KB (ref analog: Chroma persist dir / FAISS .index
    sidecar saves, here explicit snapshots)."""

    async def post(self, name: str):
        kb = self.state.kbs.get(name)
        if kb is None:
            raise tornado.web.HTTPError(404, reason=f"knowledge base {name!r} not found")
        body = self.json_body()
        directory = body.get("directory") or str(self.state.data_dir / "snapshots" / name)
        action = body.get("action", "save")
        try:
            if action == "save":
                result = kb.save(directory)
            elif action == "restore":
                result = kb.load(directory)
            else:
                raise tornado.web.HTTPError(400, reason="action must be save|restore")
        except (RuntimeError, FileNotFoundError) as e:
            raise tornado.web.HTTPError(400, reason=str(e))
        self.write_json({"action": action, **result})


class KBBuildLogsHandler(BaseHandler):
    async def get(self, name: str):
        self.write_json({"logs": [l for l in self.state.build_logs if l["kb"] == name]})


class KBQAHandler(BaseHandler):
    """QA-association answering: match the question against the qa index
    (element_type=qa) and return the stored answer when confident
    (ref: QA execute routes, utu/rag/api/routes/knowledge_base.py:759-893)."""

    async def post(self, name: str):
        kb = self.state.kbs.get(name)
        if kb is None:
            raise tornado.web.HTTPError(404, reason=f"knowledge base {name!r} not found")
        body = self.json_body()
        question = body.get("question")
        if not question:
            raise tornado.web.HTTPError(400, reason="missing 'question'")
        threshold = float(body.get("threshold", 0.6))
        results = await kb.retriever.retrieve(
            question,
            top_k=int(body.get("top_k", 3)),
            filters={"element_type": "qa"},
            enable_reranking=False,
            similarity_threshold=0.0,
        )
        matches = [
            {
                "question": r.chunk.content.split("\n")[0].removeprefix("Q: "),
                "answer": (r.chunk.metadata or {}).get("answer", ""),
                "related_file": (r.chunk.metadata or {}).get("related_file", ""),
                "score": r.score,
            }
            for r in results
        ]
        best = matches[0] if matches and matches[0]["score"] >= threshold else None
        self.write_json({"question": question, "matched": best, "candidates": matches})


class KBChunksHandler(BaseHandler):
    """Browse indexed chunks (ref analog: the reference's vector-store
    inspection utilities, tests/rag/inspect_vector_store.py, and the web
    UI's chunk viewers)."""

    async def get(self, name: str):
        kb = self.state.kbs.get(name)
        if kb is None:
            raise tornado.web.HTTPError(404, reason=f"knowledge base {name!r} not found")
        limit = int(self.get_query_argument("limit", "50"))
        offset = int(self.get_query_argument("offset", "0"))
        text_q = self.get_query_argument("q", "").lower()
        index_type = self.get_query_argument("index_type", None)
        document_id = self.get_query_argument("document_id", None)
        filters: dict = {}
        if index_type:
            filters["index_type"] = index_type
        if document_id:
            filters["source"] = document_id
        # filter + text + offset push down into one streaming store pass:
        # the page view materializes O(limit) chunks, not every match
        chunks, matched = await kb.store.scan_page(
            filters or None, limit=limit, offset=offset, text=text_q or None
        )
        self.write_json(
            {
                "kb": name,
                "total": await kb.store.count(),
                "matched": matched,
                "offset": offset,
                "chunks": [
                    {
                        "id": c.id,
                        "document_id": c.document_id,
                        "chunk_index": c.chunk_index,
                        "content": c.content[:300],
                        "metadata": c.metadata,
                    }
                    for c in chunks
                ],
            }
        )


class KBConfigHandler(BaseHandler):
    """Declared source configuration of a KB with removed-source cleanup
    on update (ref: the reference's KB configuration PUT — sources diff +
    ``KBConfigService.cleanup_removed_sources``, kb_config_routes.py PUT +
    services/kb_config_service.py:75).

    sources shape: {"files": [name...], "documents": [{"id","content"}...],
                    "databases": [{"url"} or {"file"}...],
                    "qa_pairs": [{"question","answer"}...]}
    """

    @staticmethod
    def _source_ids(sources: dict) -> list[str]:
        ids = list(sources.get("files") or [])
        ids += [d["id"] for d in sources.get("documents") or [] if d.get("id")]
        ids += [db.get("file") or db.get("url", "") for db in sources.get("databases") or []]
        ids += list(sources.get("qa_files") or [])
        return [i for i in ids if i]

    async def get(self, name: str):
        if self.state.kbs.get(name) is None:
            raise tornado.web.HTTPError(404, reason=f"knowledge base {name!r} not found")
        self.write_json({"kb": name, "sources": self.state.get_kb_sources(name)})

    async def put(self, name: str):
        from ..ingest.cleanup import KnowledgeCleanupManager

        body = self.json_body()
        sources = body.get("sources")
        if not isinstance(sources, dict):
            raise tornado.web.HTTPError(400, reason="missing 'sources' object")
        kb = self.get_or_create_kb(name)
        ids = self._source_ids(sources)
        # inline qa_pairs build under the per-build id qa-<kb>
        if sources.get("qa_pairs"):
            ids.append(f"qa-{name}")
        mgr = KnowledgeCleanupManager(name, kb.store, kb.tables, kb.manifest)
        # QA pairs added through the qa-pairs route mint qa-<uuid> source
        # ids the configuration never lists — they are not config-managed
        # and must survive config saves (only qa-<kb>, the inline-config
        # id, is subject to the diff)
        cleaned = await mgr.cleanup_removed_sources(
            ids, keep=lambda sid: sid.startswith("qa-") and sid != f"qa-{name}"
        )
        self.state.set_kb_sources(name, sources)
        self.write_json({"kb": name, "sources": sources, "cleaned": cleaned})


class QAFileValidateHandler(BaseHandler):
    """POST /api/qa-files/validate {"file": name} — column/sheet checks +
    row count + sample before attaching a QA file to a KB
    (ref: kb_config_routes.py:874 + kb_config_service.validate_qa_file)."""

    async def post(self):
        from ..ingest.qa_file import validate_qa_file

        fname = self.json_body().get("file")
        if not fname:
            raise tornado.web.HTTPError(400, reason="missing 'file'")
        if not self.state.files.exists("uploads", fname):
            self.write_json(
                {"valid": False, "filename": fname, "errors": ["file not found"]},
                status=404,
            )
            return
        report = validate_qa_file(
            str(self.state.files.local_path("uploads", fname)), fname
        )
        self.write_json(report)


class DBTestHandler(BaseHandler):
    """Test a database connection and introspect its tables before wiring
    it into a KB (ref: the DB connection test in kb_config_routes.py:873-1016).
    body: {"url": "sqlite:///path | mysql://…"} or {"file": "<uploaded name>"}."""

    async def post(self):
        from ..db.adapters import adapter_from_url

        body = self.json_body()
        url = body.get("url")
        if not url and body.get("file"):
            fname = body["file"]
            if not self.state.files.exists("uploads", fname):
                raise tornado.web.HTTPError(400, reason=f"uploaded file not found: {fname}")
            url = f"sqlite:///{self.state.files.local_path('uploads', fname)}"
        if not url:
            raise tornado.web.HTTPError(400, reason="need 'url' or 'file'")
        try:
            adapter = adapter_from_url(url)
            try:
                tables = adapter.list_tables()
                info = [
                    {"table": t, "ddl": adapter.table_ddl(t)[:500]} for t in tables[:50]
                ]
            finally:
                adapter.close()
        except Exception as e:  # noqa: BLE001 - connection errors → clear 400
            self.write_json({"ok": False, "error": str(e)}, status=400)
            return
        self.write_json({"ok": True, "dialect": adapter.dialect, "tables": info})


class KBTablesHandler(BaseHandler):
    """Structured-table registry of a KB: list, preview, read-only SQL,
    drop (ref: the webui kb-detail DB tables panel + the reference's
    table-management routes over its ExcelTableManager)."""

    def _kb(self, name: str):
        kb = self.state.kbs.get(name)
        if kb is None:
            raise tornado.web.HTTPError(404, reason=f"knowledge base {name!r} not found")
        return kb

    async def get(self, name: str):
        kb = self._kb(name)
        table = self.get_query_argument("table", None)
        if table is None:
            self.write_json({"kb": name, "tables": kb.tables.tables_for_kb(name)})
            return
        registered = {t["table_name"] for t in kb.tables.tables_for_kb(name)}
        if table not in registered:
            raise tornado.web.HTTPError(404, reason=f"table {table!r} not registered")
        limit = min(self.int_arg(self.get_query_argument("limit", "20"), "limit"), 500)
        preview = kb.tables.execute_sql(f'SELECT * FROM "{table}"', limit=limit)
        self.write_json({"kb": name, "table": table, **preview})

    async def post(self, name: str):
        """Read-only SQL console over the KB's table store."""
        kb = self._kb(name)
        body = self.json_body()
        sql = body.get("sql", "").strip()
        if not sql:
            raise tornado.web.HTTPError(400, reason="missing 'sql'")
        limit = min(self.int_arg(body.get("limit", 200), "limit"), 1000)
        result = kb.tables.execute_sql(sql, limit=limit)
        if "error" in result:
            self.write_json({"kb": name, "sql": sql, **result}, status=400)
            return
        self.write_json({"kb": name, "sql": sql, **result})

    async def delete(self, name: str):
        kb = self._kb(name)
        table = self.get_query_argument("table", None)
        if not table:
            raise tornado.web.HTTPError(400, reason="missing 'table'")
        dropped = kb.tables.drop_table(name, table)
        if not dropped:
            raise tornado.web.HTTPError(404, reason=f"table {table!r} not registered")
        self.write_json({"kb": name, "dropped": table})


class KBQAPairsHandler(BaseHandler):
    """QA-pair management: list / add / delete stored QA associations
    (ref: the QA management screens + routes, utu/rag/api/routes/
    knowledge_base.py:759-893; pairs are chunks with element_type=qa whose
    question is the vector and answer rides in metadata)."""

    def _kb(self, name: str):
        kb = self.state.kbs.get(name)
        if kb is None:
            raise tornado.web.HTTPError(404, reason=f"knowledge base {name!r} not found")
        return kb

    async def get(self, name: str):
        kb = self._kb(name)
        q = self.get_query_argument("q", "").lower()
        limit = int(self.get_query_argument("limit", "100"))
        offset = int(self.get_query_argument("offset", "0"))
        idx = kb.store._index
        pairs = []
        for c in idx.iter_live() if idx is not None else []:
            if (c.metadata or {}).get("element_type") != "qa":
                continue
            if q and q not in c.content.lower():
                continue
            meta = c.metadata or {}
            pairs.append(
                {
                    "id": c.id,
                    "source_id": c.document_id,
                    "question": c.content.split("\n")[0].removeprefix("Q: "),
                    "answer": meta.get("answer", ""),
                    "related_file": meta.get("related_file", ""),
                    # execution state (qa/execute): surfaced in the SPA QA tab
                    "learning_status": meta.get("learning_status", "pending"),
                    "executed_agents": meta.get("executed_agents", ""),
                    "executed_results": meta.get("executed_results", ""),
                    "executed_at": meta.get("executed_at", ""),
                    "memory_status": meta.get("memory_status", ""),
                }
            )
        self.write_json(
            {"kb": name, "matched": len(pairs), "qa_pairs": pairs[offset : offset + limit]}
        )

    async def post(self, name: str):
        import uuid as _uuid

        from ..ingest.processors import ProcessorContext, QAProcessor, SourceTask

        body = self.json_body()
        pairs = body.get("pairs") or []
        if not pairs or not all(p.get("question") for p in pairs):
            raise tornado.web.HTTPError(400, reason="need 'pairs' each with a 'question'")
        kb = self.get_or_create_kb(name)
        source_id = body.get("source_id") or f"qa-{_uuid.uuid4().hex[:8]}"
        ctx = ProcessorContext(
            name, kb.store, kb.embedder, kb.tables, kb.config.knowledge_builder
        )
        res = await QAProcessor(ctx).process(SourceTask(source_id, "qa", qa_pairs=pairs))
        await kb.warmup()
        self.write_json({"kb": name, "source_id": source_id, "added": res.chunks}, status=201)

    async def delete(self, name: str):
        kb = self._kb(name)
        cid = self.get_query_argument("id", None)
        source_id = self.get_query_argument("source_id", None)
        if cid:
            await kb.store.delete([cid])
            self.write_json({"deleted": 1})
        elif source_id:
            n = await kb.store.delete_by_document_id(source_id)
            self.write_json({"deleted": n})
        else:
            raise tornado.web.HTTPError(400, reason="need ?id= or ?source_id=")


# QA execute: per-pair agent selection + execution + persisted results
# (ref: utu/rag/api/routes/knowledge_base.py:759-818 —
#  select_agents_for_qa / execute_agent_for_qa; VERDICT r2 item 6)

_BUILTIN_AGENT_CATALOG = [
    {
        "name": "kb_search",
        "type": "simple",
        "description": "Knowledge-base retrieval agent: searches the KB index, "
        "reranks, answers from retrieved context. Best for factual questions "
        "answerable from indexed documents.",
        "requires_kb": True,
    },
    {
        "name": "orchestra",
        "type": "orchestra",
        "description": "Plan→work→report multi-step agent for questions that "
        "need decomposition into several retrieval/analysis steps.",
    },
    {
        "name": "text2sql",
        "type": "orchestra_react_sql",
        "description": "SQL analysis over structured/tabular KB data (counts, "
        "aggregates, filters over imported tables).",
        "requires_kb": True,
    },
]

_QA_SELECT_PROMPT = """Select the best agent(s) to answer this stored QA pair.

Question: {question}
How to find (hint, may be empty): {howtofind}

Available agents:
{agents_desc}

Reply with ONLY a JSON array of agent names, most suitable first,
e.g. ["kb_search"]."""


@functools.lru_cache(maxsize=1)
def _frontend_agents_config() -> dict:
    """configs/rag/frontend_agents.yaml — the editable agent catalog the
    UI offers and the selection LLM chooses from (ref: the reference's
    configs/rag/frontend_agents.yaml consumed by routes/config.py and
    auto_select_and_stream). Missing/invalid file → built-ins."""
    try:
        from ..core.loader import ConfigLoader

        doc = ConfigLoader().load_raw("frontend_agents", group="rag")
        agents = [
            {
                "name": str(a["name"]),
                "type": str(a.get("type", "simple")),
                "description": str(a.get("description", "")).strip(),
                "icon": a.get("icon", ""),
                # UI send-gate: this agent needs a knowledge base selected
                # (ref chat.js AGENT_KB_REQUIREMENTS)
                "requires_kb": bool(a.get("requires_kb", False)),
            }
            for a in doc.get("agents", [])
            if isinstance(a, dict) and a.get("name")
        ]
        if agents:
            return {
                "agents": agents,
                "selection_prompt": (doc.get("agent_selection") or {}).get(
                    "selection_prompt"
                ),
            }
    except Exception:  # noqa: BLE001 - a broken catalog must not kill routes
        logger.exception("frontend_agents.yaml load failed; using built-ins")
    return {"agents": _BUILTIN_AGENT_CATALOG, "selection_prompt": None}


def agent_catalog() -> list[dict]:
    return _frontend_agents_config()["agents"]


async def select_agents_for_qa(question: str, howtofind: str, chat) -> list[str]:
    """LLM agent choice with a deterministic kb_search fallback (ref:
    select_agents_for_qa, knowledge_base.py:759-816)."""
    catalog = agent_catalog()
    valid = {a["name"] for a in catalog}
    try:
        desc = "\n".join(f"- {a['name']}: {a['description']}" for a in catalog)
        prompt_tpl = _frontend_agents_config()["selection_prompt"] or _QA_SELECT_PROMPT
        raw = await chat(
            prompt_tpl.format(
                question=question, howtofind=howtofind or "(none)", agents_desc=desc
            )
        )
        m = re.search(r"\[.*?\]", raw, re.DOTALL)
        names = [str(n) for n in json.loads(m.group(0))] if m else []
        picked = [n for n in names if n in valid]
        if picked:
            return picked
    except Exception:  # noqa: BLE001 - selection is advisory
        logger.exception("QA agent selection failed; falling back to kb_search")
    return ["kb_search" if "kb_search" in valid else catalog[0]["name"]]


class KBQAExecuteHandler(BaseHandler):
    """POST /{kb}/qa/execute {"id": chunk_id} — select agent(s) for the
    stored pair, run them against the KB, persist the executed answers in
    the pair's metadata, and (when memory is on) store the exchange to
    episodic memory (ref knowledge_base.py:560-680)."""

    def _qa_chunk(self, kb, cid: str):
        chunk = kb.store.index.get_by_id(cid) if kb.store._index is not None else None
        if chunk is None or (chunk.metadata or {}).get("element_type") != "qa":
            raise tornado.web.HTTPError(404, reason=f"QA pair {cid!r} not found")
        return chunk

    async def _execute_one(self, name: str, kb, cid: str) -> dict:
        chunk = self._qa_chunk(kb, cid)
        meta = dict(chunk.metadata or {})
        question = chunk.content.split("\n")[0].removeprefix("Q: ")
        howtofind = meta.get("howtofind", "")

        agent = await self.state.get_agent()
        chat = _agent_chat_fn(agent)
        selected = (
            await select_agents_for_qa(question, howtofind, chat)
            if chat is not None
            else ["kb_search"]
        )

        from ..agents.factory import get_agent as build_agent

        query_aug, _ = _modify_query(self.state, question, name, None)
        results = []
        for agent_name in selected:
            spec = next(a for a in agent_catalog() if a["name"] == agent_name)
            try:
                if spec["type"] == self.state.agent_config.type:
                    # the live configured agent already matches (and holds
                    # the session's LLM client); reuse it
                    runner = agent
                else:
                    cfg = self.state.agent_config.model_copy(update={"type": spec["type"]})
                    runner = build_agent(cfg, device=self.state.device)
                    if hasattr(runner, "build"):
                        await runner.build()
                rec = await runner.run(query_aug)
                results.append(
                    {"agent": agent_name, "success": True, "answer": rec.final_output or ""}
                )
            except Exception as e:  # noqa: BLE001 - per-agent failures recorded
                logger.exception("QA execution via %s failed", agent_name)
                results.append({"agent": agent_name, "success": False, "error": str(e)})

        status = "completed" if any(r.get("success") for r in results) else "failed"
        meta.update(
            {
                "learning_status": status,
                "executed_agents": ",".join(selected),
                "executed_results": json.dumps(results, ensure_ascii=False)[:8000],
                "executed_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
            }
        )
        if self.state.memory_enabled and meta.get("answer"):
            try:
                if self.state.memory_toolkit is None:
                    self.state.memory_toolkit = self.state.new_memory_toolkit()
                body = f"answer: {meta['answer']}"
                if howtofind:
                    body += f"\nhowtofind: {howtofind}"
                await self.state.memory_toolkit.store_conversation(question, body)
                meta["memory_status"] = "memorized"
            except Exception:  # noqa: BLE001
                logger.exception("QA memory save failed")
                meta["memory_status"] = "failed"
        await kb.store.update_metadata([cid], [meta])
        return {
            "qa_id": cid,
            "question": question,
            "selected_agents": selected,
            "execution_results": results,
            "final_status": status,
        }

    async def post(self, name: str):
        kb = self.state.kbs.get(name)
        if kb is None:
            raise tornado.web.HTTPError(404, reason=f"knowledge base {name!r} not found")
        body = self.json_body()
        cid = body.get("id")
        if not cid:
            raise tornado.web.HTTPError(400, reason="need 'id' (QA chunk id)")
        self.write_json(await self._execute_one(name, kb, cid))


class KBQABatchExecuteHandler(KBQAExecuteHandler):
    """POST /{kb}/qa/batch-execute {"ids": [...]} (ref knowledge_base.py:
    703-754): execute each pair, tolerate per-pair failures."""

    async def post(self, name: str):
        kb = self.state.kbs.get(name)
        if kb is None:
            raise tornado.web.HTTPError(404, reason=f"knowledge base {name!r} not found")
        ids = self.json_body().get("ids") or []
        if not ids:
            raise tornado.web.HTTPError(400, reason="need 'ids'")
        results = []
        for cid in ids:
            try:
                r = await self._execute_one(name, kb, cid)
                results.append({"qa_id": cid, "success": r["final_status"] == "completed", "result": r})
            except tornado.web.HTTPError as e:
                results.append({"qa_id": cid, "success": False, "error": e.reason})
            except Exception as e:  # noqa: BLE001
                logger.exception("batch QA execute failed for %s", cid)
                results.append({"qa_id": cid, "success": False, "error": str(e)})
        ok = sum(1 for r in results if r["success"])
        self.write_json(
            {"total": len(ids), "success": ok, "failed": len(ids) - ok, "results": results}
        )


class KBMetadataHandler(BaseHandler):
    """Chunk-metadata export/import (ref: rag_webui Excel metadata
    import/export screens). Export is CSV (chunk_id, document_id,
    chunk_index, content_preview, metadata JSON); import accepts the same
    CSV back, or JSON {"updates": [{"id", "metadata"}]} — edits are
    metadata-only (device filter columns re-encode; vectors untouched)."""

    def _kb(self, name: str):
        kb = self.state.kbs.get(name)
        if kb is None:
            raise tornado.web.HTTPError(404, reason=f"knowledge base {name!r} not found")
        return kb

    async def get(self, name: str):
        import csv
        import io

        kb = self._kb(name)
        idx = kb.store._index
        buf = io.StringIO()
        w = csv.writer(buf)
        w.writerow(["chunk_id", "document_id", "chunk_index", "content_preview", "metadata"])
        for c in idx.iter_live() if idx is not None else []:
            w.writerow(
                [
                    c.id,
                    c.document_id,
                    c.chunk_index,
                    c.content[:120].replace("\n", " "),
                    json.dumps(c.metadata or {}, ensure_ascii=False),
                ]
            )
        self.set_header("Content-Type", "text/csv; charset=utf-8")
        self.set_header(
            "Content-Disposition", f'attachment; filename="{name}-metadata.csv"'
        )
        self.finish(buf.getvalue())

    async def post(self, name: str):
        import csv
        import io

        kb = self._kb(name)
        ids: list[str] = []
        metas: list[dict] = []
        ctype = self.request.headers.get("Content-Type", "")
        if ctype.startswith("text/csv"):
            reader = csv.DictReader(io.StringIO(self.request.body.decode("utf-8-sig")))
            if not reader.fieldnames or "chunk_id" not in reader.fieldnames:
                raise tornado.web.HTTPError(400, reason="CSV needs a 'chunk_id' column")
            for row in reader:
                try:
                    meta = json.loads(row.get("metadata") or "{}")
                except json.JSONDecodeError:
                    raise tornado.web.HTTPError(
                        400, reason=f"bad metadata JSON for chunk {row['chunk_id']!r}"
                    ) from None
                ids.append(row["chunk_id"])
                metas.append(meta)
        else:
            body = self.json_body()
            for u in body.get("updates") or []:
                if not u.get("id") or not isinstance(u.get("metadata"), dict):
                    raise tornado.web.HTTPError(
                        400, reason="each update needs 'id' and object 'metadata'"
                    )
                ids.append(u["id"])
                metas.append(u["metadata"])
        if not ids:
            raise tornado.web.HTTPError(400, reason="no updates supplied")
        updated = await kb.store.update_metadata(ids, metas)
        self.write_json({"kb": name, "updated": updated, "submitted": len(ids)})


class KBIndexHandler(BaseHandler):
    """Index maintenance: build/drop the IVF (ANN) structure and compact
    tombstones on a live KB (the serving-side analog of FAISS retrain /
    Chroma segment GC the reference leaves to its stores)."""

    async def post(self, name: str):
        kb = self.state.kbs.get(name)
        if kb is None:
            raise tornado.web.HTTPError(404, reason=f"knowledge base {name!r} not found")
        idx = kb.store._index
        if idx is None:
            raise tornado.web.HTTPError(400, reason="knowledge base is empty")
        if not hasattr(idx, "build_ivf"):
            # numpy test backend: no device-index maintenance surface
            raise tornado.web.HTTPError(
                400, reason=f"index maintenance not supported for backend {type(idx).__name__}"
            )
        body = self.json_body()
        action = body.get("action")
        if action == "build_ivf":
            n_lists = body.get("n_lists")
            idx.build_ivf(n_lists=int(n_lists) if n_lists else None)
            await kb.warmup()
            self.write_json(
                {"action": action, "n_lists": idx._ivf.n_lists, "rows": idx.count()}
            )
        elif action == "drop_ivf":
            idx.drop_ivf()
            self.write_json({"action": action})
        elif action == "compact":
            before = idx.size
            idx.compact()
            self.write_json({"action": action, "rows_before": before, "rows_after": idx.size})
        else:
            raise tornado.web.HTTPError(
                400, reason="action must be build_ivf | drop_ivf | compact"
            )

    async def get(self, name: str):
        kb = self.state.kbs.get(name)
        if kb is None:
            raise tornado.web.HTTPError(404, reason=f"knowledge base {name!r} not found")
        idx = kb.store._index
        if idx is None:
            self.write_json({"rows": 0, "ivf": None})
            return
        if not hasattr(idx, "capacity"):  # numpy test backend
            self.write_json(
                {"rows": idx.count(), "backend": type(idx).__name__, "ivf": None}
            )
            return
        self.write_json(
            {
                "rows": idx.count(),
                "capacity": idx.capacity,
                "storage_dtype": idx.config.storage_dtype,
                "tombstones": idx.size - idx.live_count,
                "ivf": {
                    "n_lists": idx._ivf.n_lists,
                    "n_probe": idx._ivf.n_probe,
                    "adaptive_margin": idx.config.ivf_adaptive_margin,
                    "recall_target": idx.config.ivf_recall_target,
                    "observed_recall": idx._ivf_recall_est,
                }
                if idx._ivf
                else None,
            }
        )


class KBQueryHandler(BaseHandler):
    async def post(self, name: str):
        kb = self.state.kbs.get(name)
        if kb is None:
            raise tornado.web.HTTPError(404, reason=f"knowledge base {name!r} not found")
        body = self.json_body()
        query = body.get("query")
        if not query:
            raise tornado.web.HTTPError(400, reason="missing 'query'")
        import time as _time

        mode = body.get("mode", "dense")
        if mode not in ("dense", "hybrid", "lexical"):
            raise tornado.web.HTTPError(
                400, reason="mode must be one of dense|hybrid|lexical"
            )
        t0 = _time.perf_counter()
        if mode == "hybrid":
            alpha = body.get("hybrid_alpha")
            if alpha is not None:
                try:
                    alpha = float(alpha)
                except (TypeError, ValueError):
                    raise tornado.web.HTTPError(
                        400, reason="hybrid_alpha must be a number in [0, 1]"
                    ) from None
                if not 0.0 <= alpha <= 1.0:
                    raise tornado.web.HTTPError(400, reason="hybrid_alpha must be in [0, 1]")
            results = await kb.hybrid_retriever.retrieve(
                query,
                top_k=body.get("top_k", 5),
                filters=body.get("filters"),
                similarity_threshold=body.get("similarity_threshold", 0.0),
                hybrid_alpha=alpha,
            )
        elif mode == "lexical":
            from ..core.types import RetrievalResult as _RR

            hits = await kb.store.lexical_search(
                query, top_k=body.get("top_k", 5), filters=body.get("filters")
            )
            results = [
                _RR(chunk=c, score=s, rank=i + 1) for i, (c, s) in enumerate(hits)
            ]
        else:
            results = await kb.search(
                query,
                top_k=body.get("top_k", 5),
                filters=body.get("filters"),
                similarity_threshold=body.get("similarity_threshold", 0.0),
            )
        latency = (_time.perf_counter() - t0) * 1e3
        mon = self.state.monitor.monitors.get(name)
        if mon:
            await mon.log_query(query, latency, len(results))
        self.write_json(
            {
                "query": query,
                "results": [r.to_dict() for r in results],
                "total_results": len(results),
                "retrieval_time_ms": latency,
            }
        )


# ---------------------------------------------------------------------------
# files (ref: routes/minio_files.py — local store here)
# ---------------------------------------------------------------------------


class FileUploadHandler(BaseHandler):
    async def post(self):
        files = self.request.files.get("file")
        if not files:
            raise tornado.web.HTTPError(400, reason="multipart field 'file' required")
        f = files[0]
        meta_raw = self.get_body_argument("metadata", default="{}")
        try:
            user_meta = json.loads(meta_raw)
        except json.JSONDecodeError:
            raise tornado.web.HTTPError(400, reason="metadata must be JSON")
        meta = self.state.files.upload("uploads", f.filename, f.body, user_meta)
        self.write_json(meta, status=201)


class FileUploadProgressStartHandler(BaseHandler):
    async def post(self):
        files = self.request.files.get("file")
        if not files:
            raise tornado.web.HTTPError(400, reason="multipart field 'file' required")
        f = files[0]
        task = self.state.new_upload(f.filename)

        async def process():
            try:
                task.update("UPLOADING", 20)
                self.state.files.upload("uploads", f.filename, f.body, {})

                # OCR derivative when configured (ref: _process_ocr stage)
                from ..ingest.ocr import RemoteOCRClient, needs_ocr, process_ocr_to_store

                if needs_ocr(f.filename) and RemoteOCRClient().available:
                    task.update("OCR_PROCESSING", 40)
                    await process_ocr_to_store(self.state.files, "uploads", f.filename)

                # metadata extraction (ref: _extract_and_normalize_metadata)
                task.update("METADATA_EXTRACTING", 60)
                try:
                    text = f.body.decode("utf-8", errors="replace")[:2000]
                    from ..ingest.metadata_extractor import MetadataExtractor

                    meta = await MetadataExtractor().extract_metadata(f.filename, text)
                    self.state.files.set_user_metadata("uploads", f.filename, meta)
                except Exception:  # noqa: BLE001 - metadata is best-effort
                    logger.exception("metadata extraction failed")

                task.update("CHUNK_PROCESSING", 80)
                task.update("COMPLETED", 100)
            except Exception as e:  # noqa: BLE001
                task.status, task.error = "FAILED", str(e)

        asyncio.ensure_future(process())
        self.write_json({"task_id": task.task_id}, status=202)


class FileUploadProgressHandler(BaseHandler):
    async def get(self, task_id: str):
        task = self.state.uploads.get(task_id)
        if task is None:
            raise tornado.web.HTTPError(404, reason="unknown upload task")
        self.write_json(
            {
                "task_id": task.task_id,
                "filename": task.filename,
                "status": task.status,
                "progress": task.progress,
                "error": task.error,
            }
        )


class FileCollectionHandler(BaseHandler):
    async def get(self):
        self.write_json({"files": self.state.files.list("uploads")})


class FileItemHandler(BaseHandler):
    async def get(self, name: str):
        if not self.state.files.exists("uploads", name):
            raise tornado.web.HTTPError(404, reason="file not found")
        self.set_header("Content-Type", "application/octet-stream")
        self.finish(self.state.files.download("uploads", name))

    async def delete(self, name: str):
        """Delete an upload; refuses while knowledge bases reference it
        unless ``?force=true`` (ref: the delete reference checks in
        minio_files.py). Derived artifacts (OCR pages, chunk-level files)
        are removed with the original."""
        refs = self.state.file_references(name)
        force = self.get_query_argument("force", "").lower() in ("1", "true")
        if refs and not force:
            self.write_json(
                {
                    "error": "file is referenced by knowledge bases; "
                    "remove it from their source config or pass force=true",
                    "references": refs,
                },
                status=409,
            )
            return
        derived = self.state.derived_files(name)
        if not self.state.files.delete("uploads", name):
            raise tornado.web.HTTPError(404, reason="file not found")
        for d in derived:
            self.state.files.delete("uploads", d)
        self.write_json({"deleted": name, "derived_deleted": derived})


class FileReferencesHandler(BaseHandler):
    """ref: minio_files.py:983-1021 GET check-references/{filename}."""

    async def get(self, name: str):
        refs = self.state.file_references(name)
        self.write_json(
            {
                "filename": name,
                "is_referenced": bool(refs),
                "references": refs,
                "total_references": len(refs),
            }
        )


class FileZipHandler(BaseHandler):
    """Download the original plus its derived artifacts as one zip
    (ref: minio_files.py:1165-1392 download-with-ocr / -derivatives)."""

    async def get(self, name: str, kind: str):
        import io
        import zipfile

        files = self.state.files
        if not files.exists("uploads", name):
            raise tornado.web.HTTPError(404, reason="file not found")
        derived = self.state.derived_files(name)
        if kind == "ocr":
            derived = [d for d in derived if "_ocr." in d or "_layout." in d]
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr(name, files.download("uploads", name))
            for d in derived:
                try:
                    z.writestr(d, files.download("uploads", d))
                except (OSError, ValueError):
                    logger.exception("zip skip %s", d)
        stem = name.rsplit(".", 1)[0]
        self.set_header("Content-Type", "application/zip")
        self.set_header(
            "Content-Disposition", f'attachment; filename="{stem}_with_{kind}.zip"'
        )
        self.finish(buf.getvalue())


class FileOcrHandler(BaseHandler):
    """View + edit OCR results for an uploaded file
    (ref: minio_files.py:1500-1811 view/edit/save OCR markdown)."""

    def _pages(self, name: str) -> list[dict]:
        from ..ingest.ocr import page_json_name, page_layout_name, page_md_name

        files = self.state.files
        pages = []
        i = 1
        while files.exists("uploads", page_md_name(name, i)):
            meta = files.stat("uploads", page_md_name(name, i)) or {}
            entry = {
                "page_num": i,
                "markdown_text": files.download("uploads", page_md_name(name, i)).decode("utf-8"),
                "is_manual_edited": bool(
                    (meta.get("user_metadata") or {}).get("is_manual_edited")
                ),
            }
            if files.exists("uploads", page_json_name(name, i)):
                entry["structured_data"] = json.loads(
                    files.download("uploads", page_json_name(name, i)).decode("utf-8")
                )
            if files.exists("uploads", page_layout_name(name, i)):
                entry["layout_image_url"] = f"/api/files/{name}/ocr/layout/{i}"
            pages.append(entry)
            i += 1
        return pages

    async def get(self, name: str):
        from ..ingest.ocr import combined_md_name

        files = self.state.files
        combined_name = combined_md_name(name)
        pages = self._pages(name)
        has_combined = files.exists("uploads", combined_name)
        if not pages and not has_combined:
            raise tornado.web.HTTPError(404, reason=f"no OCR results for {name}")
        combined = (
            files.download("uploads", combined_name).decode("utf-8") if has_combined else None
        )
        if not pages and combined is not None:
            meta = files.stat("uploads", combined_name) or {}
            pages = [
                {
                    "page_num": 1,
                    "markdown_text": combined,
                    "is_manual_edited": bool(
                        (meta.get("user_metadata") or {}).get("is_manual_edited")
                    ),
                }
            ]
        self.write_json(
            {
                "filename": name,
                "is_multi_page": len(pages) > 1,
                "total_pages": len(pages),
                "pages": pages,
                "markdown_text": combined,
                "original_file_url": f"/api/files/{name}",
            }
        )

    async def put(self, name: str):
        """Save edited OCR markdown (overwrite mode). Body:
        {"page_num": N, "markdown_text": "..."} — page_num defaults to 1.
        The combined derived file regenerates so the next build picks up
        the edit through its changed content/derived hash."""
        from ..ingest.ocr import combine_pages, combined_md_name, page_md_name

        body = self.json_body()
        md = body.get("markdown_text")
        if md is None:
            raise tornado.web.HTTPError(400, reason="missing 'markdown_text'")
        page = int(body.get("page_num", 1))
        files = self.state.files
        combined_name = combined_md_name(name)
        edited_meta = {"derived_from": name, "kind": "ocr_page", "page": page, "is_manual_edited": True}

        if files.exists("uploads", page_md_name(name, page)):
            files.upload("uploads", page_md_name(name, page), md.encode("utf-8"), edited_meta)
            # regenerate the combined file from all page files
            page_mds = []
            i = 1
            while files.exists("uploads", page_md_name(name, i)):
                page_mds.append(
                    {"markdown": files.download("uploads", page_md_name(name, i)).decode("utf-8")}
                )
                i += 1
            files.upload(
                "uploads",
                combined_name,
                combine_pages(page_mds).encode("utf-8"),
                {"derived_from": name, "kind": "ocr", "is_manual_edited": True},
            )
        elif files.exists("uploads", combined_name) or page == 1:
            files.upload(
                "uploads",
                combined_name,
                md.encode("utf-8"),
                {"derived_from": name, "kind": "ocr", "is_manual_edited": True},
            )
        else:
            raise tornado.web.HTTPError(404, reason=f"no OCR page {page} for {name}")
        self.write_json({"saved": name, "page_num": page})


class FileOcrLayoutHandler(BaseHandler):
    """Serve the OCR layout overlay image for a page
    (ref: minio_files.py get_ocr_layout_image)."""

    async def get(self, name: str, page: str):
        from ..ingest.ocr import page_layout_name

        lname = page_layout_name(name, int(page))
        if not self.state.files.exists("uploads", lname):
            raise tornado.web.HTTPError(404, reason=f"no layout image for {name} page {page}")
        self.set_header("Content-Type", "image/png")
        self.set_header("Content-Disposition", "inline")
        self.finish(self.state.files.download("uploads", lname))


# ---------------------------------------------------------------------------
# embedding / reranker services (ref: routes/embedding.py, routes/reranker.py)
# ---------------------------------------------------------------------------


class EmbedHandler(BaseHandler):
    async def post(self):
        body = self.json_body()
        texts = body.get("texts") or ([body["text"]] if body.get("text") else None)
        if not texts:
            raise tornado.web.HTTPError(400, reason="missing 'texts'")
        kb = self.get_or_create_kb(body.get("kb_id", "default"))
        embs = await kb.embedder.embed_texts(texts)
        self.write_json({"embeddings": embs, "dimension": len(embs[0]) if embs else 0})


class RerankHandler(BaseHandler):
    async def post(self):
        body = self.json_body()
        query, documents = body.get("query"), body.get("documents")
        if not query or not documents:
            raise tornado.web.HTTPError(400, reason="missing 'query' or 'documents'")
        from ..core.types import Chunk, RetrievalResult
        from ..models.reranker import LexicalReranker

        kb = self.state.kbs.get(body.get("kb_id", "default"))
        reranker = (kb.reranker if kb else None) or LexicalReranker()
        results = [
            RetrievalResult(Chunk(f"c{i}", "req", d, i), 0.0, i + 1) for i, d in enumerate(documents)
        ]
        ranked = await reranker.rerank(query, results, top_k=body.get("top_n"))
        self.write_json(
            {
                "results": [
                    {"index": int(r.chunk.id[1:]), "relevance_score": r.score, "document": r.chunk.content}
                    for r in ranked
                ]
            }
        )


# ---------------------------------------------------------------------------
# monitor / memory / agents
# ---------------------------------------------------------------------------


class MonitorHealthHandler(BaseHandler):
    async def get(self):
        self.write_json(await self.state.monitor.summary())


class MonitorMetricsHandler(BaseHandler):
    async def get(self):
        self.write_json(await self.state.monitor.detailed_report())


class MemoryConfigHandler(BaseHandler):
    async def get(self):
        self.write_json({"memoryEnabled": self.state.memory_enabled})

    async def post(self):
        body = self.json_body()
        enabled = bool(body.get("memoryEnabled"))
        changed = enabled != self.state.memory_enabled
        self.state.memory_enabled = enabled
        if enabled and self.state.memory_toolkit is None:
            self.state.memory_toolkit = self.state.new_memory_toolkit()
        if changed:
            # rebuild the agent so the toggle actually takes effect (the
            # toolkit wires in at agent construction, state.get_agent)
            await self.state.switch_agent(self.state.agent_config)
        self.write_json({"memoryEnabled": enabled})


def _memory_node_json(node, score: float | None = None) -> dict:
    d = {
        "id": node.id,
        "user_id": node.user_id,
        "memory_type": node.memory_type,
        "content": node.content,
        "importance": node.importance,
        "created_at": node.created_at,
        "session_id": node.session_id,
        "use_count": node.use_count,
        "success_rate": round(node.success_rate, 3),
        "metadata": node.metadata,
    }
    if score is not None:
        d["score"] = round(float(score), 4)
    return d


class MemoryItemsHandler(BaseHandler):
    """Memory browser: list / semantic-search / delete memories.

    Management surface over the memory plane — the reference only reaches
    memories through agent retrieval and an offline export script
    (``tests/rag/export_memory_data.py``); the SPA Memory tab needs
    first-class routes."""

    def _toolkit(self):
        if self.state.memory_toolkit is None:
            self.state.memory_toolkit = self.state.new_memory_toolkit()
        return self.state.memory_toolkit

    async def get(self):
        tk = self._toolkit()
        q = self.get_argument("q", "").strip()
        types_arg = self.get_argument("types", "").strip()
        types = [t for t in types_arg.split(",") if t] or None
        limit = max(1, min(int(self.get_argument("limit", "50")), 500))
        offset = max(0, int(self.get_argument("offset", "0")))
        user_id = self.get_argument("user_id", tk.user_id)
        if q:
            hits = await tk.store.search_memories(
                user_id, q, memory_types=types, top_k=limit
            )
            items = [_memory_node_json(n, s) for n, s in hits]
            total = len(items)
        else:
            nodes, total = tk.store.list_nodes(
                user_id=user_id, memory_types=types, limit=limit, offset=offset
            )
            items = [_memory_node_json(n) for n in nodes]
        self.write_json(
            {"items": items, "total": total,
             "stats": tk.store.stats(user_id), "user_id": user_id}
        )

    async def post(self):
        tk = self._toolkit()
        body = self.json_body()
        content = (body.get("content") or "").strip()
        memory_type = body.get("memory_type") or "semantic"
        if not content:
            self.write_json({"error": "content is required"}, status=400)
            return
        from ..memory.store import MEMORY_TYPES

        if memory_type not in MEMORY_TYPES:
            self.write_json(
                {"error": f"memory_type must be one of {list(MEMORY_TYPES)}"},
                status=400,
            )
            return
        msg = await tk.add_memory(
            content,
            memory_type=memory_type,
            importance=float(body.get("importance", 0.5)),
        )
        self.write_json({"result": msg})

    async def delete(self):
        tk = self._toolkit()
        ids = self.json_body().get("ids") or []
        if not isinstance(ids, list) or not all(isinstance(i, str) for i in ids):
            self.write_json({"error": "ids must be a list of strings"}, status=400)
            return
        n = await tk.store.delete(ids)
        if tk.persist_path:
            tk.store.save(tk.persist_path)
        self.write_json({"deleted": n})


class AgentsHandler(BaseHandler):
    async def get(self):
        self.write_json(
            {
                "current": {
                    "type": self.state.agent_config.type,
                    "name": self.state.agent_config.agent.name,
                },
                "available_types": [
                    "simple",
                    "orchestra",
                    "orchestra_react_sql",
                    "orchestrator",
                    "parallel_orchestrator",
                    "workforce",
                    "excel",
                ],
                # the editable catalog the UI/auto-select chooses from
                # (configs/rag/frontend_agents.yaml; ref routes/config.py)
                "catalog": agent_catalog(),
            }
        )


class AgentSwitchHandler(BaseHandler):
    async def post(self):
        body = self.json_body()
        try:
            config = AgentConfig.from_dict(body)
        except Exception as e:  # noqa: BLE001
            # tornado reasons must be single-line; pydantic errors aren't
            detail = " | ".join(str(e).splitlines())[:300]
            raise tornado.web.HTTPError(400, reason=f"invalid agent config: {detail}") from None
        await self.state.switch_agent(config)
        self.write_json({"switched": config.type})


class ChatWebSocketHandler(tornado.websocket.WebSocketHandler):
    """WebSocket chat (parity surface: utu/ui/webui_agents.py tornado WS
    chat servers). Protocol: client sends {"query": ..., "kb_id": ...};
    server streams the same event cards as the SSE route, then
    {"type": "done"}."""

    def check_origin(self, origin):  # dev CORS parity
        return True

    @property
    def state(self) -> ApiState:
        return self.application.settings["api_state"]

    async def on_message(self, message):
        try:
            body = json.loads(message)
        except json.JSONDecodeError:
            await self.write_message(json.dumps({"type": "error", "content": "invalid JSON"}))
            return
        query = body.get("query")
        if not query:
            await self.write_message(json.dumps({"type": "error", "content": "missing 'query'"}))
            return
        try:
            query, table_path = _modify_query(
                self.state, query, body.get("kb_id"), body.get("file_ids")
            )
        except tornado.web.HTTPError as e:
            await self.write_message(json.dumps({"type": "error", "content": e.reason}))
            return
        agent = await self.state.get_agent()
        excel_routed = table_path is not None and hasattr(agent, "load_schema")
        recorder = (
            agent.run_streamed(query, table_path) if excel_routed else agent.run_streamed(query)
        )
        streamed_error = False
        async for ev in recorder.stream_events():
            card = {"type": ev.type}
            if ev.text:
                card["content"] = ev.text
            if ev.name:
                card["name"] = ev.name
            if ev.arguments:
                card["arguments"] = ev.arguments
            if ev.data:
                card["data"] = ev.data
            streamed_error = streamed_error or ev.type == "error"
            try:
                await self.write_message(json.dumps(card, ensure_ascii=False))
            except tornado.websocket.WebSocketClosedError:
                return
        try:
            await recorder.wait()
        except RuntimeError as e:
            if not streamed_error:
                await self.write_message(
                    json.dumps({"type": "error", "content": str(e)}, ensure_ascii=False)
                )
        # always terminate with done — clients reset their awaiting state
        # on it (same contract as the SSE route)
        try:
            await self.write_message(
                json.dumps({"type": "done", "trace_id": getattr(recorder, "trace_id", None)})
            )
        except tornado.websocket.WebSocketClosedError:
            pass


class TrajectoriesHandler(BaseHandler):
    """Recent agent run records (ref: trajectory DB reads, utu/db)."""

    async def get(self):
        from ..db.models import TrajectoryRecord

        limit = int(self.get_query_argument("limit", "20"))
        rows = self.state.db.select(TrajectoryRecord, limit=limit)
        self.write_json(
            {
                "available": self.state.db.available,
                "trajectories": [
                    {
                        "trace_id": r.trace_id,
                        "input": r.input,
                        "output": r.output,
                        "tool_calls": r.tool_calls,
                        "usage_input_tokens": r.usage_input_tokens,
                        "usage_output_tokens": r.usage_output_tokens,
                        "created_at": r.created_at,
                        "error": r.error,
                    }
                    for r in rows
                ],
            }
        )


class IndexPageHandler(BaseHandler):
    async def get(self):
        import os

        page = os.path.join(os.path.dirname(__file__), "static", "index.html")
        self.set_header("Content-Type", "text/html; charset=utf-8")
        with open(page, "rb") as f:
            self.finish(f.read())


def create_app(state: ApiState | None = None) -> tornado.web.Application:
    import os as _os

    state = state or ApiState()
    static_dir = _os.path.join(_os.path.dirname(__file__), "static")
    return tornado.web.Application(
        [
            (r"/", IndexPageHandler),
            (r"/static/(.*)", tornado.web.StaticFileHandler, {"path": static_dir}),
            (r"/ws/chat", ChatWebSocketHandler),
            (r"/api/trajectories", TrajectoriesHandler),
            (r"/health", HealthHandler),
            (r"/api/chat", ChatHandler),
            (r"/api/knowledge-bases", KBCollectionHandler),
            (r"/api/knowledge-bases/([^/]+)", KBItemHandler),
            (r"/api/knowledge-bases/([^/]+)/build", KBBuildHandler),
            (r"/api/knowledge-bases/([^/]+)/build-logs", KBBuildLogsHandler),
            (r"/api/knowledge-bases/([^/]+)/snapshot", KBSnapshotHandler),
            (r"/api/knowledge-bases/([^/]+)/query", KBQueryHandler),
            (r"/api/knowledge-bases/([^/]+)/qa", KBQAHandler),
            (r"/api/knowledge-bases/([^/]+)/tables", KBTablesHandler),
            (r"/api/knowledge-bases/([^/]+)/config", KBConfigHandler),
            (r"/api/db/test", DBTestHandler),
            (r"/api/qa-files/validate", QAFileValidateHandler),
            (r"/api/knowledge-bases/([^/]+)/qa-pairs", KBQAPairsHandler),
            (r"/api/knowledge-bases/([^/]+)/qa/execute", KBQAExecuteHandler),
            (r"/api/knowledge-bases/([^/]+)/qa/batch-execute", KBQABatchExecuteHandler),
            (r"/api/knowledge-bases/([^/]+)/metadata", KBMetadataHandler),
            (r"/api/knowledge-bases/([^/]+)/index", KBIndexHandler),
            (r"/api/knowledge-bases/([^/]+)/chunks", KBChunksHandler),
            (r"/api/files/upload", FileUploadHandler),
            (r"/api/files/upload-with-progress", FileUploadProgressStartHandler),
            (r"/api/files/upload-progress/([^/]+)", FileUploadProgressHandler),
            (r"/api/files", FileCollectionHandler),
            (r"/api/files/([^/]+)/references", FileReferencesHandler),
            (r"/api/files/([^/]+)/download-with-(ocr|derivatives)", FileZipHandler),
            (r"/api/files/([^/]+)/ocr", FileOcrHandler),
            (r"/api/files/([^/]+)/ocr/layout/([0-9]+)", FileOcrLayoutHandler),
            (r"/api/files/([^/]+)", FileItemHandler),
            (r"/api/embedding/embed", EmbedHandler),
            (r"/api/reranker/rerank", RerankHandler),
            (r"/api/monitor/health", MonitorHealthHandler),
            (r"/api/monitor/metrics", MonitorMetricsHandler),
            (r"/api/memory/config", MemoryConfigHandler),
            (r"/api/memory/items", MemoryItemsHandler),
            (r"/api/agents", AgentsHandler),
            (r"/api/agents/switch", AgentSwitchHandler),
        ],
        api_state=state,
    )
