"""KnowledgeBuilderAgent: the staged multi-source build pipeline.

A copy of ``youtu_rag_tpu/ingest/agent.py`` over the port's store
(the index on its device; the tables, the manifest and the processors on
the host).

Parity with ``utu/rag/knowledge_builder/agent.py:32-1091``:
  Stage 0  analyze sources + check incremental state (config_analyzer.py)
  Stage 1  group tasks {text, table, qa, database} (:658)
  Stage 2  parallel asyncio processing with per-source error isolation and
           progress callbacks (:743-830)
  Stage 3  QA associations (:981)
  then a BuildReport (:1034).

Incremental skip: per-source etag + metadata-hash + derived-files-hash
triple via BuildManifest (ref: kb_config_routes.py:504-605)."""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

from ..core.config import KnowledgeBuilderConfig
from ..core.types import BaseEmbedder
from ..index.persistence import BuildManifest
from ..retrieval.store import TorchVectorStore
from ..utils.log import get_logger
from .processors import (
    FileProcessorFactory,
    ProcessResult,
    ProcessorContext,
    SourceTask,
)
from .tables import TableStore

logger = get_logger("ingest.agent")


@dataclass
class BuildRequest:
    kb_name: str = "default"
    tasks: list[SourceTask] = field(default_factory=list)
    rebuild: bool = False
    incremental: bool = True


@dataclass
class BuildReport:
    kb_name: str
    total_sources: int = 0
    processed: int = 0
    skipped: int = 0
    failed: int = 0
    total_chunks: int = 0
    tables: list[str] = field(default_factory=list)
    errors: list[str] = field(default_factory=list)
    duration_s: float = 0.0
    results: list[ProcessResult] = field(default_factory=list)
    analysis: dict[str, Any] = field(default_factory=dict)

    def summary(self) -> dict[str, Any]:
        return {
            "kb": self.kb_name,
            "sources": self.total_sources,
            "processed": self.processed,
            "skipped": self.skipped,
            "failed": self.failed,
            "chunks": self.total_chunks,
            "tables": self.tables,
            "errors": self.errors,
            "duration_s": round(self.duration_s, 3),
            "by_kind": self.analysis.get("by_kind", {}),
            "total_bytes": self.analysis.get("total_bytes", 0),
        }


class KnowledgeBuilderAgent:
    def __init__(
        self,
        kb_name: str,
        store: TorchVectorStore,
        embedder: BaseEmbedder,
        tables: TableStore | None = None,
        config: KnowledgeBuilderConfig | None = None,
        manifest: BuildManifest | None = None,
        on_progress: Callable[[str, str, int, int], None] | None = None,
    ):
        self.config = config or KnowledgeBuilderConfig()
        self.tables = tables or TableStore()
        self.ctx = ProcessorContext(kb_name, store, embedder, self.tables, self.config)
        self.manifest = manifest or BuildManifest()
        self.on_progress = on_progress
        self._lock = asyncio.Lock()

    def _progress(self, source: str, status: str, done: int, total: int) -> None:
        if self.on_progress:
            try:
                self.on_progress(source, status, done, total)
            except Exception:  # noqa: BLE001
                logger.exception("progress callback failed")

    # -- stage 0: analysis -------------------------------------------------

    _STORAGE_TARGETS = {
        "text": ("vector_index",),
        "table": ("vector_index", "table_store"),
        "database": ("vector_index", "table_store"),
        "qa": ("vector_index",),
    }
    _PROCESSOR_NAMES = {
        "text": "TextProcessor",
        "table": "ExcelProcessor",
        "database": "DatabaseProcessor",
        "qa": "QAProcessor",
    }

    async def analyze(self, request: BuildRequest) -> dict[str, Any]:
        """Stage-0 planner: source statistics, storage-state check, and a
        per-source processing plan that drives skip/process decisions
        (ref: KnowledgeBuilderAnalyzer.analyze, config_analyzer.py:98-533).

        Unlike the reference (which only checks that the persist dirs
        exist), the storage-state check here inspects the *live* store: a
        source whose hashes are unchanged but whose recorded chunks are
        missing from the index (store cleared, older snapshot restored) is
        re-processed rather than silently skipped."""
        plans = []
        by_kind: dict[str, int] = {}
        by_ext: dict[str, int] = {}
        total_bytes = 0
        for task in request.tasks:
            kind = FileProcessorFactory.task_kind(task)
            by_kind[kind] = by_kind.get(kind, 0) + 1
            ext = Path(task.path).suffix.lstrip(".").lower() if task.path else "inline"
            by_ext[ext] = by_ext.get(ext, 0) + 1
            size = 0
            if task.path and Path(task.path).exists():
                size = Path(task.path).stat().st_size
            elif task.document is not None:
                size = len(task.document.content)
            total_bytes += size
            etag, meta_hash, derived_hash = self._hashes(task)

            record = self.manifest.sources.get(task.source_id)
            existing = await self._existing_chunks(task)
            if request.rebuild:
                action, reason = "process", "full_rebuild"
            elif not request.incremental:
                action, reason = "process", "incremental_disabled"
            elif self.manifest.needs_rebuild(task.source_id, etag, meta_hash, derived_hash):
                if record is None:
                    action, reason = "process", "new_source"
                elif record.etag != etag:
                    action, reason = "process", "content_changed"
                elif record.derived_files_hash != derived_hash:
                    action, reason = "process", "derived_files_changed"
                else:
                    action, reason = "process", "metadata_changed"
            elif record is not None and record.chunk_count > 0 and existing == 0:
                action, reason = "reprocess", "storage_divergence"
            else:
                action, reason = "skip", "up_to_date"

            plans.append(
                {
                    "source_id": task.source_id,
                    "kind": kind,
                    "file_type": ext,
                    "size_bytes": size,
                    "etag": etag,
                    "metadata_hash": meta_hash,
                    "derived_files_hash": derived_hash,
                    "processor": self._PROCESSOR_NAMES[kind],
                    "storage_targets": list(self._STORAGE_TARGETS[kind]),
                    "existing_chunks": existing,
                    "manifest_chunks": record.chunk_count if record else 0,
                    "action": action,
                    "reason": reason,
                }
            )

        storage_state = await self._storage_state()
        return {
            "total": len(request.tasks),
            "by_kind": by_kind,
            "by_file_type": by_ext,
            "total_bytes": total_bytes,
            "storage_state": storage_state,
            "plans": plans,
        }

    async def _existing_chunks(self, task: SourceTask) -> int:
        """Live chunk count for a source (tries the loader doc-id alias for
        file paths, where document_id == basename)."""
        store = self.ctx.store
        n = await store.count_by_document(task.source_id)
        if n == 0 and task.path:
            n = await store.count_by_document(Path(task.path).name)
        return n

    async def _storage_state(self) -> dict[str, Any]:
        store = self.ctx.store
        idx = getattr(store, "_index", None)  # None until first add_chunks
        state: dict[str, Any] = {
            "vector_store": {
                "backend": "torch_device_index",
                "live_chunks": await store.count(),
                "capacity": getattr(idx, "capacity", 0) if idx is not None else 0,
                "nbytes": idx.nbytes() if idx is not None else 0,
                "ivf": bool(getattr(idx, "_ivf", None)) if idx is not None else False,
            },
            "manifest_sources": len(self.manifest.sources),
        }
        try:
            tables = self.tables.tables_for_kb(self.ctx.kb_name)
            state["table_store"] = {"tables": [t["table_name"] for t in tables]}
        except Exception:  # noqa: BLE001 - table store may be closed
            state["table_store"] = {"tables": []}
        return state

    @staticmethod
    def _hashes(task: SourceTask) -> tuple[str, str, str]:
        if task.path and Path(task.path).exists():
            etag = BuildManifest.hash_content(Path(task.path).read_bytes())
        elif task.document is not None:
            etag = BuildManifest.hash_content(task.document.content)
        else:
            etag = BuildManifest.hash_content(
                "".join(f"{p.get('question')}{p.get('answer')}" for p in task.qa_pairs)
            )
        # derived-files hash: joint hash of the sibling chunklevel/OCR
        # derivatives the loaders prefer, so an OCR edit (same original
        # bytes) still triggers a rebuild (ref: kb_config_routes.py:504-605,
        # minio_client derived-markdown combined-hash :410-580)
        derived = ""
        if task.path:
            p = Path(task.path)
            parts = []
            for sib in (f"{p.with_suffix('')}_chunklevel.md", f"{p.with_suffix('')}_ocr.md"):
                sp = Path(sib)
                if sp.exists():
                    parts.append(BuildManifest.hash_content(sp.read_bytes()))
            derived = BuildManifest.hash_content("|".join(parts)) if parts else ""
        return etag, BuildManifest.hash_metadata(task.metadata), derived

    # -- main --------------------------------------------------------------

    async def build(self, request: BuildRequest) -> BuildReport:
        async with self._lock:
            t0 = time.perf_counter()
            report = BuildReport(kb_name=request.kb_name, total_sources=len(request.tasks))
            analysis = await self.analyze(request)
            report.analysis = analysis
            plan_by_id = {p["source_id"]: p for p in analysis["plans"]}

            # stage 1: task groups — qa runs after text/table (associations
            # may reference built files, ref stage 3 ordering)
            main_tasks = [t for t in request.tasks if plan_by_id[t.source_id]["kind"] != "qa"]
            qa_tasks = [t for t in request.tasks if plan_by_id[t.source_id]["kind"] == "qa"]

            done_counter = {"n": 0}
            total = len(request.tasks)
            sem = asyncio.Semaphore(self.config.max_workers)

            async def run_one(task: SourceTask) -> None:
                plan = plan_by_id[task.source_id]
                if plan["action"] == "skip":
                    report.skipped += 1
                    done_counter["n"] += 1
                    self._progress(task.source_id, "skipped", done_counter["n"], total)
                    return
                async with sem:
                    self._progress(task.source_id, "running", done_counter["n"], total)
                    from ..tracing.tracer import get_tracer

                    try:
                        with get_tracer().span(
                            "ingest", f"process:{plan['kind']}", source=task.source_id
                        ) as ps:
                            proc = FileProcessorFactory.create(plan["kind"], self.ctx)
                            result = await proc.process(task)
                            ps.attributes["chunks"] = result.chunks
                        report.results.append(result)
                        report.processed += 1
                        report.total_chunks += result.chunks
                        report.tables.extend(result.tables)
                        self.manifest.record(
                            task.source_id,
                            plan["etag"],
                            plan["metadata_hash"],
                            derived_files_hash=plan["derived_files_hash"],
                            chunk_count=result.chunks,
                        )
                        status = "completed"
                    except Exception as e:  # noqa: BLE001 - per-source isolation
                        logger.exception("source %s failed", task.source_id)
                        report.failed += 1
                        report.errors.append(f"{task.source_id}: {e}")
                        report.results.append(
                            ProcessResult(task.source_id, ok=False, error=str(e))
                        )
                        status = "failed"
                    done_counter["n"] += 1
                    self._progress(task.source_id, status, done_counter["n"], total)

            # stage 2: parallel main sources
            await asyncio.gather(*(run_one(t) for t in main_tasks))
            # stage 3: qa associations
            await asyncio.gather(*(run_one(t) for t in qa_tasks))

            report.duration_s = time.perf_counter() - t0
            logger.info("build report: %s", report.summary())
            return report
