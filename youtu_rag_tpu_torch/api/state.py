"""API application state: KB registry, agent, files, memory, monitors.

A port of ``youtu_rag_tpu/api/state.py`` with the port's device seam:
``ApiState(device=...)`` places every KB, memory toolkit and agent it
builds on that device (``None`` is the CUDA card and raises on a host
without one; ``"cpu"`` runs the plain path). ``ApiState(mesh=...)`` (a
``parallel.mesh.Mesh``) shards every KB it creates over the mesh's ``db``
axis, as the JAX package's does; the rest lives on the mesh's device.

Replaces the reference's globals + dependency injection
(``utu/rag/api/dependencies.py:22-202``, MinIO client
``minio_client.py:16-630``): one explicit ``ApiState`` object handed to the
tornado app. File storage is a local-disk store with the MinIO client
surface (upload/download/stat/list/delete + user metadata); an S3/MinIO
client can implement the same interface when object storage exists."""

from __future__ import annotations

import asyncio
import json
import re
import shutil
import time
import uuid
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import torch

from ..agents.config import AgentConfig
from ..core.config import RAGConfig
from ..db.service import DBService
from ..memory.toolkit import VectorMemoryToolkit
from ..retrieval.kb import GLOBAL_KB_REGISTRY, KBRegistry, KnowledgeBase
from ..retrieval.monitoring import UnifiedStorageMonitor
from ..utils.device import resolve_device
from ..utils.hashing import content_etag
from ..utils.log import get_logger

logger = get_logger("api.state")


def shared_config(config: RAGConfig) -> dict[str, Any]:
    """``config`` as ``kb.json`` stores it: the device engine under the
    name the JAX package and the shared ``configs/rag/*.yaml`` give it
    ("tpu"; the port reads it back as "torch"), so that either package
    rehydrates a data dir the other wrote."""
    doc = config.model_dump(mode="json")
    if doc["vector_store"]["backend"] == "torch":
        doc["vector_store"]["backend"] = "tpu"
    return doc


class LocalFileStore:
    """MinIO-surface file store on local disk.

    Layout: ``<root>/<bucket>/<name>`` + ``<root>/<bucket>/.meta/<name>.json``
    (user metadata headers, ref: minio_client.py upload with user-meta)."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, bucket: str, name: str) -> Path:
        # names arrive attacker-controlled (multipart uploads, URL path
        # args); a startswith-without-separator or assert-based guard is
        # bypassable ('..%2F', sibling-prefix dirs, python -O)
        bdir = (self.root / bucket).resolve()
        p = (bdir / name).resolve()
        if p == bdir or not p.is_relative_to(bdir):
            raise ValueError(f"invalid object name (path escape): {name!r}")
        return p

    def _meta_path(self, bucket: str, name: str) -> Path:
        mdir = (self.root / bucket / ".meta").resolve()
        p = (mdir / f"{name}.json").resolve()
        if not p.is_relative_to(mdir):
            raise ValueError(f"invalid object name (path escape): {name!r}")
        return p

    def upload(self, bucket: str, name: str, data: bytes, metadata: dict | None = None) -> dict:
        p = self._path(bucket, name)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(data)
        meta = {
            "name": name,
            "bucket": bucket,
            "size": len(data),
            "etag": content_etag(data),
            "uploaded_at": time.time(),
            "user_metadata": metadata or {},
        }
        mp = self._meta_path(bucket, name)
        mp.parent.mkdir(parents=True, exist_ok=True)
        mp.write_text(json.dumps(meta, ensure_ascii=False))
        return meta

    def download(self, bucket: str, name: str) -> bytes:
        return self._path(bucket, name).read_bytes()

    def stat(self, bucket: str, name: str) -> dict | None:
        mp = self._meta_path(bucket, name)
        if not mp.exists():
            return None
        return json.loads(mp.read_text())

    def set_user_metadata(self, bucket: str, name: str, metadata: dict) -> dict | None:
        meta = self.stat(bucket, name)
        if meta is None:
            return None
        meta["user_metadata"].update(metadata)
        self._meta_path(bucket, name).write_text(json.dumps(meta, ensure_ascii=False))
        return meta

    def list(self, bucket: str) -> list[dict]:
        bdir = self.root / bucket
        if not bdir.exists():
            return []
        out = []
        for f in sorted(bdir.rglob("*")):
            if f.is_file() and ".meta" not in f.parts:
                name = str(f.relative_to(bdir))
                out.append(self.stat(bucket, name) or {"name": name, "size": f.stat().st_size})
        return out

    def delete(self, bucket: str, name: str) -> bool:
        p = self._path(bucket, name)
        existed = p.exists()
        if existed:
            p.unlink()
        mp = self._meta_path(bucket, name)
        if mp.exists():
            mp.unlink()
        return existed

    def exists(self, bucket: str, name: str) -> bool:
        return self._path(bucket, name).exists()

    def local_path(self, bucket: str, name: str) -> Path:
        return self._path(bucket, name)

    def clear_bucket(self, bucket: str) -> None:
        shutil.rmtree(self.root / bucket, ignore_errors=True)


@dataclass
class UploadTask:
    """Upload progress tracking (ref: upload_progress.py:8-96 states)."""

    task_id: str
    filename: str
    status: str = "PENDING"  # PENDING→UPLOADING→METADATA_EXTRACTING→CHUNK_PROCESSING→COMPLETED|FAILED
    progress: int = 0
    error: str | None = None
    created_at: float = field(default_factory=time.time)

    def update(self, status: str, progress: int) -> None:
        self.status = status
        self.progress = progress


class ApiState:
    def __init__(
        self,
        data_dir: str | Path = "./data/api",
        agent_config: AgentConfig | None = None,
        rag_config: RAGConfig | None = None,
        db: DBService | None = None,
        device: str | torch.device | None = None,
        mesh=None,
    ):
        # the optional mesh: every KB this state creates shards its index
        # over it (ShardedVectorIndex), the multi-device serving path
        self.mesh = mesh
        if mesh is not None:
            from ..parallel.sharded_index import mesh_device

            device = mesh_device(mesh, device)
        # every KB, memory toolkit and agent this state builds lives here
        self.device = resolve_device(device)
        self.data_dir = Path(data_dir)
        self.files = LocalFileStore(self.data_dir / "files")
        self.kbs = KBRegistry()
        self.rag_config = rag_config or RAGConfig()
        self.agent_config = agent_config or AgentConfig()
        self.agent = None  # built lazily (ref: initialize_agent in lifespan)
        self.memory_enabled = False
        self.memory_toolkit: VectorMemoryToolkit | None = None
        self.db = db or DBService()
        self.monitor = UnifiedStorageMonitor()
        self.uploads: dict[str, UploadTask] = {}
        self.build_logs: list[dict[str, Any]] = []
        self._lock = asyncio.Lock()
        self._rehydrate_kbs()

    # -- agent lifecycle (ref: dependencies.py:37-202) ---------------------

    async def get_agent(self):
        async with self._lock:
            if self.agent is None:
                from ..agents.factory import get_agent

                kwargs = {}
                if self.db.available and self.agent_config.type == "simple":
                    from ..db.models import TrajectoryRecord

                    async def sink(record, _db=self.db):
                        _db.add(TrajectoryRecord.from_recorder_dict(record))

                    kwargs["trajectory_sink"] = sink
                if self.memory_enabled and self.agent_config.type == "simple":
                    # the runtime memory toggle (POST /api/memory/config):
                    # the toolkit must reach the agent or the toggle is a
                    # no-op while /health reports memory on
                    if self.memory_toolkit is None:
                        self.memory_toolkit = self.new_memory_toolkit()
                    kwargs["memory_toolkit"] = self.memory_toolkit
                self.agent = get_agent(self.agent_config, device=self.device, **kwargs)
                if hasattr(self.agent, "build"):
                    await self.agent.build()
            return self.agent

    def new_memory_toolkit(self) -> VectorMemoryToolkit:
        return VectorMemoryToolkit({"device": self.device})

    async def switch_agent(self, config: AgentConfig) -> None:
        async with self._lock:
            if self.agent is not None and hasattr(self.agent, "cleanup"):
                await self.agent.cleanup()
            self.agent_config = config
            self.agent = None

    # -- KB helpers --------------------------------------------------------

    # KB names become directory components under the data dir (kbs/<name>,
    # snapshots/<name>) and arrive attacker-controlled from URL path args —
    # tornado percent-decodes AFTER the route regex matches, so "..%2Fx"
    # reaches here as "../x". Same threat class LocalFileStore._path guards.
    _KB_NAME_RE = re.compile(r"^[\w][\w.\- ]{0,63}$")

    @classmethod
    def validate_kb_name(cls, name: str) -> str:
        if (
            not isinstance(name, str)
            or not cls._KB_NAME_RE.match(name)
            or ".." in name
            or name.startswith(".")
        ):
            raise ValueError(
                f"invalid knowledge base name {name!r}: use letters, digits, "
                "dot, dash, underscore, space (max 64 chars, no leading dot)"
            )
        return name

    def get_or_create_kb(self, name: str, config: RAGConfig | None = None) -> KnowledgeBase:
        kb = self.kbs.get(name)
        if kb is None:
            self.validate_kb_name(name)
            cfg = config or self.rag_config.model_copy(update={"name": name})
            kb = self.kbs.get_or_create(name, cfg, device=self.device, mesh=self.mesh)
            # table registry + incremental manifest live under the data dir
            # so text2sql tables and skip-unchanged survive restarts
            kb.attach_persistence(self.data_dir / "kbs" / name)
            self._persist_kb_meta(name, kb.config)
            self.monitor.register(name, kb.store)
            # agent KB toolkits (kb_search et al.) resolve names through
            # the GLOBAL registry — without this, chat over an API-built
            # KB fails with "knowledge base not registered"
            GLOBAL_KB_REGISTRY.register(kb)
        return kb

    def remove_kb(self, name: str) -> bool:
        """Remove a KB everywhere it was registered: the API registry, the
        global toolkit registry, the storage monitor (a stale monitor
        row keeps the cleared index alive and reports a deleted backend),
        and its persisted state (else it resurrects on restart)."""
        removed = self.kbs.remove(name)
        GLOBAL_KB_REGISTRY.remove(name)
        self.monitor.unregister(name)
        try:
            self.validate_kb_name(name)
        except ValueError:
            return removed  # never touch disk for a name we'd never create
        for root in (self.data_dir / "kbs", self.data_dir / "snapshots"):
            d = (root / name).resolve()
            # belt and suspenders: even a validated name must resolve inside
            # its parent before rmtree
            if d.is_dir() and d.is_relative_to(root.resolve()) and d != root.resolve():
                shutil.rmtree(d, ignore_errors=True)
        return removed

    # -- KB durability across restarts -------------------------------------
    # The reference's KB list survives service restarts (DB-backed configs,
    # utu/rag/api persistent stores); here each KB writes kbs/<name>/kb.json
    # at creation, the registry rehydrates from those at startup, and a
    # default-location snapshot (snapshots/<name>) is auto-restored when
    # present. Without a snapshot the KB comes back with its table registry
    # + manifest; the next build's storage-state check reprocesses sources
    # whose chunks are missing from the empty index.

    def _persist_kb_meta(self, name: str, config: RAGConfig) -> None:
        d = self.data_dir / "kbs" / name
        d.mkdir(parents=True, exist_ok=True)
        p = d / "kb.json"
        doc: dict[str, Any] = {}
        if p.exists():  # preserve declared sources across meta rewrites
            try:
                doc = json.loads(p.read_text())
            except (OSError, json.JSONDecodeError):
                doc = {}
        doc.update({"name": name, "config": shared_config(config)})
        try:
            p.write_text(json.dumps(doc, ensure_ascii=False))
        except OSError:
            logger.exception("kb meta persist failed for %s", name)

    def _kb_meta_path(self, name: str):
        return self.data_dir / "kbs" / name / "kb.json"

    def get_kb_sources(self, name: str) -> dict[str, Any]:
        """Declared source configuration of a KB (ref: kb_source_configs
        rows behind the reference's KB configuration PUT)."""
        p = self._kb_meta_path(name)
        if p.exists():
            try:
                return json.loads(p.read_text()).get("sources") or {}
            except (OSError, json.JSONDecodeError):
                logger.exception("kb sources read failed for %s", name)
        return {}

    def set_kb_sources(self, name: str, sources: dict[str, Any]) -> None:
        p = self._kb_meta_path(name)
        doc: dict[str, Any] = {"name": name}
        if p.exists():
            try:
                doc = json.loads(p.read_text())
            except (OSError, json.JSONDecodeError):
                logger.exception("kb meta read failed for %s; rewriting", name)
        doc["sources"] = sources
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(doc, ensure_ascii=False))

    def _rehydrate_kbs(self) -> None:
        root = self.data_dir / "kbs"
        if not root.is_dir():
            return
        for kb_dir in sorted(p for p in root.iterdir() if p.is_dir()):
            meta = kb_dir / "kb.json"
            name = kb_dir.name
            cfg = self.rag_config.model_copy(update={"name": name})
            if meta.exists():
                try:
                    doc = json.loads(meta.read_text())
                    name = doc["name"]
                    cfg = RAGConfig.model_validate(doc.get("config") or {})
                except Exception:  # noqa: BLE001 - bad meta → default config
                    logger.exception("corrupt kb meta %s; using defaults", meta)
            if self.kbs.get(name) is not None:
                continue
            kb = self.kbs.get_or_create(name, cfg, device=self.device, mesh=self.mesh)
            kb.attach_persistence(meta.parent)
            self.monitor.register(name, kb.store)
            GLOBAL_KB_REGISTRY.register(kb)
            snap = self.data_dir / "snapshots" / name
            if (snap / "index.json").exists():
                try:
                    kb.load(str(snap))
                    logger.info("restored KB %s from snapshot", name)
                except Exception:  # noqa: BLE001 - missing/stale snapshot → empty KB
                    logger.exception("snapshot restore failed for %s", name)
            logger.info("rehydrated KB %s", name)

    def file_references(self, name: str) -> list[dict[str, Any]]:
        """Which knowledge bases reference an uploaded file (ref:
        minio_files.py:983-1021 check_file_references — there via the
        kb_source_configs table; here via declared source configs and
        per-KB build manifests)."""
        refs = []
        for kb_name in self.kbs.names():
            via = []
            if name in (self.get_kb_sources(kb_name).get("files") or []):
                via.append("source_config")
            kb = self.kbs.get(kb_name)
            if kb is not None and name in kb.manifest.sources:
                via.append("build_manifest")
            if via:
                refs.append({"kb": kb_name, "via": via})
        return refs

    def derived_files(self, name: str) -> list[str]:
        """Uploaded artifacts derived from ``name`` (OCR pages/layouts,
        combined markdown, chunk-level files) — matched by the
        ``derived_from`` user-metadata stamp plus the deterministic
        naming patterns of the OCR pipeline."""
        stem = Path(name).stem
        out = []
        for f in self.files.list("uploads"):
            fname = f["name"]
            if fname == name or fname.startswith(".meta"):
                continue
            meta = f.get("user_metadata") or {}
            if meta.get("derived_from") == name:
                out.append(fname)
            elif re.match(rf"page_\d+_{re.escape(stem)}_(ocr|layout)\.", fname):
                out.append(fname)
            elif fname in (f"{stem}_ocr.md", f"{stem}_chunklevel.md"):
                out.append(fname)
        return sorted(set(out))

    def new_upload(self, filename: str) -> UploadTask:
        task = UploadTask(task_id=f"up-{uuid.uuid4().hex[:12]}", filename=filename)
        self.uploads[task.task_id] = task
        return task

    def add_build_log(self, kb_name: str, status: str, detail: dict | None = None) -> dict:
        log = {
            "id": len(self.build_logs) + 1,
            "kb": kb_name,
            "status": status,
            "detail": detail or {},
            "time": time.time(),
        }
        self.build_logs.append(log)
        return log
