"""KnowledgeBase: one named collection bundling store + embedder +
retriever + builder, plus a process-wide registry.

The port's counterpart of ``youtu_rag_tpu/retrieval/kb.py``: the
retrieval path, its snapshots (``save``/``load``, the same layout as the
JAX package's) and the staged builder (``build_sources``: the ingest
agent with its table store and incremental build manifest, on disk once
``attach_persistence`` names a directory)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..core.config import RAGConfig
from ..core.types import Document, RetrievalResult
from ..ingest.builder import KnowledgeBuilder
from ..models.embedder import EmbedderFactory
from ..models.reranker import RerankerFactory
from ..utils.log import get_logger
from .context import ContextAssembler
from .retriever import HybridRetriever, VectorRetriever
from .store import TorchVectorStore, VectorStoreFactory

logger = get_logger("retrieval.kb")


class KnowledgeBase:
    """A named KB on ``device`` (``None`` → the CUDA card), or with its index
    sharded over ``mesh`` (``parallel.mesh``). On a local mesh the encoder
    provider embeds data-parallel over the same devices (the mesh's devices
    as one ``dp`` axis); a group mesh gets no data-parallel embedder, as in
    JAX (each process embeds what it is given)."""

    def __init__(self, name: str, config: RAGConfig | None = None,
                 device: str | torch.device | None = None, mesh=None):
        self.name = name
        self.config = config or RAGConfig(name=name)
        self.store: TorchVectorStore = VectorStoreFactory.create(self.config.vector_store,
                                                                 mesh=mesh, device=device)
        dp_mesh = None
        if mesh is not None and not mesh.distributed:
            from ..parallel.mesh import Mesh

            dp_mesh = Mesh(mesh.devices.reshape(-1), ("dp",))
        self.embedder = EmbedderFactory.create(self.config.knowledge_builder.embedding,
                                               device=self.store.device, mesh=dp_mesh)
        self.reranker = RerankerFactory.create(self.config.reranker, device=self.store.device)
        self.retriever = VectorRetriever(
            self.store, self.embedder, self.config.retriever, reranker=self.reranker
        )
        self.hybrid_retriever = HybridRetriever(
            self.store, self.embedder, self.config.retriever, reranker=self.reranker
        )
        self.builder = KnowledgeBuilder(self.store, self.embedder, self.config.knowledge_builder)
        self.assembler = ContextAssembler()
        # staged-builder state (made at first use; on disk once a directory
        # is attached): one TableStore and one incremental manifest per KB,
        # so table and database sources share one registry
        self._tables = None
        self._manifest = None
        self._builder_agent = None
        self._persist_dir = None

    @property
    def device(self) -> torch.device:
        return self.store.device

    # -- staged builder (ingest agent) -------------------------------------

    @property
    def tables(self):
        if self._tables is None:
            from ..ingest.tables import TableStore

            path = ":memory:"
            if self._persist_dir is not None:
                path = str(self._persist_dir / "tables.sqlite")
            self._tables = TableStore(path)
        return self._tables

    @property
    def manifest(self):
        if self._manifest is None:
            from ..index.persistence import BuildManifest

            mf = None
            if self._persist_dir is not None:
                p = self._persist_dir / "manifest.json"
                if p.exists():
                    try:
                        mf = BuildManifest.load(p)
                    except (OSError, ValueError, TypeError, AttributeError):  # corrupt manifest → full rebuild
                        logger.exception("manifest load failed; rebuilding from scratch")
            self._manifest = mf or BuildManifest()
        return self._manifest

    def attach_persistence(self, directory) -> None:
        """Give the staged-builder state a home on disk: the table registry
        becomes sqlite-backed and the incremental manifest survives
        restarts. Call before the first build."""
        self._persist_dir = Path(directory)
        self._persist_dir.mkdir(parents=True, exist_ok=True)

    @property
    def builder_agent(self):
        """The staged knowledge builder (analyze → group → parallel process
        → QA stage) over this KB's store, embedder and tables."""
        if self._builder_agent is None:
            from ..ingest.agent import KnowledgeBuilderAgent

            self._builder_agent = KnowledgeBuilderAgent(
                self.name,
                self.store,
                self.embedder,
                tables=self.tables,
                config=self.config.knowledge_builder,
                manifest=self.manifest,
            )
        return self._builder_agent

    async def build_sources(self, tasks, rebuild: bool = False, on_progress=None):
        """Build through the staged ingest agent: source tasks route to the
        text/table/database/qa processors with incremental skip; the
        manifest persists when a directory is attached."""
        from ..ingest.agent import BuildRequest

        agent = self.builder_agent
        agent.on_progress = on_progress
        try:
            report = await agent.build(
                BuildRequest(kb_name=self.name, tasks=list(tasks), rebuild=rebuild)
            )
        finally:
            agent.on_progress = None
        if self._persist_dir is not None:
            try:
                self.manifest.save(self._persist_dir / "manifest.json")
            except OSError:
                logger.exception("manifest save failed")
        await self.warmup()
        return report

    async def build_documents(self, documents: list[Document], rebuild: bool = False):
        status = await self.builder.build_from_documents(documents, rebuild=rebuild)
        await self.warmup()
        return status

    async def warmup(self) -> None:
        """Run one search (and the coalescer's common query buckets) so the
        kernel is built and loaded before the first user query. A build or
        launch failure propagates: a KB whose search path is broken must
        not report itself ready."""
        if await self.store.count() == 0:
            return
        await self.retriever.retrieve("warmup", top_k=1, similarity_threshold=0.0)
        if self.config.vector_store.coalesce_window_ms > 0:
            dim = getattr(self.embedder, "dimension", None) or self.store._dim
            for bucket in (8, 32):
                await self.store.search_batch(
                    np.zeros((bucket, dim), np.float32), top_k=self.config.retriever.top_k
                )

    async def build_files(self, paths: list[str], rebuild: bool = False):
        from ..ingest.loaders import load_document

        docs: list[Document] = []
        for p in paths:
            docs.extend(load_document(p))
        return await self.build_documents(docs, rebuild=rebuild)

    async def search(
        self,
        query: str,
        top_k: int | None = None,
        filters: dict[str, Any] | None = None,
        **kwargs,
    ) -> list[RetrievalResult]:
        return await self.retriever.retrieve(query, top_k=top_k, filters=filters, **kwargs)

    def save(self, directory: str) -> dict[str, Any]:
        """Snapshot the KB: index arrays + chunks + schema (``index.npz`` /
        ``index.json``) and ``kb.json`` with its name and config. Atomic
        per artifact."""
        from ..index.persistence import save_index

        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        if self.store._index is None:
            raise RuntimeError("empty knowledge base; nothing to snapshot")
        save_index(self.store._index, d / "index")
        tmp = d / "kb.json.tmp"
        tmp.write_text(json.dumps({"name": self.name, "config": self.config.model_dump()}))
        tmp.replace(d / "kb.json")
        return {"directory": str(d), "chunks": self.store._index.count()}

    def load(self, directory: str) -> dict[str, Any]:
        """Restore a snapshot into this KB, on the KB's own device or mesh
        (a sharded KB stays sharded; replaces current contents). The index
        keeps the snapshot's own config (its storage tier included); the
        snapshot's width must match this KB's embedder."""
        from ..index.persistence import load_index

        d = Path(directory)
        idx = load_index(d / "index", device=self.device, mesh=self.store._mesh)
        emb_dim = getattr(self.embedder, "dimension", None)
        if emb_dim and emb_dim != idx.dim:
            raise ValueError(
                f"snapshot dimension {idx.dim} != embedder dimension {emb_dim}; "
                "restore into a KB configured with the matching embedding model"
            )
        self.store._index = idx
        self.store._dim = idx.dim
        # snapshots carry no postings: repopulate BM25 from live chunks
        self.store.rebuild_lexical()
        return {"directory": str(d), "chunks": idx.count()}

    async def stats(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "chunks": await self.store.count(),
            "backend": self.config.vector_store.backend,
            "device": str(self.device),
            "embedder": type(self.embedder).__name__,
            "description": self.config.description,
            "storage_dtype": self.config.vector_store.index.storage_dtype,
        }


class KBRegistry:
    """Process-wide name → KnowledgeBase map."""

    def __init__(self):
        self._kbs: dict[str, KnowledgeBase] = {}

    def get(self, name: str) -> KnowledgeBase | None:
        return self._kbs.get(name)

    def get_or_create(self, name: str, config: RAGConfig | None = None,
                      device: str | torch.device | None = None, mesh=None) -> KnowledgeBase:
        kb = self._kbs.get(name)
        if kb is None:
            kb = KnowledgeBase(name, config, device=device, mesh=mesh)
            self._kbs[name] = kb
        return kb

    def register(self, kb: KnowledgeBase) -> None:
        self._kbs[kb.name] = kb

    def remove(self, name: str) -> bool:
        return self._kbs.pop(name, None) is not None

    def names(self) -> list[str]:
        return sorted(self._kbs)


GLOBAL_KB_REGISTRY = KBRegistry()
