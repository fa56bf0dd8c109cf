"""Cleanup manager: remove every artifact of a source across stores.

A copy of ``youtu_rag_tpu/ingest/cleanup.py`` over the port's store.

Parity with ``utu/rag/knowledge_builder/cleanup_manager.py:21-789``:
per-source cleanup spans table vectors, column vectors, content/summary
chunks, structured SQLite tables, and QA associations; whole-KB cleanup
drops everything. One fused store (vectors carry index_type/element_type
metadata) makes this two calls instead of the reference's three-store
sweep."""

from __future__ import annotations

from pathlib import Path
from typing import Any

from ..index.persistence import BuildManifest
from ..retrieval.store import TorchVectorStore
from ..utils.log import get_logger
from .tables import TableStore

logger = get_logger("ingest.cleanup")


class KnowledgeCleanupManager:
    def __init__(
        self,
        kb_name: str,
        store: TorchVectorStore,
        tables: TableStore,
        manifest: BuildManifest | None = None,
    ):
        self.kb_name = kb_name
        self.store = store
        self.tables = tables
        self.manifest = manifest

    async def cleanup_source(self, source_id: str) -> dict[str, Any]:
        """Remove all vectors + tables + manifest state for one source.

        Path-style source ids store their chunks under the file BASENAME
        (the loader doc-id convention; see agent._existing_chunks) — both
        forms are deleted so a configured path actually cleans up."""
        deleted_chunks = await self.store.delete_by_document_id(source_id)
        base = Path(source_id).name
        if base != source_id:
            deleted_chunks += await self.store.delete_by_document_id(base)
        dropped = []
        for table in self.tables.tables_for_source(self.kb_name, source_id):
            if self.tables.drop_table(self.kb_name, table):
                dropped.append(table)
        if self.manifest is not None:
            self.manifest.forget(source_id)
        result = {
            "source": source_id,
            "deleted_chunks": deleted_chunks,
            "dropped_tables": dropped,
        }
        logger.info("cleanup: %s", result)
        return result

    async def cleanup_removed_sources(
        self, current_source_ids: list[str], keep=None
    ) -> list[dict[str, Any]]:
        """Diff configured sources vs indexed documents and clean leftovers
        (ref: KBConfigService.cleanup_removed_sources). ``keep(source_id)``
        exempts sources the configuration does not manage (e.g. QA pairs
        minted by the qa-pairs route, which are never in the config's id
        set and would otherwise be swept by every config save)."""
        current = set(current_source_ids)
        # path-style source ids index their chunks under the basename —
        # count both forms as "still configured" or live sources whose
        # id is a path would be deleted as removed
        current |= {Path(s).name for s in current_source_ids}
        indexed: set[str] = set()
        if self.store._index is not None:
            for c in self.store._index.iter_live():
                indexed.add(c.document_id)
        for row in self.tables.tables_for_kb(self.kb_name):
            indexed.add(row["source"])
        removed = sorted(
            s for s in indexed - current if not (keep is not None and keep(s))
        )
        return [await self.cleanup_source(s) for s in removed]

    async def cleanup_knowledge_base(self) -> dict[str, Any]:
        """Drop the whole KB (ref: cleanup_knowledge_base)."""
        n = await self.store.count()
        await self.store.clear()
        dropped = []
        for row in self.tables.tables_for_kb(self.kb_name):
            if self.tables.drop_table(self.kb_name, row["table_name"]):
                dropped.append(row["table_name"])
        if self.manifest is not None:
            self.manifest.sources.clear()
        return {"kb": self.kb_name, "deleted_chunks": n, "dropped_tables": dropped}
