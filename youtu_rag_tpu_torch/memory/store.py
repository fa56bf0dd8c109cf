"""Memory vector store on the port's device index: a copy of
``youtu_rag_tpu/memory/store.py``.

All memories share ONE device index; user, type, session, importance,
``created_at`` and category are metadata columns. A memory read is one
filtered search: the partition mask folds into the scan's bias, so a
cross-type read (``retrieve_all_context``) is one batched kernel launch
(``topk_pruned`` on a bf16 CUDA index) rather than a query per type.

Memory types: working (session-scoped turn log), episodic (past
conversations), semantic (distilled facts), procedural (skills with
success stats). The store lives on ``device`` (``None`` → the CUDA card;
a host without one raises, as ``TorchVectorStore`` does)."""

from __future__ import annotations

import math
import time
import uuid
from dataclasses import dataclass, field
from typing import Any

import torch

from ..core.config import IndexConfig, VectorStoreConfig
from ..core.types import BaseEmbedder, Chunk
from ..retrieval.store import TorchVectorStore
from ..utils.log import get_logger

logger = get_logger("memory.store")

MEMORY_TYPES = ("working", "episodic", "semantic", "procedural")


@dataclass
class MemoryNode:
    id: str
    user_id: str
    memory_type: str  # working | episodic | semantic | procedural
    content: str
    importance: float = 0.5
    created_at: float = field(default_factory=time.time)
    session_id: str = ""
    success_count: int = 0
    use_count: int = 0
    metadata: dict[str, Any] = field(default_factory=dict)

    @property
    def success_rate(self) -> float:
        return self.success_count / self.use_count if self.use_count else 0.0

    @staticmethod
    def new(user_id: str, memory_type: str, content: str, **kwargs) -> "MemoryNode":
        assert memory_type in MEMORY_TYPES, memory_type
        return MemoryNode(
            id=f"mem-{uuid.uuid4().hex[:16]}",
            user_id=user_id,
            memory_type=memory_type,
            content=content,
            **kwargs,
        )


class MemoryVectorStore:
    """Single-index memory store with metadata-partitioned memory types."""

    def __init__(self, embedder: BaseEmbedder, config: VectorStoreConfig | None = None,
                 device: str | torch.device | None = None):
        self.embedder = embedder
        cfg = config or VectorStoreConfig(
            collection_name="memory",
            index=IndexConfig(min_capacity=4096, block_rows=1024, max_metadata_columns=8),
        )
        self.store = TorchVectorStore(cfg, device=device)
        self._nodes: dict[str, MemoryNode] = {}

    # -- writes ------------------------------------------------------------

    async def add(self, node: MemoryNode) -> str:
        emb = await self.embedder.embed_query(node.content)
        meta = {
            "user_id": node.user_id,
            "memory_type": node.memory_type,
            "session_id": node.session_id,
            "importance": node.importance,
            "created_at": int(node.created_at),
        }
        if node.metadata.get("category"):
            # filterable category partition (schema | sql_pattern | ...):
            # the text2sql memories of ref memory_toolkit.py:1540-1590
            meta["category"] = node.metadata["category"]
        chunk = Chunk(
            id=node.id,
            document_id=f"{node.user_id}/{node.memory_type}",
            content=node.content,
            chunk_index=0,
            metadata=meta,
            embedding=emb,
        )
        await self.store.add_chunks([chunk])
        self._nodes[node.id] = node
        return node.id

    async def update(
        self,
        memory_id: str,
        content: str | None = None,
        importance: float | None = None,
        metadata: dict[str, Any] | None = None,
    ) -> bool:
        """In-place memory edit (ref update_memory): content changes
        re-embed via delete-then-reinsert under the same id."""
        node = self._nodes.get(memory_id)
        if node is None:
            return False
        content_changed = content is not None and content != node.content
        if content is not None:
            node.content = content
        if importance is not None:
            node.importance = max(0.0, min(1.0, importance))
        if metadata:
            node.metadata.update(metadata)
        if content_changed:
            await self.add(node)  # same id → index tombstones the old row
        else:
            # importance/metadata-only edits: in-place device metadata
            # update — no re-embed, no tombstone churn
            meta = {
                "user_id": node.user_id,
                "memory_type": node.memory_type,
                "session_id": node.session_id,
                "importance": node.importance,
                "created_at": int(node.created_at),
            }
            if node.metadata.get("category"):
                meta["category"] = node.metadata["category"]
            await self.store.update_metadata([memory_id], [meta])
        return True

    async def delete(self, memory_ids: list[str]) -> int:
        await self.store.delete(memory_ids)
        n = 0
        for mid in memory_ids:
            if self._nodes.pop(mid, None) is not None:
                n += 1
        return n

    def get(self, memory_id: str) -> MemoryNode | None:
        return self._nodes.get(memory_id)

    async def clear_user(self, user_id: str) -> int:
        ids = [m.id for m in self._nodes.values() if m.user_id == user_id]
        return await self.delete(ids)

    # -- reads -------------------------------------------------------------

    async def search_memories(
        self,
        user_id: str,
        query: str,
        memory_types: list[str] | None = None,
        top_k: int = 5,
        min_importance: float = 0.0,
        min_success_rate: float | None = None,
        recency_half_life_s: float = 7 * 86400.0,
        importance_weight: float = 0.2,
        recency_weight: float = 0.2,
        category: str | None = None,
    ) -> list[tuple[MemoryNode, float]]:
        """Similarity + importance + recency scoring
        (ref: memory_toolkit.py:840-932). One fused filtered search."""
        filters: dict[str, Any] = {"user_id": user_id}
        types = memory_types or ["episodic", "semantic", "procedural"]
        filters["memory_type"] = {"$in": list(types)}
        if min_importance > 0:
            filters["importance"] = {"$gte": min_importance}
        if category is not None:
            filters["category"] = category

        emb = await self.embedder.embed_query(query)
        hits = await self.store.search(emb, top_k=top_k * 3, filters=filters)

        now = time.time()
        scored: list[tuple[MemoryNode, float]] = []
        for chunk, sim in hits:
            node = self._nodes.get(chunk.id)
            if node is None:
                continue
            if min_success_rate is not None and node.memory_type == "procedural":
                # grace period mirrors cleanup_procedural's min_uses: a
                # single bad outcome must not permanently bury a skill
                if node.use_count >= 3 and node.success_rate < min_success_rate:
                    continue
            age = max(now - node.created_at, 0.0)
            recency = math.exp(-age * math.log(2) / recency_half_life_s)
            score = (
                (1 - importance_weight - recency_weight) * sim
                + importance_weight * node.importance
                + recency_weight * recency
            )
            scored.append((node, score))
        scored.sort(key=lambda x: -x[1])
        return scored[:top_k]

    async def get_working_memory(
        self, user_id: str, session_id: str, last_n: int = 10
    ) -> list[MemoryNode]:
        """Session-ordered recent turns (ref: memory_store.py:426-477)."""
        nodes = [
            m
            for m in self._nodes.values()
            if m.user_id == user_id and m.memory_type == "working" and m.session_id == session_id
        ]
        nodes.sort(key=lambda m: m.created_at)
        return nodes[-last_n:]

    def list_nodes(
        self,
        user_id: str | None = None,
        memory_types: list[str] | None = None,
        limit: int = 100,
        offset: int = 0,
    ) -> tuple[list[MemoryNode], int]:
        """Newest-first browse (no embedding) → (page, total_matching).

        The management surface behind the API/SPA memory browser — the
        reference only exposes memories through retrieval + an export
        script (``tests/rag/export_memory_data.py``); a list view needs no
        vector search."""
        nodes = [
            m
            for m in self._nodes.values()
            if (user_id is None or m.user_id == user_id)
            and (memory_types is None or m.memory_type in memory_types)
        ]
        nodes.sort(key=lambda m: -m.created_at)
        return nodes[offset : offset + limit], len(nodes)

    def stats(self, user_id: str | None = None) -> dict[str, int]:
        out = {t: 0 for t in MEMORY_TYPES}
        for m in self._nodes.values():
            if user_id is None or m.user_id == user_id:
                out[m.memory_type] += 1
        out["total"] = sum(out[t] for t in MEMORY_TYPES)
        return out

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> int:
        """Serialize all memory nodes (incl. skill usage stats) to JSON.
        Embeddings are recomputed on load — node text is the source of
        truth, so saved files survive embedder upgrades."""
        import json
        from dataclasses import asdict
        from pathlib import Path as _P

        data = [asdict(m) for m in self._nodes.values()]
        p = _P(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(data, ensure_ascii=False))
        return len(data)

    async def load(self, path: str) -> int:
        """Re-hydrate nodes from a save() file (additive; same ids upsert)."""
        import json
        from pathlib import Path as _P

        p = _P(path)
        if not p.exists():
            return 0
        n = 0
        for item in json.loads(p.read_text()):
            await self.add(MemoryNode(**item))
            n += 1
        return n

    async def cleanup_procedural(
        self, user_id: str, min_success_rate: float = 0.3, min_uses: int = 3
    ) -> int:
        """Drop skills that keep failing (ref: memory_toolkit.py:1777-1850)."""
        victims = [
            m.id
            for m in self._nodes.values()
            if m.user_id == user_id
            and m.memory_type == "procedural"
            and m.use_count >= min_uses
            and m.success_rate < min_success_rate
        ]
        return await self.delete(victims)
