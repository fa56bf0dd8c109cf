"""Retrieval-quality evaluation: the metric suite behind the reference's
metadata-retrieval benchmark tables (Recall@all / NDCG_w@5,
``README.md:816-882``) plus standard recall@k / MRR, runnable against any
KnowledgeBase + qrels.

Qrels format (jsonl or list of dicts):
  {"query": "...", "relevant": ["doc_id", ...], "filters": {...}?}
Relevance is judged at the document level (a retrieved chunk counts if its
``document_id`` is relevant), matching how the reference scores
file-discovery quality.

The port's copy of ``youtu_rag_tpu/eval/retrieval_eval.py``.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from ..utils.log import get_logger

logger = get_logger("eval.retrieval")


def recall_at_k(retrieved: list[str], relevant: set[str], k: int | None = None) -> float:
    """|relevant ∩ retrieved@k| / |relevant|. k=None → Recall@all
    (over everything retrieved), the reference's headline recall."""
    if not relevant:
        return 0.0
    pool = retrieved if k is None else retrieved[:k]
    return len(set(pool) & relevant) / len(relevant)


def mrr(retrieved: list[str], relevant: set[str]) -> float:
    for i, doc in enumerate(retrieved):
        if doc in relevant:
            return 1.0 / (i + 1)
    return 0.0


def ndcg_weighted_at_k(retrieved: list[str], relevant: set[str], k: int = 5) -> float:
    """Weighted NDCG@k (binary gains, log2 position discount) — NDCG_w@5 in
    the reference's tables."""
    if not relevant:
        return 0.0
    dcg = 0.0
    for i, doc in enumerate(retrieved[:k]):
        if doc in relevant:
            dcg += 1.0 / math.log2(i + 2)
    ideal = sum(1.0 / math.log2(i + 2) for i in range(min(len(relevant), k)))
    return dcg / ideal if ideal > 0 else 0.0


@dataclass
class RetrievalSample:
    query: str
    relevant: set[str]
    filters: dict[str, Any] | None = None
    retrieved: list[str] = field(default_factory=list)


class RetrievalBenchmark:
    """Run qrels through a KnowledgeBase retriever and aggregate metrics."""

    def __init__(
        self, kb, top_k: int = 15, ndcg_k: int = 5, use_hybrid: bool = False, retrieve_fn=None
    ):
        self.kb = kb
        self.top_k = top_k
        self.ndcg_k = ndcg_k
        self.use_hybrid = use_hybrid
        # optional custom path: async (query, filters, top_k) -> results —
        # lets toolkit-level strategies (e.g. popularity-preference blending)
        # run under the same metric suite
        self.retrieve_fn = retrieve_fn

    @staticmethod
    def load_qrels(source: str | Path | list[dict]) -> list[RetrievalSample]:
        if isinstance(source, (str, Path)):
            rows = [
                json.loads(line)
                for line in Path(source).read_text().strip().split("\n")
                if line.strip()
            ]
        else:
            rows = source
        return [
            RetrievalSample(
                query=r["query"], relevant=set(r["relevant"]), filters=r.get("filters")
            )
            for r in rows
        ]

    async def run(self, samples: list[RetrievalSample]) -> dict[str, Any]:
        if self.retrieve_fn is not None:
            for s in samples:
                results = await self.retrieve_fn(s.query, s.filters, self.top_k)
                s.retrieved = _dedup([r.chunk.document_id for r in results])
            return self._aggregate(samples)
        retriever = self.kb.hybrid_retriever if self.use_hybrid else self.kb.retriever
        # engine-native batching: all plain queries in one fused launch
        plain = [s for s in samples if not s.filters]
        filtered = [s for s in samples if s.filters]
        if plain:
            result_lists = await retriever.batch_retrieve(
                [s.query for s in plain], top_k=self.top_k, similarity_threshold=0.0
            )
            for s, results in zip(plain, result_lists):
                s.retrieved = _dedup([r.chunk.document_id for r in results])
        for s in filtered:
            results = await retriever.retrieve(
                s.query, top_k=self.top_k, filters=s.filters, similarity_threshold=0.0
            )
            s.retrieved = _dedup([r.chunk.document_id for r in results])
        return self._aggregate(samples)

    def _aggregate(self, samples: list[RetrievalSample]) -> dict[str, Any]:
        n = len(samples)
        if n == 0:
            return {"samples": 0, "top_k": self.top_k}
        report = {
            "samples": n,
            "top_k": self.top_k,
            "recall_at_all": sum(recall_at_k(s.retrieved, s.relevant) for s in samples) / n,
            f"recall_at_{self.ndcg_k}": sum(
                recall_at_k(s.retrieved, s.relevant, self.ndcg_k) for s in samples
            )
            / n,
            f"ndcg_w_at_{self.ndcg_k}": sum(
                ndcg_weighted_at_k(s.retrieved, s.relevant, self.ndcg_k) for s in samples
            )
            / n,
            "mrr": sum(mrr(s.retrieved, s.relevant) for s in samples) / n,
        }
        logger.info("retrieval eval: %s", report)
        return report


def _dedup(docs: list[str]) -> list[str]:
    return list(dict.fromkeys(docs))
