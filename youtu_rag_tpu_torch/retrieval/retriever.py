"""Retrievers: embed → fused device search → threshold → rerank.

Semantics parity with ``utu/rag/knowledge_retrieval/base_retriever.py:14-155``:
- recall 2× top_k when reranking is enabled, then cut to top_k;
- similarity_threshold <= 0 disables filtering;
- ranks are 1-based on the final ordering.
Batched: ``batch_retrieve`` embeds all queries in one batch and runs one
fused kernel launch (the reference loops ``retrieve`` sequentially,
base_retriever.py:82-99)."""

from __future__ import annotations

import time
from typing import Any

import numpy as np

from ..core.config import RetrieverConfig
from ..core.types import BaseEmbedder, BaseReranker, BaseRetriever, RetrievalResult
from ..utils.log import get_logger
from .store import TorchVectorStore

logger = get_logger("retrieval.retriever")


class VectorRetriever(BaseRetriever):
    def __init__(
        self,
        vector_store: TorchVectorStore,
        embedder: BaseEmbedder,
        config: RetrieverConfig | None = None,
        reranker: BaseReranker | None = None,
    ):
        self.store = vector_store
        self.embedder = embedder
        self.config = config or RetrieverConfig()
        self.reranker = reranker

    async def retrieve(
        self,
        query: str,
        top_k: int | None = None,
        filters: dict[str, Any] | None = None,
        enable_reranking: bool | None = None,
        similarity_threshold: float | None = None,
        **kwargs,
    ) -> list[RetrievalResult]:
        return (
            await self.batch_retrieve(
                [query],
                top_k=top_k,
                filters=filters,
                enable_reranking=enable_reranking,
                similarity_threshold=similarity_threshold,
                **kwargs,
            )
        )[0]

    async def batch_retrieve(
        self,
        queries: list[str],
        top_k: int | None = None,
        filters: dict[str, Any] | None = None,
        enable_reranking: bool | None = None,
        similarity_threshold: float | None = None,
        **kwargs,
    ) -> list[list[RetrievalResult]]:
        t0 = time.perf_counter()
        top_k = top_k or self.config.top_k
        rerank = (
            enable_reranking
            if enable_reranking is not None
            else (self.config.enable_reranking and self.reranker is not None)
        )
        threshold = (
            similarity_threshold
            if similarity_threshold is not None
            else self.config.similarity_threshold
        )
        metric = getattr(self.store.config, "distance_metric", "cosine")
        if threshold > 0 and metric not in ("cosine",):
            # l2 scores are 2q·x − ||x||² and ip is unbounded — a [0,1]
            # similarity threshold would drop results arbitrarily
            logger.warning(
                "similarity_threshold ignored for metric %r (scores are not similarities)",
                metric,
            )
            threshold = 0.0
        fetch_k = top_k * 2 if rerank else top_k

        from ..tracing.tracer import get_tracer

        tracer = get_tracer()
        with tracer.span("embedding", "embed_queries", n=len(queries)):
            embs = np.asarray(await self.embedder.embed_texts(queries), np.float32)
        with tracer.span(
            "retrieval", "vector_search", n=len(queries), top_k=fetch_k,
            filtered=bool(filters),
        ) as search_span:
            hit_lists = await self.store.search_batch(embs, top_k=fetch_k, filters=filters)
            search_span.attributes["hits"] = sum(len(h) for h in hit_lists)

        out: list[list[RetrievalResult]] = []
        for qi, hits in enumerate(hit_lists):
            results = [
                RetrievalResult(chunk=c, score=s, rank=i + 1)
                for i, (c, s) in enumerate(hits)
                if threshold <= 0 or s >= threshold
            ]
            if rerank and results and self.reranker is not None:
                results = await self.reranker.rerank(queries[qi], results, top_k=top_k)
            else:
                results = results[:top_k]
                for i, r in enumerate(results):
                    r.rank = i + 1
            out.append(results)
        logger.debug(
            "retrieved %d queries in %.1f ms", len(queries), (time.perf_counter() - t0) * 1e3
        )
        return out


class HybridRetriever(VectorRetriever):
    """Dense + lexical fusion via reciprocal rank fusion.

    The reference's HybridRetriever is an unimplemented stub that delegates
    to dense (base_retriever.py:102-139, 'TODO BM25 fusion'); here the
    fusion is real and **corpus-level**: the lexical list comes from the
    store's BM25 inverted index over the whole collection
    (retrieval/lexical.py), so exact-term evidence recalls chunks the
    dense encoder missed entirely — the Sequential-NIAH failure mode.
    When the store was built with ``lexical_index`` off, fusion degrades
    to BM25 re-scoring of the dense candidate pool (the old behavior,
    only able to reorder what dense already found)."""

    def __init__(self, *args, rrf_k: int = 60, fusion_pool: int = 50, **kwargs):
        super().__init__(*args, **kwargs)
        from ..models.reranker import LexicalReranker

        self.rrf_k = rrf_k
        self.fusion_pool = fusion_pool
        self._lexical = LexicalReranker()

    async def batch_retrieve(
        self,
        queries,
        top_k=None,
        filters=None,
        enable_reranking=None,
        similarity_threshold=None,
        hybrid_alpha=None,
        **kwargs,
    ):
        top_k = top_k or self.config.top_k
        rerank = (
            enable_reranking
            if enable_reranking is not None
            else (self.config.enable_reranking and self.reranker is not None)
        )
        threshold = (
            similarity_threshold
            if similarity_threshold is not None
            else self.config.similarity_threshold
        )
        pool = max(self.fusion_pool, top_k)
        # threshold applies on the DENSE similarity before fusion — RRF
        # values are rank artifacts (~1/rrf_k), not similarities
        dense_lists = await super().batch_retrieve(
            queries, top_k=pool, filters=filters, enable_reranking=False,
            similarity_threshold=threshold,
        )
        corpus_lexical = getattr(self.store, "_lexical", None) is not None
        out = []
        for query, dense in zip(queries, dense_lists):
            chunk_by_id = {r.chunk.id: r.chunk for r in dense}
            dense_score = {r.chunk.id: r.score for r in dense}
            rare_hits: list = []
            if corpus_lexical:
                # union candidates: corpus BM25 top hits ∪ dense pool, all
                # scored with corpus df/avgdl — one consistent lexical
                # ranking, so dense candidates keep their lexical credit
                # and exact-term chunks dense missed still enter. The
                # bundle does ONE tokenize + postings walk per query
                # (hits, full score map, and rare-term matches together).
                corpus_hits, lex_score_map, rare_hits = (
                    await self.store.lexical_search_bundle(
                        query, top_k=pool, filters=filters,
                        rare_limit=max(1, top_k // 3),
                    )
                )
                lex_scores = {
                    cid: s
                    for cid in dense_score
                    if (s := lex_score_map.get(cid, 0.0)) > 0
                }
                for chunk, s in corpus_hits:
                    if threshold > 0 and chunk.id not in dense_score:
                        # an explicit similarity_threshold is a *dense*
                        # confidence gate: honor it by not admitting
                        # chunks dense never vouched for (threshold<=0 —
                        # the default — keeps full corpus-level fusion)
                        continue
                    chunk_by_id.setdefault(chunk.id, chunk)
                    lex_scores[chunk.id] = s
                lex_hits = sorted(
                    ((cid, s) for cid, s in lex_scores.items() if s > 0),
                    key=lambda kv: (-kv[1], kv[0]),
                )[:pool]
            else:
                # pool-rescore fallback: rank the dense candidates by BM25
                scores = self._lexical.score(query, [r.chunk.content for r in dense])
                lex_hits = [
                    (dense[i].chunk.id, scores[i])
                    for i in sorted(range(len(dense)), key=lambda i: -scores[i])
                    if scores[i] > 0
                ]
            if not dense and not lex_hits:
                out.append([])
                continue
            # weighted RRF over the two ranked lists, keyed by chunk id
            alpha = (
                hybrid_alpha
                if hybrid_alpha is not None
                else getattr(self.config, "hybrid_alpha", 0.5)
            )
            rrf: dict[str, float] = {}
            for i, r in enumerate(dense):  # the dense list IS its ranking
                rrf[r.chunk.id] = rrf.get(r.chunk.id, 0.0) + alpha / (self.rrf_k + i + 1)
            max_lex = lex_hits[0][1] if lex_hits else 1.0
            lex_norm = {}
            for rank, (cid, s) in enumerate(lex_hits):
                rrf[cid] = rrf.get(cid, 0.0) + (1 - alpha) / (self.rrf_k + rank + 1)
                lex_norm[cid] = s / max(max_lex, 1e-9)
            order = sorted(rrf, key=lambda cid: -rrf[cid])[:top_k]
            if corpus_lexical and threshold <= 0:
                # exact-identifier guarantee: chunks matching a near-unique
                # query term (an ID/code the user typed) get reserved
                # slots — fusion noise can never evict an exact match
                in_order = set(order)
                missing = [(c, s) for c, s in rare_hits if c.id not in in_order]
                for chunk, s in missing:
                    chunk_by_id.setdefault(chunk.id, chunk)
                    lex_norm.setdefault(chunk.id, min(1.0, s / max(max_lex, 1e-9)))
                if missing:
                    keep = top_k - len(missing)
                    order = order[:keep] + [c.id for c, _ in missing]
            # RRF orders; the reported score stays in a [0,1]-ish scale so
            # downstream confidence cutoffs keep working: dense similarity
            # when the chunk came from dense, normalized BM25 otherwise
            results = [
                RetrievalResult(
                    chunk=chunk_by_id[cid],
                    score=dense_score.get(cid, lex_norm.get(cid, 0.0)),
                    rank=rank + 1,
                )
                for rank, cid in enumerate(order)
            ]
            if rerank and results and self.reranker is not None:
                results = await self.reranker.rerank(query, results, top_k=top_k)
            out.append(results)
        return out
