"""Rerankers + factory: the port's counterpart of
``youtu_rag_tpu/models/reranker.py`` for the ``none`` and ``lexical``
providers. The cross-encoder and remote providers raise until their slice
lands (ROADMAP Queue A 8).

Contract: return results re-scored and re-ranked; ``top_k=None`` keeps
all."""

from __future__ import annotations

import math
from collections import Counter

from ..core.config import RerankerConfig
from ..core.types import BaseReranker, RetrievalResult
from .tokenizer import HashTokenizer


def _reranked(results: list[RetrievalResult], scores: list[float], top_k: int | None):
    order = sorted(range(len(results)), key=lambda i: -scores[i])
    if top_k is not None:
        order = order[:top_k]
    out = []
    for rank, i in enumerate(order):
        r = results[i]
        out.append(RetrievalResult(chunk=r.chunk, score=float(scores[i]), rank=rank + 1))
    return out


class LexicalReranker(BaseReranker):
    """BM25-style query-term scoring over the candidate set."""

    def __init__(self, k1: float = 1.5, b: float = 0.75):
        self.k1, self.b = k1, b
        self._tok = HashTokenizer(vocab_size=2**30)

    def score(self, query: str, docs: list[str]) -> list[float]:
        q_terms = set(self._tok.tokenize(query))
        doc_tokens = [self._tok.tokenize(d) for d in docs]
        n = len(docs)
        avgdl = max(sum(len(t) for t in doc_tokens) / max(n, 1), 1.0)
        df = Counter()
        for toks in doc_tokens:
            df.update(set(toks) & q_terms)
        scores = []
        for toks in doc_tokens:
            tf = Counter(toks)
            s = 0.0
            for t in q_terms:
                if tf[t] == 0:
                    continue
                idf = math.log(1.0 + (n - df[t] + 0.5) / (df[t] + 0.5))
                denom = tf[t] + self.k1 * (1 - self.b + self.b * len(toks) / avgdl)
                s += idf * tf[t] * (self.k1 + 1) / denom
            scores.append(s)
        return scores

    async def rerank(self, query, results, top_k=None):
        if not results:
            return []
        scores = self.score(query, [r.chunk.content for r in results])
        return _reranked(results, scores, top_k)


class RerankerFactory:
    """Provider dispatch: ``none`` → no reranker, ``lexical`` → BM25."""

    @staticmethod
    def create(config: RerankerConfig | None = None) -> BaseReranker | None:
        config = config or RerankerConfig()
        p = config.provider
        if p == "none":
            return None
        if p == "lexical":
            return LexicalReranker()
        raise NotImplementedError(
            f"reranker provider {p!r} is not ported yet (ROADMAP Queue A 8); "
            "use 'none' or 'lexical'"
        )
