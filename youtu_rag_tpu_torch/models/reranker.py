"""Rerankers + factory: the port's counterpart of
``youtu_rag_tpu/models/reranker.py``.

- ``TorchReranker``: the cross-encoder on the card (``TpuReranker``'s
  counterpart): query/document pairs through the encoder trunk, the CLS
  state through the score head, batched in power-of-two buckets; seeded
  (the repo's trunk) or ``from_pretrained`` (a BERT-family
  sequence-classification checkpoint);
- ``LexicalReranker``: BM25-style token-overlap scoring on the host;
- ``RemoteReranker``: a Jina-style ``POST /rerank`` HTTP adapter.

Contract: return results re-scored and re-ranked; ``top_k=None`` keeps
all."""

from __future__ import annotations

import math
import os
from collections import Counter

import numpy as np
import torch

from ..core.config import RerankerConfig
from ..core.types import BaseReranker, RetrievalResult
from ..utils.device import resolve_device, serving_attention
from ..utils.http import post_json_with_retry
from ..utils.log import get_logger
from .convert import encoder_params_from_numpy, params_to_device
from .encoder import EncoderConfig, init_encoder_params, rerank_scores
from .pretrained import load_pretrained_encoder
from .tokenizer import HashTokenizer

logger = get_logger("models.reranker")


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


class TorchReranker(BaseReranker):
    """The cross-encoder forward on ``device`` (``None`` → the CUDA card).
    Without ``params`` the trunk starts from ``seed`` (through a
    ``torch.Generator``: the JAX package's shapes and scales, not its
    values); without ``config`` it is the default ``EncoderConfig`` with
    the kernels on the card ("pallas") and plain attention elsewhere."""

    def __init__(self, config: EncoderConfig | None = None, params: dict | None = None,
                 batch_size: int = 64, seed: int = 0, tokenizer=None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.cfg = config or EncoderConfig(attention_impl=serving_attention(self.device))
        if params is None:
            params = init_encoder_params(self.cfg, torch.Generator().manual_seed(seed))
        self.params = params_to_device(params, self.device)
        self.tokenizer = tokenizer or HashTokenizer(self.cfg.vocab_size, self.cfg.max_len)
        self.batch_size = batch_size

    @classmethod
    def from_pretrained(cls, model_dir, dtype: torch.dtype | None = None,
                        attention_impl: str | None = None, max_len: int | None = None,
                        **kwargs) -> "TorchReranker":
        """Serve a pretrained BERT-family cross-encoder (a bge-reranker-style
        ``BertForSequenceClassification`` export with 1 or 2 labels) on
        ``device``. ``attention_impl`` defaults to "pallas" on CUDA and
        "xla" elsewhere; a checkpoint without a classifier head raises."""
        device = resolve_device(kwargs.pop("device", None))
        params, cfg, tokenizer = load_pretrained_encoder(
            model_dir, dtype=dtype, attention_impl=attention_impl or serving_attention(device),
            max_len=max_len)
        if "score_head" not in params:
            raise ValueError(
                f"{model_dir} has no classifier head — an embedding model, "
                "not a reranker checkpoint?"
            )
        return cls(config=cfg, params=encoder_params_from_numpy(params, cfg), device=device,
                   tokenizer=tokenizer, **kwargs)

    def _bucket(self, batch: list[str], query: str):
        """(ids, mask, type ids) of the pairs, padded as ``TpuReranker``
        pads them: T a power of two from 16 (at most ``max_len``), the batch
        one from 8; token type 1 after the first [SEP] where the tokenizer
        has one."""
        seqs = [self.tokenizer.encode_pair(query, d) for d in batch]
        t = 16
        while t < max(len(s) for s in seqs):
            t *= 2
        t = min(t, self.cfg.max_len)
        nb = 8
        while nb < len(batch):
            nb *= 2
        ids = np.zeros((nb, t), np.int32)
        mask = np.zeros((nb, t), np.float32)
        types = np.zeros((nb, t), np.int32)
        sep = getattr(self.tokenizer, "sep_id", None)
        for j, s in enumerate(seqs):
            s = s[:t]
            ids[j, : len(s)] = s
            mask[j, : len(s)] = 1.0
            if sep is not None and sep in s:
                types[j, s.index(sep) + 1 : len(s)] = 1
        return ids, mask, types

    def score(self, query: str, docs: list[str]) -> list[float]:
        scores: list[float] = []
        for i in range(0, len(docs), self.batch_size):
            batch = docs[i : i + self.batch_size]
            ids, mask, types = (torch.from_numpy(a).to(self.device)
                                for a in self._bucket(batch, query))
            out = rerank_scores(self.params, ids, mask, self.cfg, type_ids=types)
            scores.extend(out[: len(batch)].cpu().tolist())
        return scores

    async def rerank(self, query, results, top_k=None):
        if not results:
            return []
        scores = self.score(query, [r.chunk.content for r in results])
        return _reranked(results, scores, top_k)


class RemoteReranker(BaseReranker):
    """Jina-style ``POST /rerank`` adapter (a copy of the JAX package's).

    ``top_field`` names the vendor's result-count field: ``top_n`` for
    Jina/OpenAI-style services, ``top_k`` for TIONE; both answer
    ``{"results": [{"index", "relevance_score"}]}``. An index outside the
    results is ignored, not trusted."""

    def __init__(self, config: RerankerConfig, top_field: str = "top_n"):
        self.config = config
        self.top_field = top_field

    async def rerank(self, query, results, top_k=None):
        if not results:
            return []
        headers = {}
        if self.config.api_key:
            headers["Authorization"] = f"Bearer {self.config.api_key}"
        payload = {
            "model": self.config.model,
            "query": query,
            "documents": [r.chunk.content for r in results],
            self.top_field: top_k or len(results),
        }
        data = await post_json_with_retry(
            self.config.base_url.rstrip("/") + "/rerank", payload, headers=headers, log=logger
        )
        scores = [0.0] * len(results)
        for item in data.get("results", []):
            idx = item.get("index")
            # an out-of-range index must not crash the rerank, nor
            # mis-assign through negative indexing
            if isinstance(idx, int) and 0 <= idx < len(results):
                scores[idx] = item.get("relevance_score", 0.0)
            else:
                logger.warning("reranker returned invalid index %r; ignored", idx)
        return _reranked(results, scores, top_k)


class RerankerFactory:
    """Provider dispatch (the JAX factory's): ``none`` → no reranker,
    ``lexical`` → BM25, ``tpu`` → ``TorchReranker(**kwargs)`` on ``device``,
    the remote providers → ``RemoteReranker`` (``base_url`` and
    ``api_key`` fall back to ``YRT_RERANKER_URL`` / ``UTU_RERANKER_URL``
    and ``YRT_RERANKER_API_KEY`` / ``UTU_RERANKER_API_KEY``)."""

    @staticmethod
    def create(config: RerankerConfig | None = None, device: str | torch.device | None = None,
               **kwargs) -> BaseReranker | None:
        config = config or RerankerConfig()
        p = config.provider
        if p == "none":
            return None
        if p == "lexical":
            return LexicalReranker()
        if p == "tpu":
            return TorchReranker(device=device, **kwargs)
        if p in ("openai", "service", "jina", "tione"):
            # the env fallbacks apply independently: a configured base_url
            # with a secret passed through the environment still sends it
            config = config.model_copy(
                update={
                    "base_url": config.base_url
                    or os.environ.get("YRT_RERANKER_URL")
                    or os.environ.get("UTU_RERANKER_URL"),
                    "api_key": config.api_key
                    or os.environ.get("YRT_RERANKER_API_KEY")
                    or os.environ.get("UTU_RERANKER_API_KEY"),
                }
            )
            if not config.base_url:
                raise ValueError(
                    f"reranker provider {p!r} needs base_url (config) or "
                    "YRT_RERANKER_URL / UTU_RERANKER_URL in the environment"
                )
            return RemoteReranker(config, top_field="top_k" if p == "tione" else "top_n")
        raise ValueError(f"unknown reranker provider {p!r}")
