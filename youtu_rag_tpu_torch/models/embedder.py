"""Embedders + factory.

The port's counterpart of ``youtu_rag_tpu/models/embedder.py``:
``HashEmbedder`` on the JAX package's pure-Python path (bit-equal to it;
the JAX package's native C kernel, ``native/fasthash.c``, normalizes within
1 ulp of it), ``TorchEmbedder`` (the encoder on the card, the ``tpu``
provider's counterpart of ``TpuEmbedder``: the repo's encoder, a
``weights_dir`` with or without a WordPiece vocabulary, or a pretrained
BERT-family checkpoint, ``from_pretrained``), ``RemoteEmbedder`` (the
``openai`` and ``service`` HTTP providers), the ``CoalescingEmbedder``
wrapper, and ``EmbedderFactory``.
"""

from __future__ import annotations

import asyncio
import math
import os
import re

import numpy as np
import torch

from ..core.config import EmbeddingConfig
from ..core.types import BaseEmbedder
from ..parallel.sequence_parallel import make_sp_encoder
from ..utils.device import resolve_device, serving_attention
from ..utils.http import post_json_with_retry
from ..utils.log import get_logger
from .convert import encoder_params_from_numpy, params_to_device
from .encoder import (
    EncoderConfig,
    encode_tokens,
    init_encoder_params,
    load_encoder_config,
    load_params_npz,
)
from .pretrained import load_pretrained_encoder
from .tokenizer import HashTokenizer
from .wordpiece import WordPieceTokenizer

logger = get_logger("models.embedder")


_FNV_OFFSET = 14695981039346656037
_FNV_PRIME = 1099511628211
_MASK64 = (1 << 64) - 1
_TOKEN_RE = re.compile(r"[A-Za-z0-9_]+|[^\sA-Za-z0-9_]")


def _fnv_feat(token: bytes) -> int:
    h = _FNV_OFFSET
    for b in b"feat:" + token:
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


class HashEmbedder(BaseEmbedder):
    """Feature-hashing bag-of-words embedder (deterministic, host-only).

    Tokens (ASCII word runs lowercased; every other codepoint/symbol is a
    single token) hash via FNV-1a-64 to a dimension; vectors are
    tf-weighted (1 + log tf), L2-normalized, positive-only."""

    def __init__(self, dim: int = 512):
        self._dim = dim

    @property
    def dimension(self) -> int:
        return self._dim

    def embed_one(self, text: str) -> np.ndarray:
        counts: dict[int, int] = {}
        for m in _TOKEN_RE.finditer(text):
            tok = m.group(0)
            if tok.isascii():
                tok = tok.lower()
            h = _fnv_feat(tok.encode("utf-8")[:64])
            counts[h] = counts.get(h, 0) + 1
        vec = np.zeros(self._dim, np.float32)
        for h, c in counts.items():
            vec[h % self._dim] += np.float32(1.0) + np.float32(math.log(c))
        n = np.linalg.norm(vec)
        return vec / n if n > 0 else vec

    def embed_batch(self, texts: list[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self._dim), np.float32)
        return np.stack([self.embed_one(t) for t in texts])

    async def embed_texts(self, texts: list[str]) -> list[list[float]]:
        return self.embed_batch(texts).tolist()

    async def embed_query(self, query: str) -> list[float]:
        return self.embed_batch([query])[0].tolist()


class CoalescingEmbedder(BaseEmbedder):
    """Request-coalescing wrapper: concurrent embed calls inside a short
    window merge into ONE underlying batch dispatch (a copy of the JAX
    package's wrapper). Errors propagate to every waiter in the merged
    batch; the worker restarts if the event loop changed."""

    def __init__(self, inner: BaseEmbedder, window_ms: float = 3.0, max_batch: int = 256):
        self.inner = inner
        self.window_s = window_ms / 1e3
        self.max_batch = max_batch
        self._queue: asyncio.Queue | None = None
        self._worker: asyncio.Task | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self.stats = {"dispatches": 0, "items": 0, "max_merged": 0}

    @property
    def dimension(self) -> int | None:
        return self.inner.dimension

    def _ensure_worker(self) -> asyncio.Queue:
        loop = asyncio.get_running_loop()
        if self._queue is None or self._loop is not loop or (self._worker and self._worker.done()):
            self._queue = asyncio.Queue()
            self._loop = loop
            self._worker = loop.create_task(self._run())
        return self._queue

    async def _run(self) -> None:
        queue = self._queue
        while True:
            first = await queue.get()
            batch = [first]
            n = len(first[0])
            deadline = asyncio.get_running_loop().time() + self.window_s
            while n < self.max_batch:
                remaining = deadline - asyncio.get_running_loop().time()
                if remaining <= 0:
                    break
                try:
                    item = await asyncio.wait_for(queue.get(), remaining)
                except asyncio.TimeoutError:
                    break
                batch.append(item)
                n += len(item[0])
            texts = [t for ts, _ in batch for t in ts]
            self.stats["dispatches"] += 1
            self.stats["items"] += len(texts)
            self.stats["max_merged"] = max(self.stats["max_merged"], len(batch))
            try:
                embs = await self.inner.embed_texts(texts)
            except Exception as e:  # noqa: BLE001 - fan the failure out
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(RuntimeError(str(e)))
                continue
            off = 0
            for ts, fut in batch:
                if not fut.done():
                    fut.set_result(embs[off : off + len(ts)])
                off += len(ts)

    async def embed_texts(self, texts: list[str]) -> list[list[float]]:
        if not texts:
            return []
        queue = self._ensure_worker()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        queue.put_nowait((texts, fut))
        return await fut

    async def embed_query(self, query: str) -> list[float]:
        return (await self.embed_texts([query]))[0]


class TorchEmbedder(BaseEmbedder):
    """The encoder forward on ``device`` (``None`` → the CUDA card),
    batched with padding to power-of-two buckets: lengths from 16 up to
    ``max_len``, batches of at least 8 (``TpuEmbedder`` without its
    data-parallel mesh). Without ``params`` the encoder starts from seed 0;
    without ``tokenizer`` it tokenizes with ``HashTokenizer``.

    With ``sp_mesh`` (an int S, the shards on this device, or a
    ``torch.distributed`` process group; ``parallel/sequence_parallel.py``)
    texts longer than ``max_len`` tokens embed whole, up to
    ``long_max_len`` (default 8 × ``max_len``), through the ring-attention
    forward instead of being cut at ``max_len``."""

    def __init__(self, config: EncoderConfig | None = None, params: dict | None = None,
                 batch_size: int = 128, device: str | torch.device | None = None,
                 sp_mesh=None, long_max_len: int | None = None, tokenizer=None):
        self.device = resolve_device(device)
        # the serving default (blockwise from T = 256 on the card; shorter
        # buckets take plain attention either way)
        self.cfg = config or EncoderConfig(attention_impl=serving_attention(self.device))
        if params is None:
            params = init_encoder_params(self.cfg, torch.Generator().manual_seed(0))
        self.params = params_to_device(params, self.device)
        self.tokenizer = tokenizer or HashTokenizer(self.cfg.vocab_size, self.cfg.max_len)
        self.batch_size = batch_size
        self._sp_fwd = None
        if sp_mesh is not None:
            self._sp_fwd = make_sp_encoder(self.cfg, sp_mesh)
            self._sp_size = self._sp_fwd.ring_size
            self._long_max = long_max_len or 8 * self.cfg.max_len

    @classmethod
    def from_weights_dir(cls, weights_dir, **kwargs) -> "TorchEmbedder":
        """Serve a ``scripts/train_embedder.py`` output directory
        (``encoder_params.npz`` + ``encoder_config.json``, + ``vocab.txt``
        when the run trained a WordPiece vocabulary), such as the committed
        ``benchmarks/models/yrt_tiny_lex``, with its config as written (its
        ``attention_impl`` included)."""
        d = os.fspath(weights_dir)
        cfg = load_encoder_config(os.path.join(d, "encoder_config.json"))
        vocab = os.path.join(d, "vocab.txt")
        tokenizer = (WordPieceTokenizer(vocab, max_length=cfg.max_len)
                     if os.path.exists(vocab) else None)
        # checked against the config's shapes; keys it does not read are dropped
        params = encoder_params_from_numpy(load_params_npz(os.path.join(d, "encoder_params.npz")),
                                           cfg)
        return cls(config=cfg, params=params, tokenizer=tokenizer, **kwargs)

    @classmethod
    def from_pretrained(cls, model_dir, pooling: str | None = None,
                        dtype: torch.dtype | None = None, attention_impl: str | None = None,
                        max_len: int | None = None, **kwargs) -> "TorchEmbedder":
        """Serve a pretrained BERT-family checkpoint (bge/gte/e5 layouts: an
        HF export with config.json, model.safetensors and vocab.txt) on
        ``device``: WordPiece → the bert trunk → its pooling → L2.
        ``attention_impl`` defaults to "pallas" on CUDA (the blockwise
        kernel at T >= 256) and "xla" elsewhere; ``dtype`` to bf16."""
        device = resolve_device(kwargs.pop("device", None))
        params, cfg, tokenizer = load_pretrained_encoder(
            model_dir, pooling=pooling, dtype=dtype,
            attention_impl=attention_impl or serving_attention(device), max_len=max_len)
        return cls(config=cfg, params=encoder_params_from_numpy(params, cfg), device=device,
                   tokenizer=tokenizer, **kwargs)

    @property
    def dimension(self) -> int:
        return self.cfg.embed_dim

    @staticmethod
    def _bucket(n: int, floor: int) -> int:
        b = floor
        while b < n:
            b *= 2
        return b

    def embed_batch(self, texts: list[str]) -> np.ndarray:
        """Synchronous batched embed → [n, embed_dim] f32, L2-normalized.

        With an ``sp_mesh``, texts longer than ``max_len`` tokens detour
        through the sequence-parallel forward (whole, no truncation); the
        rows keep their order."""
        out = np.zeros((len(texts), self.dimension), np.float32)
        long_idx: list[int] = []
        if self._sp_fwd is not None:
            long_idx = [j for j, t in enumerate(texts)
                        if len(self.tokenizer.tokenize(t)) + 2 > self.cfg.max_len]
            if long_idx:
                out[long_idx] = self._embed_long([texts[j] for j in long_idx])
        is_long = set(long_idx)
        short = [(j, t) for j, t in enumerate(texts) if j not in is_long]
        for i in range(0, len(short), self.batch_size):
            chunk = short[i : i + self.batch_size]
            out[[j for j, _ in chunk]] = self._embed_short([t for _, t in chunk])
        return out

    def _embed_long(self, texts: list[str]) -> np.ndarray:
        """Ring-attention embed of over-length texts, in waves of
        ``max(batch_size // 8, 1)``: T bucketed as a power of two from
        ``16 * S``, the batch from 4 (``TpuEmbedder._embed_long``)."""
        out = np.zeros((len(texts), self.dimension), np.float32)
        step = max(self.batch_size // 8, 1)
        for i in range(0, len(texts), step):
            chunk = texts[i : i + step]
            seqs = [self.tokenizer.encode(t, self._long_max) for t in chunk]
            t_b = self._bucket(max(len(s) for s in seqs), max(16 * self._sp_size, 16))
            n_b = self._bucket(len(chunk), 4)
            ids = np.zeros((n_b, t_b), np.int32)
            mask = np.zeros((n_b, t_b), np.float32)
            for j, s in enumerate(seqs):
                ids[j, : len(s)] = s
                mask[j, : len(s)] = 1.0
            emb, _ = self._sp_fwd(self.params, torch.from_numpy(ids).to(self.device),
                                  torch.from_numpy(mask).to(self.device))
            out[i : i + len(chunk)] = emb[: len(chunk)].cpu().numpy()
        return out

    def _embed_short(self, batch: list[str]) -> np.ndarray:
        ids, mask = self.tokenizer.batch(batch)
        t_b = min(self._bucket(ids.shape[1], 16), self.cfg.max_len)
        n_b = self._bucket(len(batch), 8)
        ids_p = np.zeros((n_b, t_b), np.int32)
        mask_p = np.zeros((n_b, t_b), np.float32)
        ids_p[: len(batch), : min(ids.shape[1], t_b)] = ids[:, :t_b]
        mask_p[: len(batch), : min(mask.shape[1], t_b)] = mask[:, :t_b]
        emb, _ = encode_tokens(self.params, torch.from_numpy(ids_p).to(self.device),
                               torch.from_numpy(mask_p).to(self.device), self.cfg)
        return emb[: len(batch)].cpu().numpy()

    async def embed_texts(self, texts: list[str]) -> list[list[float]]:
        return self.embed_batch(texts).tolist()

    async def embed_query(self, query: str) -> list[float]:
        return self.embed_batch([query])[0].tolist()


class RemoteEmbedder(BaseEmbedder):
    """HTTP embedding adapter: OpenAI-compatible ``POST /embeddings`` or a
    self-hosted service's ``POST /embed`` (a copy of the JAX package's),
    with ``utils/http.py``'s retry on transient failures; batches of
    ``batch_size`` texts, ``batch_delay`` seconds apart."""

    def __init__(self, config: EmbeddingConfig):
        self.config = config
        self._dim = config.dimensions

    @property
    def dimension(self) -> int | None:
        return self._dim

    async def _post(self, path: str, payload: dict) -> dict:
        headers = {}
        if self.config.api_key:
            headers["Authorization"] = f"Bearer {self.config.api_key}"
        return await post_json_with_retry(
            self.config.base_url.rstrip("/") + path, payload, headers=headers, log=logger
        )

    async def embed_texts(self, texts: list[str]) -> list[list[float]]:
        out: list[list[float]] = []
        bs = self.config.batch_size
        for i in range(0, len(texts), bs):
            batch = texts[i : i + bs]
            if self.config.provider == "openai":
                data = await self._post("/embeddings", {"model": self.config.model, "input": batch})
                out.extend(item["embedding"] for item in data["data"])
            else:  # service
                data = await self._post("/embed", {"texts": batch})
                out.extend(data["embeddings"])
            if self.config.batch_delay and i + bs < len(texts):
                await asyncio.sleep(self.config.batch_delay)
        if out and self._dim is None:
            self._dim = len(out[0])
        return out

    async def embed_query(self, query: str) -> list[float]:
        return (await self.embed_texts([query]))[0]


class EmbedderFactory:
    """Provider dispatch (the JAX factory's). ``auto`` resolves from the
    environment: the ``service`` provider if ``YRT_EMBEDDING_URL`` /
    ``UTU_EMBEDDING_URL`` is set, else ``tpu`` (the encoder on ``device``,
    which on a host without CUDA raises unless ``device="cpu"``)."""

    @staticmethod
    def create(config: EmbeddingConfig | None = None,
               device: str | torch.device | None = None) -> BaseEmbedder:
        config = config or EmbeddingConfig()
        inner = EmbedderFactory._create_inner(config, device)
        if config.coalesce_window_ms > 0:
            return CoalescingEmbedder(
                inner, window_ms=config.coalesce_window_ms, max_batch=config.batch_size
            )
        return inner

    @staticmethod
    def _create_inner(config: EmbeddingConfig, device) -> BaseEmbedder:
        provider = config.provider
        if provider == "auto":
            url = os.environ.get("YRT_EMBEDDING_URL") or os.environ.get("UTU_EMBEDDING_URL")
            if url:
                config = config.model_copy(update={"base_url": url, "provider": "service"})
                provider = "service"
            else:
                provider = "tpu"
        if provider == "hash":
            return HashEmbedder(dim=config.dimensions or 256)
        if provider == "tpu":
            if config.pretrained_dir:
                return TorchEmbedder.from_pretrained(
                    config.pretrained_dir, batch_size=config.batch_size, device=device
                )
            if config.weights_dir:
                return TorchEmbedder.from_weights_dir(
                    config.weights_dir, batch_size=config.batch_size, device=device
                )
            return TorchEmbedder(batch_size=config.batch_size, device=device)
        if provider in ("openai", "service"):
            # the env fallbacks apply independently: a configured base_url
            # with a secret passed through the environment still sends it
            config = config.model_copy(
                update={
                    "base_url": config.base_url
                    or os.environ.get("YRT_EMBEDDING_URL")
                    or os.environ.get("UTU_EMBEDDING_URL"),
                    "api_key": config.api_key
                    or os.environ.get("YRT_EMBEDDING_API_KEY")
                    or os.environ.get("UTU_EMBEDDING_API_KEY"),
                }
            )
            if not config.base_url:
                raise ValueError(
                    f"embedding provider {provider!r} needs base_url (config) or "
                    "YRT_EMBEDDING_URL / UTU_EMBEDDING_URL in the environment"
                )
            return RemoteEmbedder(config)
        raise ValueError(f"unknown embedding provider {provider!r}")
