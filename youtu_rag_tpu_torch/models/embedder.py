"""Embedders + factory.

The port's counterpart of ``youtu_rag_tpu/models/embedder.py``:
``HashEmbedder`` on the JAX package's pure-Python path (bit-equal to it;
the JAX package's native C kernel, ``native/fasthash.c``, normalizes within
1 ulp of it), ``TorchEmbedder`` (the encoder on the card, the ``tpu``
provider's counterpart of ``TpuEmbedder``), the ``CoalescingEmbedder``
wrapper, and ``EmbedderFactory``. Pretrained BERT-family checkpoints
(``pretrained_dir``), WordPiece vocabularies and the remote providers raise
until their slice lands (ROADMAP Queue A 8).
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
from ..utils.device import resolve_device
from .convert import encoder_params_from_numpy
from .encoder import (
    EncoderConfig,
    encode_tokens,
    init_encoder_params,
    load_encoder_config,
    load_params_npz,
)
from ..parallel.sequence_parallel import make_sp_encoder
from .tokenizer import HashTokenizer


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
    data-parallel mesh). Without ``params`` the encoder starts from seed 0.

    With ``sp_mesh`` (an int S, the shards on this device, or a
    ``torch.distributed`` process group; ``parallel/sequence_parallel.py``)
    texts longer than ``max_len`` tokens embed whole, up to
    ``long_max_len`` (default 8 × ``max_len``), through the ring-attention
    forward instead of being cut at ``max_len``."""

    def __init__(self, config: EncoderConfig | None = None, params: dict | None = None,
                 batch_size: int = 128, device: str | torch.device | None = None,
                 sp_mesh=None, long_max_len: int | None = None):
        self.device = resolve_device(device)
        # the serving default: the kernels on the card (blockwise from T =
        # 256; shorter buckets take plain attention either way), plain
        # attention elsewhere, as TpuEmbedder picks Pallas on a TPU only
        self.cfg = config or EncoderConfig(
            attention_impl="pallas" if self.device.type == "cuda" else "xla")
        if params is None:
            params = init_encoder_params(self.cfg, torch.Generator().manual_seed(0))
        self.params = _to_device(params, self.device)
        self.tokenizer = HashTokenizer(self.cfg.vocab_size, self.cfg.max_len)
        self.batch_size = batch_size
        self._sp_fwd = None
        if sp_mesh is not None:
            self._sp_fwd = make_sp_encoder(self.cfg, sp_mesh)
            self._sp_size = self._sp_fwd.ring_size
            self._long_max = long_max_len or 8 * self.cfg.max_len

    @classmethod
    def from_weights_dir(cls, weights_dir, **kwargs) -> "TorchEmbedder":
        """Serve a ``scripts/train_embedder.py`` output directory
        (``encoder_params.npz`` + ``encoder_config.json``), such as the
        committed ``benchmarks/models/yrt_tiny_lex``, with its config as
        written (its ``attention_impl`` included)."""
        d = os.fspath(weights_dir)
        if os.path.exists(os.path.join(d, "vocab.txt")):
            raise NotImplementedError(
                f"{d} has a vocab.txt: WordPiece tokenization is not ported yet "
                "(ROADMAP Queue A 8)"
            )
        cfg = load_encoder_config(os.path.join(d, "encoder_config.json"))
        # checked against the config's shapes; keys it does not read are dropped
        params = encoder_params_from_numpy(load_params_npz(os.path.join(d, "encoder_params.npz")),
                                           cfg)
        return cls(config=cfg, params=params, **kwargs)

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


def _to_device(tree: dict, device: torch.device) -> dict:
    return {k: _to_device(v, device) if isinstance(v, dict) else v.to(device, torch.float32)
            for k, v in tree.items()}


class EmbedderFactory:
    """Provider dispatch (the JAX factory's). ``hash`` and ``tpu`` (the
    encoder on ``device``, or a ``weights_dir``) are served;
    ``pretrained_dir``, ``auto`` and the remote providers raise until their
    slice lands."""

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
        if provider == "hash":
            return HashEmbedder(dim=config.dimensions or 256)
        if provider == "tpu" and not config.pretrained_dir:
            if config.weights_dir:
                return TorchEmbedder.from_weights_dir(
                    config.weights_dir, batch_size=config.batch_size, device=device
                )
            return TorchEmbedder(batch_size=config.batch_size, device=device)
        what = ("pretrained_dir (BERT-family checkpoints)" if provider == "tpu"
                else f"provider {provider!r}")
        raise NotImplementedError(
            f"embedding {what} is not ported yet (ROADMAP Queue A 8); "
            "use provider='hash' or 'tpu' with the repo's encoder"
        )
