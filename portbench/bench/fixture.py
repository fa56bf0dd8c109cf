"""A cell's set-up from the seed: the texts, the checkpoints, the program's
knowledge base on the device and the rows it starts with.

The KB is the program's own ``KnowledgeBase``, built from the
configuration's profile (``rag``), with the embedder loaded by
``TorchEmbedder.from_pretrained`` through ``pretrained_dir`` and, where
the cell reranks, the cross-encoder by ``TorchReranker.from_pretrained``.
Its starting rows are clustered unit vectors made on the device: row ``i``
lies around centre ``i mod n_centres`` and holds the text of chunk ``(i
mod n_centres + 17 * (i div n_centres)) mod n_texts``, so the rows of one
cluster hold different texts. The centres are the plain reference's
embeddings of question-like spans of the pool's texts: a checkpoint with
random weights puts a text and the spans of it nowhere near each other,
so centres from spans are what puts the clusters where questions land.
The rows enter through the index's bulk ``add`` in large slices with
light ``Chunk`` records."""

from __future__ import annotations

import os
import shutil
import time

import numpy as np
import torch

from ..reference.bert import Bert
from ..reference.wordpiece import Tokenizer
from . import textgen, weights

TEXT_STRIDE = 17  # coprime to any power of two: the texts of a cluster differ


class Fixture:
    """What the harness holds beside the program: the inputs it made and
    the program's KB. ``split`` is the set-up's seconds by step."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str, tmp: str):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        self.split: dict[str, float] = {}
        self.tmp = tmp
        kb_cfg = cfg["kb"]
        self.n_rows = int(kb_cfg["rows"])
        self.n_centres = int(kb_cfg["centres"])
        self.spread = float(kb_cfg["spread"])
        self.slice_rows = int(kb_cfg["slice_rows"])
        self.tier = cfg["rag"]["vector_store"]["index"]["storage_dtype"]
        self.rerank = bool(traffic.get("rerank", False))

    # -- steps ---------------------------------------------------------------

    def _timed(self, name: str, t0: float) -> float:
        t = time.perf_counter()
        self.split[name] = self.split.get(name, 0.0) + t - t0
        return t

    def build(self) -> "Fixture":
        t = time.perf_counter()
        from youtu_rag_tpu_torch.core.config import RAGConfig
        from youtu_rag_tpu_torch.models.reranker import TorchReranker
        from youtu_rag_tpu_torch.retrieval.kb import KnowledgeBase

        t = self._timed("libraries", t)
        self.lex = textgen.Lexicon()
        rng = np.random.default_rng(self.seed)
        kb_cfg = self.cfg["kb"]
        self.texts = textgen.pool_texts(self.lex, rng, int(kb_cfg["texts"]),
                                        int(kb_cfg["chunk_chars"]))
        self.words = [p.split() for p in self.texts]
        self.tok = Tokenizer(self.lex.vocab)
        t = self._timed("texts", t)

        wseed = self.seed * 4 + 1
        self.emb_flat, self.emb_lay = weights.make(self.cfg["embedder"], False, wseed, self.device,
                                                   float(self.cfg["weights"]["std"]))
        emb_dir = os.path.join(self.tmp, "embedder")
        weights.write(emb_dir, self.cfg["embedder"], self.emb_flat, self.emb_lay, self.lex.vocab,
                      head=False, pooling=self.cfg["embedder"].get("pooling", "cls"))
        rag = RAGConfig.model_validate(_with_dir(self.cfg["rag"], emb_dir))
        self.kb = KnowledgeBase(self.cfg["name"], config=rag, device=self.device)
        self.kb_top_k = rag.retriever.top_k
        ch = rag.knowledge_builder.chunking
        self.chunking = (ch.chunk_size, ch.chunk_overlap)
        self.ce_flat = None
        if self.rerank:
            self.ce_flat, self.ce_lay = weights.make(self.cfg["reranker"], True, wseed + 2,
                                                     self.device, float(self.cfg["weights"]["std"]))
            ce_dir = os.path.join(self.tmp, "reranker")
            weights.write(ce_dir, self.cfg["reranker"], self.ce_flat, self.ce_lay,
                          self.lex.vocab, head=True)
            ce = TorchReranker.from_pretrained(ce_dir, device=self.device)
            self.kb.reranker = ce
            self.kb.retriever.reranker = ce
        shutil.rmtree(self.tmp, ignore_errors=True)
        t = self._timed("checkpoints", t)

        self.centres = self._centres(np.random.default_rng([self.seed, 1]))
        self._fill()
        t = self._timed("rows", t)
        if kb_cfg.get("ivf"):
            self.kb.store.index.build_ivf(seed=self.seed % (2**31))
            t = self._timed("ivf", t)
        # the benchmark's weights wait on the host until the check
        self.emb_flat = self.emb_flat.cpu()
        if self.ce_flat is not None:
            self.ce_flat = self.ce_flat.cpu()
        return self

    def _centres(self, rng: np.random.Generator) -> torch.Tensor:
        """The plain reference's embeddings of ``n_centres`` spans, f32."""
        q = self.traffic.get("question", {"median_words": 12, "sigma": 0.5, "min_words": 3,
                                          "max_words": 60})
        spans = textgen.questions(self.words, rng, self.n_centres, q["median_words"],
                                  q["sigma"], q["max_words"], q["min_words"])
        ref = Bert(weights.state(self.emb_flat, self.emb_lay), self.cfg["embedder"], self.device)
        out = ref.embed([self.tok.encode(s) for s in spans], block=256)
        del ref
        return out

    def row_ids_text(self, i: int) -> int:
        c, j = i % self.n_centres, i // self.n_centres
        return (c + TEXT_STRIDE * j) % len(self.texts)

    def rows(self, start: int, n: int) -> torch.Tensor:
        """Unit rows ``start .. start + n - 1`` [n, d] f32 on the device;
        ``start`` a multiple of ``slice_rows``, ``n`` at most it. The same
        seed gives the same rows, in any order of calls."""
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed * 1_000_003 + start // self.slice_rows) % (2**63))
        d = self.centres.shape[1]
        noise = torch.randn((n, d), generator=g, device=self.device) / np.sqrt(d)
        ids = torch.arange(start, start + n, device=self.device) % self.n_centres
        return torch.nn.functional.normalize(self.centres[ids] + self.spread * noise, dim=1)

    def slices(self):
        for start in range(0, self.n_rows, self.slice_rows):
            yield start, self.rows(start, min(self.slice_rows, self.n_rows - start))

    def _fill(self) -> None:
        from youtu_rag_tpu_torch.core.types import Chunk

        store = self.kb.store
        store._ensure_index(self.centres.shape[1])
        reserve = self.n_rows + int(self.traffic.get("reserve_rows", 0))
        store.index.reserve(reserve)
        texts = self.texts
        for start, x in self.slices():
            chunks = [Chunk(f"r{i}", f"d{i}", texts[self.row_ids_text(i)], 0)
                      for i in range(start, start + x.shape[0])]
            store.index.add(chunks, x.cpu().numpy())


def _with_dir(rag: dict, emb_dir: str) -> dict:
    out = dict(rag)
    kb = dict(out["knowledge_builder"])
    kb["embedding"] = dict(kb["embedding"], pretrained_dir=emb_dir)
    out["knowledge_builder"] = kb
    return out
