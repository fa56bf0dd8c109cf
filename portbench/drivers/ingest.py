"""Document uploads (``"kind": "ingest"``): ``uploaders`` callers of
``KnowledgeBase.build_documents``, back to back, ``docs_per_call`` new
documents a call. Document ``j`` is drawn from ``(seed, j)`` when its call
is sent: paragraphs of a pool drawn in set-up (``doc``'s
``paragraphs`` of ``paragraph_chars``), to a lognormal length (``doc``'s
``median_chars``, ``sigma``, ``max_chars``). ``warmup_calls`` calls of
other documents warm up; the index has room for ``reserve_rows`` more rows
than the KB starts with, so no tier growth falls in the window.

End-to-end: ``ingest_chunks_per_s``, the chunks whose document was stored
(chunked, embedded, added to the index and to BM25) inside the window,
over the window. Calls in flight at the close finish and are checked."""

from __future__ import annotations

import asyncio
import time

import numpy as np
import torch

from portbench.bench import drive, judge, probe, textgen

CHECK_MAX = 64  # chunks whose rows and BM25 terms are judged a run


def documents(fx, paras: list[str], first: int, n: int, seed_tag: int, prefix: str):
    from youtu_rag_tpu_torch.core.types import Document

    d = fx.traffic["doc"]
    out = []
    for j in range(first, first + n):
        rng = np.random.default_rng([fx.seed, seed_tag, j])
        out.append(Document(id=f"{prefix}{j}", metadata={}, content=textgen.document(
            paras, rng, d["median_chars"], d["sigma"], int(d["max_chars"]))))
    return out


class _TimedStore:
    """Stands in for the builder's store: times each document's
    ``add_chunks`` (chunks stored, with their end time)."""

    def __init__(self, inner, log: list):
        self.inner, self.log = inner, log

    def __getattr__(self, name):
        return getattr(self.inner, name)

    async def add_chunks(self, chunks):
        await self.inner.add_chunks(chunks)
        self.log.append((time.perf_counter(), len(chunks)))


async def run(fx, win: drive.Window, rec: probe.Record) -> dict:
    kb = fx.kb
    t = fx.traffic
    per = int(t["docs_per_call"])
    d = t["doc"]
    paras = textgen.paragraphs(fx.lex, np.random.default_rng([fx.seed, 2]), int(d["paragraphs"]),
                               int(d["paragraph_chars"][0]), int(d["paragraph_chars"][1]))
    warm = documents(fx, paras, 0, per * int(t["warmup_calls"]), 4, "warm-")
    inner = getattr(kb.embedder, "inner", kb.embedder)
    texts = [p for doc in warm for p in doc.content.split("\n\n")]
    for n in (8, 16, 32, 64, 128) if fx.device.type == "cuda" else ():
        for chars in (600, 1000):
            inner.embed_batch([textgen.cut(x, chars) for x in texts[:n]])
    for i in range(0, len(warm), per):
        await kb.build_documents(warm[i:i + per])
    stored: list[tuple] = []
    kb.builder.store = _TimedStore(kb.builder.store, stored)
    kb.builder.embedder = probe.Embedder(kb.builder.embedder, rec)
    calls: list[tuple] = []
    tasks = win.open(rec)

    async def uploader(u: int, n_up: int):
        j = u
        while time.perf_counter() < win.end:
            batch = documents(fx, paras, j * per, per, 3, "doc-")
            t0 = time.perf_counter()
            status = await kb.build_documents(batch)
            calls.append((batch, t0, time.perf_counter(), status))
            j += n_up

    n_up = int(t["uploaders"])
    await asyncio.gather(*(uploader(u, n_up) for u in range(n_up)))
    for task in tasks:
        await task
    rec.in_window = False
    return {"calls": calls, "stored": stored, "per": per}


def metrics(raw: dict, win: drive.Window) -> dict[str, float]:
    n = sum(c for t, c in raw["stored"] if t <= win.end)
    if not n:
        raise RuntimeError("no chunk stored inside the window")
    return {"ingest_chunks_per_s": n / win.seconds}


def counts(raw: dict) -> tuple[int, int]:
    """(attempted, failed): documents sent in the calls that finished, and
    those the builder did not process."""
    sent = len(raw["calls"]) * raw["per"]
    return sent, sum(s.total_documents - s.processed_documents for *_, s in raw["calls"])


def check(cell, fx, rec, raw, seed: int, control: bool):
    """The numbers of ``judge.ingest_numbers`` over every document of the
    calls that finished; with ``control``, the control's rows in place of
    the stored ones."""
    docs = [doc for batch, *_ in raw["calls"] for doc in batch]
    store = fx.kb.store
    nums = judge.ingest_numbers(fx, docs, store.index, store._lexical, CHECK_MAX)
    ctl = None
    if control:
        ref = judge.Reference(fx, "fp8")
        size, overlap = fx.chunking
        texts = [x for doc in docs for x in judge.chunker.split(doc.content, size, overlap)]
        pick = judge.sample_ids(list(range(len(texts))), {j: len(x) for j, x in enumerate(texts)},
                                fx.seed, CHECK_MAX)
        rows = ref.embed([texts[j] for j in pick])
        ctl = judge.ingest_numbers(fx, docs, store.index, None, CHECK_MAX, stored_rows=rows)
    if fx.device.type == "cuda":
        torch.cuda.synchronize()
    return nums, ctl
