"""Closed-loop questions (``"kind": "qa"``): ``sessions`` agents, each
asking a question through the KB's ``VectorRetriever.retrieve``, waiting
for its top-k and asking the next. Questions are spans of the pool's texts
(``textgen.questions``, lengths from the mix's ``question``), drawn from
the seed in one sequence that the sessions share in arrival order.
``rerank`` says whether the retriever reranks; every ``check_every``-th
question is recorded for the check.

End-to-end: ``queries_per_s``, the questions that finished inside the
window over it, and ``query_p95_ms``, the 95th percentile of their send to
reply times. Questions in flight at the close finish and are checked, but
do not count."""

from __future__ import annotations

import asyncio
import gc
import time

import numpy as np
import torch

from portbench.bench import drive, judge, probe, textgen

QUESTIONS = 65536  # the pool the sessions cycle through, drawn in set-up
CHECK_MAX = 64  # questions judged a run, the longest among them
WARMUP_S = 2.0  # the warm pass of the real traffic, at most a tenth of the window


def question_stream(fx, seed_tag: int, n: int) -> list[str]:
    q = fx.traffic["question"]
    return textgen.questions(fx.words, np.random.default_rng([fx.seed, seed_tag]), n,
                             q["median_words"], q["sigma"], q["max_words"], q["min_words"])


async def warm(fx, questions: list[str], seconds: float) -> None:
    """Every shape the questions reach on the card (a CPU run has no kernel
    to warm): the embedder's batch and length buckets, the store's query
    buckets at the fetch k, the cross-encoder's pair batch at T 256 and
    512; then a pass of the real traffic."""
    kb = fx.kb
    top_k = kb.config.retriever.top_k
    fetch_k = 2 * top_k if fx.rerank else top_k
    inner = getattr(kb.embedder, "inner", kb.embedder)
    by_len = sorted(questions, key=len)
    for n in (1, 8, 16, 32, 64, 128) if fx.device.type == "cuda" else ():
        if n > inner.batch_size:
            break
        for at in (0.0, 0.3, 0.7, 0.95, 1.0):
            first = min(int(at * len(by_len)), len(by_len) - n)
            inner.embed_batch(by_len[first:first + n])
    dim = inner.dimension
    n = 1
    while n <= 64:
        kb.store.index.search(np.ones((n, dim), np.float32), top_k=fetch_k)
        n *= 2
    if fx.rerank:
        from youtu_rag_tpu_torch.core.types import Chunk, RetrievalResult

        for text in (fx.texts[0][:400], fx.texts[0]):
            hits = [RetrievalResult(Chunk(f"w{j}", "w", text, 0), 0.0) for j in range(fetch_k)]
            await kb.retriever.reranker.rerank(by_len[-1], hits, top_k=top_k)
    await kb.warmup()
    await _sessions(fx, questions, None, time.perf_counter() + seconds, None)
    if fx.device.type == "cuda":
        torch.cuda.synchronize()


async def prepare(fx, win: drive.Window, rec: probe.Record) -> list[str]:
    """Set-up of a question mix: the sample to record, the questions, the
    warm-up, and the harness's wrappers around the retriever's embedder and
    cross-encoder; returns the questions."""
    kb = fx.kb
    every = int(fx.traffic["check_every"])
    rec.want = lambda i: i % every == fx.seed % every
    questions = question_stream(fx, 3, QUESTIONS)
    await warm(fx, question_stream(fx, 2, 4096), min(WARMUP_S, win.seconds / 10))
    kb.retriever.embedder = probe.Embedder(kb.retriever.embedder, rec)
    if fx.rerank:
        kb.retriever.reranker = probe.Reranker(kb.retriever.reranker, rec)
    return questions


async def ask(fx, rec: probe.Record | None, question: str, i: int) -> list:
    """Question ``i`` through the retriever; records its results where the
    check samples it."""
    token = probe.REQUEST.set(i if rec is not None else None)
    try:
        res = await fx.kb.retriever.retrieve(question)
    finally:
        probe.REQUEST.reset(token)
    if rec is not None and rec.want(i):
        rec.results[i] = [(r.chunk.id, r.chunk.content, float(r.score)) for r in res]
    return res


async def _sessions(fx, questions, rec, end: float, lat: list | None) -> int:
    """Runs the sessions until ``end``; returns the questions issued."""
    next_i = [0]

    async def session():
        while time.perf_counter() < end:
            i = next_i[0]
            next_i[0] += 1
            t = time.perf_counter()
            await ask(fx, rec, questions[i % len(questions)], i)
            if lat is not None:
                lat.append((i, t, time.perf_counter()))

    await asyncio.gather(*(session() for _ in range(int(fx.traffic["sessions"]))))
    return next_i[0]


async def run(fx, win: drive.Window, rec: probe.Record) -> dict:
    kb = fx.kb
    questions = await prepare(fx, win, rec)
    lat: list[tuple] = []
    before = probe.coalescer_stats(kb)
    win.on_host_from = lambda: before.update(probe.coalescer_stats(kb))
    tasks = win.open(rec)
    issued = await _sessions(fx, questions, rec, win.end, lat)
    for t in tasks:
        await t
    after = probe.coalescer_stats(kb)
    return {"latencies": lat, "questions": questions, "issued": issued,
            "coalescers": {k: after[k] - before[k] for k in after}}


def finished(raw: dict, win: drive.Window) -> list[float]:
    """Send-to-reply seconds of every question that finished inside the
    window."""
    return [t2 - t for _, t, t2 in raw["latencies"] if t2 <= win.end]


def metrics(raw: dict, win: drive.Window) -> dict[str, float]:
    """The questions that finished inside the window: their count over the
    window, and the 95th percentile of their latencies."""
    done = finished(raw, win)
    if not done:
        raise RuntimeError("no question finished inside the window")
    return {"queries_per_s": len(done) / win.seconds,
            "query_p95_ms": float(np.percentile(done, 95)) * 1e3}


def counts(raw: dict) -> tuple[int, int]:
    """(attempted, failed): questions asked, and those never answered."""
    return raw["issued"], raw["issued"] - len(raw["latencies"])


def check(cell, fx, rec, raw, seed: int, control: bool):
    """The numbers of ``judge.qa_numbers`` over a seeded sample of the
    finished questions, worked out after the program's KB is freed; and,
    with ``control``, the control's on the same sample."""
    questions = raw["questions"]
    done = sorted(i for i, _, _ in raw["latencies"] if rec.want(i))
    lengths = {i: len(questions[i % len(questions)]) for i in done}
    served = [judge.Served(questions[i % len(questions)],
                           np.asarray(rec.emb[i], np.float32) if i in rec.emb else None,
                           rec.candidates.get(i, []), rec.results.get(i, []))
              for i in judge.sample_ids(done, lengths, seed, CHECK_MAX)]
    if fx.rerank:
        asyncio.run(_program_scores(fx, served))
    missing = sum(s.emb is None for s in served)
    served = [s for s in served if s.emb is not None]
    fx.kb = None
    gc.collect()
    if fx.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = judge.Reference(fx)
    nums = judge.qa_numbers(fx, served, ref)
    nums["missing"] += missing
    ctl = None
    if control:
        ctl = judge.qa_numbers(fx, judge.qa_control(fx, served, judge.Reference(fx, "fp8")), ref)
    return nums, ctl


async def _program_scores(fx, served: list) -> None:
    """The program's cross-encoder scores of every candidate of each
    sampled question (``Served.scores``): its public ``rerank`` with no
    cut, on the candidates as the timed path handed them over, so the
    check sees the scores of those the cut left out."""
    from youtu_rag_tpu_torch.core.types import Chunk, RetrievalResult

    reranker = getattr(fx.kb.retriever.reranker, "inner", fx.kb.retriever.reranker)
    for s in served:
        if not s.candidates:
            continue
        hits = [RetrievalResult(Chunk(cid, "", text, 0), sc) for cid, text, sc in s.candidates]
        out = await reranker.rerank(s.question, hits, top_k=None)
        s.scores = {r.chunk.id: float(r.score) for r in out}
