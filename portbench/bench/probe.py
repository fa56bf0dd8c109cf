"""What the harness records around the program, from its own side: the
outputs the check needs (every run), and in a traced run the spans,
host timers, coalescer counts, encoder forwards, index scans and attention
calls that the per-layer metrics read, with a device trace of one early
steady stretch of the window.

Each wrapper delegates to the program's object and changes nothing it
returns. The forward, scan and attention spies stand in for a module's
attribute for the traced run only, as a test double does, under the
wrapped function's name (the index's kernel loader looks a wrapper up by
it); they read shapes and keep device tensors, so they add no
synchronisation."""

from __future__ import annotations

import contextvars
import functools
import time
from collections import defaultdict

import torch

REQUEST: contextvars.ContextVar = contextvars.ContextVar("portbench_request", default=None)


class Record:
    """Per-request outputs of the sampled requests (``want(i)``), and the
    traced run's readings."""

    def __init__(self, want):
        self.want = want
        self.emb: dict[int, list[float]] = {}
        self.candidates: dict[int, list] = {}
        self.results: dict[int, list] = {}
        self.traced = False
        self.in_window = False
        self.in_profile = False
        # host-clock readings, each with its start (``time.perf_counter``)
        self.spans: dict[str, list[tuple]] = defaultdict(list)  # (start, ms)
        self.rerank_s: list[tuple] = []  # (start, seconds)
        self.embed_calls: list[tuple] = []  # (start, end)
        self.forwards: list[tuple] = []  # (start, B, T, each row's tokens: a device tensor)
        # (start, kind, rows or the plan's n_valid, bytes a row, block rows, profiled)
        self.scans: list[tuple] = []
        # (B, H, T, Tkv, hd, bytes an element) of the profiled stretch
        self.attn: list[tuple] = []


class Embedder:
    """Stands in for the retriever's (or the builder's) embedder."""

    def __init__(self, inner, rec: Record):
        self.inner, self.rec = inner, rec

    def __getattr__(self, name):
        return getattr(self.inner, name)

    async def embed_texts(self, texts):
        rec = self.rec
        t = time.perf_counter()
        if rec.traced:
            with torch.profiler.record_function("portbench/embed"):
                out = await self.inner.embed_texts(texts)
        else:
            out = await self.inner.embed_texts(texts)
        if rec.in_window:
            rec.embed_calls.append((t, time.perf_counter()))
        i = REQUEST.get()
        if i is not None and rec.want(i):
            rec.emb[i] = out[0]
        return out


class Reranker:
    """Stands in for the retriever's cross-encoder."""

    def __init__(self, inner, rec: Record):
        self.inner, self.rec = inner, rec

    def __getattr__(self, name):
        return getattr(self.inner, name)

    async def rerank(self, query, results, top_k=None):
        rec = self.rec
        i = REQUEST.get()
        if i is not None and rec.want(i):
            rec.candidates[i] = [(r.chunk.id, r.chunk.content, float(r.score)) for r in results]
        t = time.perf_counter()
        if rec.traced:
            with torch.profiler.record_function("portbench/rerank"):
                out = await self.inner.rerank(query, results, top_k=top_k)
        else:
            out = await self.inner.rerank(query, results, top_k=top_k)
        if rec.in_window:
            rec.rerank_s.append((t, time.perf_counter() - t))
        return out


class SpanSink:
    """A tracer processor keeping the window's spans: their start on the
    harness's clock (the tracer's is ``time.time``) and duration."""

    def __init__(self, rec: Record):
        self.rec = rec

    def on_span_end(self, span) -> None:
        if self.rec.in_window:
            ms = span.duration_ms
            self.rec.spans[f"{span.kind}/{span.name}"].append(
                (time.perf_counter() - ms / 1e3, ms))


class Patch:
    """Replaces module attributes while active; restores them after."""

    def __init__(self):
        self.saved: list[tuple] = []

    def set(self, module, name: str, value) -> None:
        self.saved.append((module, name, getattr(module, name)))
        setattr(module, name, value)

    def restore(self) -> None:
        for module, name, value in reversed(self.saved):
            setattr(module, name, value)
        self.saved.clear()


def install_spies(rec: Record, index) -> Patch:
    """The traced run's spies on the encoder's forwards, the index's scans
    and the attention kernel's calls."""
    import youtu_rag_tpu_torch.index.device_index as di
    import youtu_rag_tpu_torch.models.embedder as emb
    import youtu_rag_tpu_torch.models.encoder as enc

    patch = Patch()

    def forward_spy(fn):
        @functools.wraps(fn)
        def spy(params, token_ids, mask, *a, **kw):
            if rec.in_window:
                rec.forwards.append((time.perf_counter(), token_ids.shape[0],
                                     token_ids.shape[1], mask.sum(1)))
            return fn(params, token_ids, mask, *a, **kw)
        return spy

    patch.set(emb, "encode_tokens", forward_spy(emb.encode_tokens))
    # rerank_scores calls encode_tokens through the encoder module
    patch.set(enc, "encode_tokens", forward_spy(enc.encode_tokens))

    def brute_spy(fn, row_bytes):
        @functools.wraps(fn)
        def spy(queries, x, *a, **kw):
            if rec.in_window:
                rec.scans.append((time.perf_counter(), "brute", index.live_count, row_bytes, 1,
                                  rec.in_profile))
            return fn(queries, x, *a, **kw)
        return spy

    d = index.d_pad
    patch.set(di, "topk_pruned", brute_spy(di.topk_pruned, 2 * d + 4))
    patch.set(di, "topk_int8_pruned", brute_spy(di.topk_int8_pruned, d + 8))

    def ivf_spy(fn, row_bytes):
        @functools.wraps(fn)
        def spy(queries, x, *a, block_rows, **kw):
            n_valid = a[-2]
            if rec.in_window:
                rec.scans.append((time.perf_counter(), "ivf", n_valid.clone(), row_bytes,
                                  block_rows, rec.in_profile))
            return fn(queries, x, *a, block_rows=block_rows, **kw)
        return spy

    patch.set(di, "ivf_topk_dma", ivf_spy(di.ivf_topk_dma, 2 * d + 4))
    patch.set(di, "ivf_topk_int8_dma", ivf_spy(di.ivf_topk_int8_dma, d + 8))

    def attn_spy(fn):
        @functools.wraps(fn)
        def spy(q, k, v, bias, *a, **kw):
            if rec.in_profile:
                b, h, t, hd = q.shape
                rec.attn.append((b, h, t, k.shape[2], hd, q.element_size()))
            return fn(q, k, v, bias, *a, **kw)
        return spy

    patch.set(enc, "blockwise_attention", attn_spy(enc.blockwise_attention))
    patch.set(enc, "flash_attention", attn_spy(enc.flash_attention))
    return patch


def coalescer_stats(kb) -> dict:
    """The embedder's and the store's coalescer counts (zeros where a
    coalescer is off)."""
    emb = getattr(kb.embedder, "stats", None) or {}
    co = kb.store._search_coalescer
    search = co.stats if co is not None else {}
    return {"embed_dispatches": emb.get("dispatches", 0), "embed_items": emb.get("items", 0),
            "search_dispatches": search.get("dispatches", 0),
            "search_queries": search.get("queries", 0)}


def read_trace(prof, t0_us: float, t1_us: float) -> dict:
    """Kernels' device seconds by name, the busy seconds (the union of
    kernel intervals), the longest idle gaps labelled by the harness's
    host annotation that covers them, inside [t0, t1] of the profiler's
    clock (microseconds)."""
    kernels, notes = [], []
    for e in prof.events():
        tr = e.time_range
        if e.name.startswith("portbench/"):
            # the harness's annotations show on the device's timeline too
            if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
                notes.append((tr.start, tr.end, e.name[len("portbench/"):]))
        elif getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            kernels.append((tr.start, tr.end, e.name))
    kernels = [(max(a, t0_us), min(b, t1_us), n) for a, b, n in kernels if b > t0_us and a < t1_us]
    kernels.sort()
    by_name: dict[str, float] = defaultdict(float)
    busy, gaps, cur_end = 0.0, [], t0_us
    for a, b, n in kernels:
        by_name[n] += (b - a) / 1e6
        if a > cur_end:
            gaps.append((cur_end, a))
        if b > cur_end:
            busy += b - max(a, cur_end)
            cur_end = b
    if t1_us > cur_end:
        gaps.append((cur_end, t1_us))
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = []
    for a, b in gaps[:10]:
        mid = (a + b) / 2
        cover = [n for s, e, n in notes if s <= mid <= e]
        labelled.append([cover[-1] if cover else "host outside the program's calls",
                         (b - a) / 1e6])
    return {"by_name": dict(by_name), "busy_s": busy / 1e6, "window_s": (t1_us - t0_us) / 1e6,
            "idle_gaps": labelled}
