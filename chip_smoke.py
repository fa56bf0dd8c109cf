#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (youtu_rag_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--seed 0]

Phases; any failure exits non-zero before the result lines:
  1. environment: the card's name and power limit, torch and CUDA versions;
     fails without a CUDA device;
  2. build: compiles the path's three kernels from csrc/ at once (one nvcc
     per source) and prints each build's time and ptxas' register and
     spill report;
  3. kernel vs plain: each kernel against its plain PyTorch version on the
     card, over the shapes and edge cases of KERNEL_CASES (k up to 1024):
     bf16 within TOL, int8 and int4 bit-equal on the same quantized tensors;
  4. main path, small corpus: about 20 markdown files through the port's
     KnowledgeBase (hash embedder → device index → kernel → retrievers)
     as three KBs, one per storage tier (bf16, int8, int4), each checked
     for the intended top documents and against the same KB on the CPU;
     the int4 hybrid query asks its kernel for k = 256; the int4 KB is
     then saved and loaded into a fresh CUDA KB, which answers the same;
  5. main path, full size: 1,048,576 × 768 cosine indexes of each tier
     filled through ``add`` from one set of seeded vectors, searched with
     q = 8, top_k = 10 (int4 asks its kernel for 64 candidates and
     re-ranks them on the host), checked against the plain versions on the
     same device tensors, and timed with CUDA events beside their bounds,
     the plain versions and a one-call PyTorch yardstick where one exists;
  6. one JSON line, {"kernels": [{"name": ..., "route", "source",
     "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
     "bound_by", "library_ms"}, ...]}: one entry per kernel;
  7. the last line: {"ok": true, "device": {...}}.

The main path's launch counts are set to 0 just before phases 4 and 5
drive it and read just after; launches made to compare or time a kernel
are not counted.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

TOL = 1e-4  # bf16: unit vectors, f32 sums in another order than cuBLAS
ROWS = 1 << 20  # the full-size indexes: 1,048,576 × 768
HBM_PEAK = {"sxm": 3.35e12, "pcie": 2.0e12}  # bytes/s, NVIDIA data sheets
BF16_PEAK = {"sxm": 989e12, "pcie": 756e12}  # dense tensor-core flop/s
INT8_PEAK = {"sxm": 1979e12, "pcie": 1513e12}  # dense tensor-core op/s
TIERS = ("bfloat16", "int8", "int4")
KERNEL_NAMES = {"bfloat16": "topk_pruned", "int8": "topk_int8_pruned", "int4": "topk_int4_pruned"}
REPLACES = {  # the pallas_call of each TPU kernel
    "topk_pruned": "youtu_rag_tpu/ops/topk.py:299",
    "topk_int8_pruned": "youtu_rag_tpu/ops/topk.py:494",
    "topk_int4_pruned": "youtu_rag_tpu/ops/topk.py:665",
}


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAIL: {msg}")


def ops():
    """The port's kernels by tier: (wrapper, plain version, quantizer)."""
    from youtu_rag_tpu_torch.ops import topk as t

    return {
        "bfloat16": (t.topk_pruned, t.topk_pruned_reference, None),
        "int8": (t.topk_int8_pruned, t.topk_int8_pruned_reference, t.quantize_rows_int8),
        "int4": (t.topk_int4_pruned, t.topk_int4_pruned_reference, t.quantize_rows_int4),
    }


def reset_launches() -> None:
    for wrapper, _, _ in ops().values():
        wrapper.launches = 0


def launch_counts() -> dict[str, int]:
    return {tier: wrapper.launches for tier, (wrapper, _, _) in ops().items()}


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------


def build_all() -> None:
    """One nvcc per source, all started together."""
    from youtu_rag_tpu_torch.ops import _build

    done: dict[str, dict | BaseException] = {}

    def run(name):
        try:
            done[name] = _build.build(name, verbose=True)
        except BaseException as e:  # re-raised below, in the main thread
            done[name] = e

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(n,)) for n in KERNEL_NAMES.values()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for name in KERNEL_NAMES.values():
        got = done[name]
        if isinstance(got, BaseException):
            raise SystemExit(f"FAIL: build of {name}: {got}")
        print(f"built {name} in {got['seconds']:.1f} s")
        print("\n".join(line for line in got["log"].splitlines()
                        if "registers" in line or "stack" in line or "Compiling entry" in line))
    print(f"all builds: {time.perf_counter() - t0:.1f} s wall")


# ---------------------------------------------------------------------------
# 3. kernel vs plain
# ---------------------------------------------------------------------------

KERNEL_CASES = [
    (q, d, n, k)
    for q in (1, 8, 64)
    for d in (256, 768)
    for n in (4096, 65536)
    for k in (1, 10, 50, 128, 256, 1024)
]


def compare_topk(got, want, full_scores, what: str) -> float:
    """bf16, live slots only: equal row sets (rows whose scores sit within
    TOL of the k-th may swap), scores within TOL, and the kernel's own ties
    in row order. Returns the max abs score error."""
    from youtu_rag_tpu_torch.ops.topk import NEG_INF

    gs, gi = (t.cpu() for t in got)
    ws, wi = (t.cpu() for t in want)
    err = 0.0
    for a in range(ws.shape[0]):
        live = ws[a] > NEG_INF / 2
        n_live = int(live.sum())
        check(int((gs[a] > NEG_INF / 2).sum()) == n_live, f"{what}: live slot count, query {a}")
        if n_live == 0:
            continue
        e = float((gs[a, :n_live] - ws[a, :n_live]).abs().max())
        check(e <= TOL, f"{what}: score error {e} > {TOL}, query {a}")
        err = max(err, e)
        diff = set(gi[a, :n_live].tolist()) ^ set(wi[a, :n_live].tolist())
        kth = float(ws[a, n_live - 1])
        near = all(abs(float(full_scores[a, r]) - kth) <= TOL for r in diff)
        check(near, f"{what}: row sets differ beyond near-ties, query {a}: {sorted(diff)[:8]}")
        for t in range(n_live - 1):
            if gs[a, t] == gs[a, t + 1]:
                check(gi[a, t] < gi[a, t + 1], f"{what}: tie not in row order, query {a}")
    return err


def compare_exact(got, want, what: str) -> float:
    """int8 / int4, live slots only: the same rows in the same order and
    bit-equal scores. Returns the max abs score error (0.0)."""
    from youtu_rag_tpu_torch.ops.topk import NEG_INF

    gs, gi = (t.cpu() for t in got)
    ws, wi = (t.cpu() for t in want)
    for a in range(ws.shape[0]):
        n_live = int((ws[a] > NEG_INF / 2).sum())
        check(int((gs[a] > NEG_INF / 2).sum()) == n_live, f"{what}: live slot count, query {a}")
        check(torch.equal(gi[a, :n_live], wi[a, :n_live]), f"{what}: rows differ, query {a}")
        check(torch.equal(gs[a, :n_live].view(torch.int32), ws[a, :n_live].view(torch.int32)),
              f"{what}: scores not bit-equal, query {a}")
    return 0.0


def plain_scores(queries, x, bias):
    return queries.to(torch.bfloat16).float() @ x.float().T + bias[None, :]


def kernel_cases(seed: int) -> dict[str, float]:
    from youtu_rag_tpu_torch.ops.topk import NEG_INF

    g = torch.Generator(device="cuda").manual_seed(seed)

    def unit(rows, d):
        v = torch.randn(rows, d, generator=g, device="cuda")
        return v / v.norm(dim=1, keepdim=True)

    cases = [(c, "mixed") for c in KERNEL_CASES]
    cases += [((8, 256, 4096, 10), "all_masked"), ((64, 768, 65536, 1024), "all_masked")]
    # row counts that split into CTA ranges, 128-row tiles and 4-row groups unevenly
    cases += [((8, 768, 100003, 50), "mixed"), ((3, 256, 4099, 256), "mixed")]
    max_err = {tier: 0.0 for tier in TIERS}
    for (q, d, n, k), kind in cases:
        x = unit(n, d)
        x[100:110] = x[5]  # duplicated rows: exact ties
        queries = unit(q, d)
        queries[0] = x[5]  # the ties land at the top of query 0
        bias = torch.zeros(n, device="cuda")
        bias[::7] = NEG_INF  # tombstones / padding
        bias[3::11] = float("-inf")  # NEG_INF + a filter's NEG_INF
        bias[104] = NEG_INF  # one duplicate masked
        if kind == "all_masked":
            bias[:] = NEG_INF
        live = bias.cpu() == 0
        ties = [r for r in (5, *range(100, 110)) if live[r]]  # query 0's exact top
        for tier, (kernel, plain, quantize) in ops().items():
            what = f"{tier} q={q} d={d} n={n} k={k} {kind}"
            if quantize is None:
                xt, args = x.to(torch.bfloat16), ()
            else:
                xt, xs = quantize(x)
                args = (xs,)
            got = kernel(queries, xt, *args, bias, k)
            torch.cuda.synchronize()
            want = plain(queries, xt, *args, bias, k)
            if quantize is None:
                e = compare_topk(got, want, plain_scores(queries, xt, bias).cpu(), what)
            else:
                e = compare_exact(got, want, what)
                if kind == "mixed":
                    top = got[1][0, : min(k, len(ties))].tolist()
                    check(top == ties[: len(top)], f"{what}: tie order {top}")
            if kind == "all_masked":
                check(bool((got[0] <= NEG_INF / 2).all()), f"{what}: returned live slots")
            max_err[tier] = max(max_err[tier], e)
        torch.cuda.synchronize()
    print(f"kernel vs plain: {len(cases)} cases x {len(TIERS)} kernels ok, max_abs_err "
          + ", ".join(f"{KERNEL_NAMES[t]} {e}" for t, e in max_err.items()))
    return max_err


# ---------------------------------------------------------------------------
# 4. main path, small corpus
# ---------------------------------------------------------------------------

TOPICS = {
    "tpu.md": "# TPU\nHBM bandwidth on v5e is ~820 GB/s.\n",
    "cooking.md": "# Cooking\nBoil pasta for ten minutes in salted water, then drain it.",
    "astronomy.md": "# Astronomy\nJupiter has the largest moons; Ganymede is bigger than Mercury.",
    "gardening.md": "# Gardening\nTomato seedlings want compost, full sun and deep watering.",
    "finance.md": "# Finance\nCompound interest grows savings when dividends are reinvested.",
    "music.md": "# Music\nA violin quartet tunes its strings to concert pitch A440.",
    "cycling.md": "# Cycling\nInflate road bike tyres to eighty psi before a long ride.",
    "chess.md": "# Chess\nCastling moves the king two squares toward a rook.",
    "geology.md": "# Geology\nBasalt forms when lava cools quickly at the surface.",
    "sleep.md": "# Sleep\nAdults need seven to nine hours of sleep each night.",
    "coffee.md": "# Coffee\nEspresso extraction takes about twenty-five seconds at nine bar.",
    "birds.md": "# Birds\nArctic terns migrate from pole to pole every year.",
    "python.md": "# Python\nA list comprehension builds a list from an iterable in one line.",
    "sailing.md": "# Sailing\nTacking turns the bow of the boat through the wind.",
    "tea.md": "# Tea\nGreen tea steeps best in water below boiling, around eighty degrees.",
    "volcano.md": "# Volcanoes\nMount Etna in Sicily is among the most active volcanoes.",
    "running.md": "# Running\nMarathon runners taper their mileage before race day.",
    "bread.md": "# Bread\nSourdough rises with a starter of wild yeast and lactobacilli.",
    "glacier.md": "# Glaciers\nGlaciers carve U-shaped valleys as the ice slowly flows.",
    "photo.md": "# Photography\nA wide aperture gives a shallow depth of field.",
}
FILLER = (
    "notes archive record paragraph section appendix summary outline draft "
    "version revision index table figure caption footnote chapter volume"
).split()
QUERIES = [
    ("what bandwidth does v5e HBM have?", "tpu.md"),
    ("how long should pasta boil in salted water", "cooking.md"),
    ("which planet has moons bigger than Mercury", "astronomy.md"),
    ("what pressure for road bike tyres", "cycling.md"),
]
HYBRID_QUERY = ("tomato seedlings compost sun", "gardening.md")
HYBRID_INT4_K = 256  # pow2(4 x the fusion pool of 50): the int4 hybrid query's kernel k


def write_corpus(root: str, seed: int) -> None:
    rng = np.random.default_rng(seed)
    for name, text in TOPICS.items():
        body = text
        if name != "tpu.md":  # the CLI demo file stays as it is
            for _ in range(7):  # ~15 chunks per file: > 256 live rows for the int4 pool
                words = rng.choice(FILLER, size=160)
                body += "\n\n" + " ".join(words) + "."
        with open(os.path.join(root, name), "w") as f:
            f.write(body)


async def _drive_kb(kb, files):
    status = await kb.build_files(files)
    return status, await _answers(kb)


async def _answers(kb):
    dense = [await kb.retriever.retrieve(q, top_k=5, similarity_threshold=0.0) for q, _ in QUERIES]
    hybrid = await kb.hybrid_retriever.retrieve(HYBRID_QUERY[0], top_k=5, similarity_threshold=0.0)
    return dense + [hybrid]


def tier_config(name: str, tier: str):
    from youtu_rag_tpu_torch.core.config import IndexConfig, RAGConfig, VectorStoreConfig

    return RAGConfig(name=name, vector_store=VectorStoreConfig(index=IndexConfig(storage_dtype=tier)))


def check_answers(tier: str, got, ref, what: str) -> float:
    """The intended top documents, finite scores, and the same ranking as
    ``ref`` (bf16: scores within TOL; int8/int4: equal scores). Returns the
    max abs score difference."""
    err = 0.0
    for (query, want), hits, ref_hits in zip(QUERIES + [HYBRID_QUERY], got, ref):
        check(len(hits) > 0, f"{what} {tier}: no hits for {query!r}")
        top = hits[0].chunk.document_id
        check(top == want, f"{what} {tier}: {query!r} top hit {top}, expected {want}")
        check(all(np.isfinite(r.score) for r in hits), f"{what} {tier}: {query!r} non-finite score")
        check([r.chunk.id for r in hits] == [r.chunk.id for r in ref_hits],
              f"{what} {tier}: {query!r} ranks different chunks")
        err = max(err, max(abs(a.score - b.score) for a, b in zip(hits, ref_hits)))
    check(err <= (TOL if tier == "bfloat16" else 0.0), f"{what} {tier}: scores differ by {err}")
    return err


def small_corpus(seed: int) -> tuple[dict[str, int], dict[str, float]]:
    import youtu_rag_tpu_torch.index.device_index as device_index
    from youtu_rag_tpu_torch.retrieval.kb import KnowledgeBase

    kernels = ops()
    asked: list[int] = []
    real_int4 = device_index.topk_int4_pruned

    def int4_spy(queries, x, scales, bias, k):  # records the k the index asks for
        asked.append(k)
        return real_int4(queries, x, scales, bias, k)

    launches, errs, kbs = {}, {}, {}
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
        write_corpus(root, seed)
        files = sorted(os.path.join(f"{root}", f) for f in os.listdir(root))
        for tier in TIERS:
            kb = KnowledgeBase(f"smoke-{tier}", tier_config("smoke", tier), device="cuda")
            device_index.topk_int4_pruned = int4_spy
            try:
                reset_launches()
                status, got = asyncio.run(_drive_kb(kb, files))
                torch.cuda.synchronize()
                counts = launch_counts()
            finally:
                device_index.topk_int4_pruned = real_int4
            launches[tier] = counts[tier]
            print(f"small corpus {tier}: {len(files)} files, {status.total_chunks} chunks, "
                  f"launches {counts}")
            check(status.status == "completed" and not status.errors, f"build failed: {status.errors}")
            check(status.total_chunks >= HYBRID_INT4_K, f"only {status.total_chunks} chunks")
            check(counts[tier] > 0, f"the {tier} KB's searches never launched {KERNEL_NAMES[tier]}")
            check(all(n == 0 for t, n in counts.items() if t != tier),
                  f"the {tier} KB launched another tier's kernel: {counts}")
            cpu_kb = KnowledgeBase(f"smoke-{tier}-cpu", tier_config("smoke", tier), device="cpu")
            _, ref = asyncio.run(_drive_kb(cpu_kb, files))
            for (query, _), hits in zip(QUERIES + [HYBRID_QUERY], got):
                print(f"  {query!r} -> {hits[0].chunk.document_id} ({hits[0].score:.4f})")
            errs[tier] = check_answers(tier, got, ref, "CUDA vs CPU KB")
            kbs[tier] = kb
        print(f"int4 kernel k asked on the small KB: {sorted(set(asked))}")
        check(HYBRID_INT4_K in asked, f"the int4 hybrid query never asked its kernel for k = {HYBRID_INT4_K}")

        # the int4 KB through a snapshot, into a fresh CUDA KB
        snap = os.path.join(root, "snapshot")
        saved = kbs["int4"].save(snap)
        fresh = KnowledgeBase("smoke-int4-loaded", tier_config("smoke", "int4"), device="cuda")
        reset_launches()
        loaded = fresh.load(snap)
        got = asyncio.run(_answers(fresh))
        torch.cuda.synchronize()
        counts = launch_counts()
        launches["int4"] += counts["int4"]
        check(loaded["chunks"] == saved["chunks"] and counts["int4"] > 0,
              f"int4 snapshot: {saved} -> {loaded}, launches {counts}")
        twin = KnowledgeBase("smoke-int4-twin", tier_config("smoke", "int4"), device="cpu")
        twin.load(snap)
        check_answers("int4", got, asyncio.run(_answers(twin)), "int4 snapshot CUDA vs CPU")
        original = asyncio.run(_answers(kbs["int4"]))
        check([h[0].chunk.id for h in got] == [h[0].chunk.id for h in original],
              "the reloaded int4 KB's top chunks differ from the saved KB's")
        print(f"int4 KB saved and loaded into a fresh CUDA KB: {loaded['chunks']} chunks, "
              f"same answers, {counts['int4']} launches")

    # each kernel at the shapes this path gave it: q bucket 1 and 4, k 5 and 50
    for tier, kb in kbs.items():
        kernel, plain, quantize = kernels[tier]
        index = kb.store.index
        emb = kb.embedder.embed_batch([q for q, _ in QUERIES])
        extra = () if quantize is None else (index._scales,)
        x, b = index._vectors, index._bias
        for qn in (1, len(QUERIES)):
            q = torch.from_numpy(emb[:qn]).cuda()
            for k in (5, 50) + ((HYBRID_INT4_K,) if tier == "int4" else ()):
                got = kernel(q, x, *extra, b, k)
                torch.cuda.synchronize()
                want = plain(q, x, *extra, b, k)
                what = f"kb {tier} q={qn} k={k}"
                e = (compare_topk(got, want, plain_scores(q, x, b).cpu(), what)
                     if quantize is None else compare_exact(got, want, what))
                errs[tier] = max(errs[tier], e)
    return launches, errs


# ---------------------------------------------------------------------------
# 5. main path at full size
# ---------------------------------------------------------------------------


def time_ms(fn, bursts: int = 5, burst: int = 20, warmup: int = 3) -> float:
    """Device time of one call: CUDA events around a burst of back-to-back
    calls (so the host's enqueue overlaps the card's work), divided by the
    burst length; the median over bursts. Every index here is well past
    the 50 MB L2 (the int4 one, 0.40 GB, is 8x it), so every call reads it
    from HBM."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(bursts):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(burst):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / burst)
    return statistics.median(times)


def profile_split(fn, calls: int = 10) -> None:
    """Device time per call of each kernel ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and e.count >= calls:
            rows.append((us / calls, e.key))
    print("  device time per call: " + "; ".join(
        f"{name.replace('(anonymous namespace)::', '').split('(')[0].split('<')[0][:48]} {us / 1e3:.4f} ms"
        for us, name in sorted(rows, reverse=True)[:4]))


def bound(tier: str, part: str, n: int, d: int, qn: int, k: int) -> tuple[float, str]:
    """Least time the card could take: the larger of the bytes the call
    must move (each input read once, each output written once) over the
    HBM rate, and its 2·q·N·d operations over the tensor-core peak of
    their type. Returns (ms, "bytes" or "operations")."""
    if tier == "bfloat16":
        nbytes = n * d * 2 + n * 4 + qn * d * 4 + qn * k * 8
        ops_ms = 2 * qn * n * d / BF16_PEAK[part] * 1e3
    else:
        row_bytes = d if tier == "int8" else d // 2
        nbytes = n * row_bytes + n * 8 + qn * d * 4 + qn * k * 8
        ops_ms = 2 * qn * n * d / INT8_PEAK[part] * 1e3
    bytes_ms = nbytes / HBM_PEAK[part] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def library_call(tier: str, qdev, x, scales, bias, k: int):
    """One PyTorch call computing the same function (the port never calls
    it), with its description; None where PyTorch has none."""
    if tier == "bfloat16":
        q16 = qdev.to(torch.bfloat16)
        try:
            torch.mm(q16, x.T, out_dtype=torch.float32)
            return ("torch.topk(torch.mm(q, x.T, out_dtype=float32) + bias, k)",
                    lambda: torch.topk(torch.mm(q16, x.T, out_dtype=torch.float32) + bias, k))
        except (RuntimeError, TypeError):
            return ("torch.topk(torch.mm(q, x.T).float() + bias, k)",
                    lambda: torch.topk(torch.mm(q16, x.T).float() + bias, k))
    if tier == "int8":
        from youtu_rag_tpu_torch.ops.topk import quantize_rows_int8

        qq, qs = quantize_rows_int8(qdev)
        qn = qq.shape[0]
        # torch._int_mm takes more than 16 rows, in multiples of 8: pad the queries
        qpad = torch.zeros((32, qq.shape[1]), dtype=torch.int8, device=qq.device)
        qpad[:qn] = qq
        sc = qs[:, None] * scales[None, :]

        def call():
            acc = torch._int_mm(qpad, x.T)[:qn]
            return torch.topk(acc.float() * sc + bias, k)
        try:
            call()
        except (RuntimeError, TypeError) as e:
            return (f"none: torch._int_mm refused these shapes ({e})", None)
        return ("torch.topk(torch._int_mm(q_pad32, x.T)[:q].float() * (qs x xs) + bias, k)", call)
    return ("none: PyTorch has no one-call product of int8 queries with packed int4 rows", None)


def full_size(seed: int, part: str) -> dict[str, dict]:
    from youtu_rag_tpu_torch.core.config import IndexConfig
    from youtu_rag_tpu_torch.core.types import Chunk
    from youtu_rag_tpu_torch.index.device_index import DeviceVectorIndex

    kernels = ops()
    rows, d, qn, top_k, batch = ROWS, 768, 8, 10, 65536
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    vecs = np.empty((rows, d), np.float32)
    for start in range(0, rows, batch):  # one set of unit vectors for the three tiers
        v = rng.standard_normal((batch, d), dtype=np.float32)
        vecs[start : start + batch] = v / np.linalg.norm(v, axis=1, keepdims=True)
    chunks = [Chunk(f"c{i}", f"doc{i // 64}", "", i % 64) for i in range(rows)]
    queries = rng.standard_normal((qn, d), dtype=np.float32)
    queries[0] = vecs[rows // 2]  # a stored row: top-1 known
    qpad = queries / np.linalg.norm(queries, axis=1, keepdims=True)  # as search() prepares it
    qdev = torch.from_numpy(qpad.astype(np.float32)).cuda()
    print(f"full size: {rows} x {d} unit vectors made in {time.perf_counter() - t0:.1f} s")

    out = {}
    for tier in TIERS:
        kernel, plain, quantize = kernels[tier]
        index = DeviceVectorIndex(d, IndexConfig(storage_dtype=tier, metric="cosine"), device="cuda")
        index.reserve(rows)
        t0 = time.perf_counter()
        for start in range(0, rows, batch):
            index.add(chunks[start : start + batch], vecs[start : start + batch])
        torch.cuda.synchronize()
        fill_s = time.perf_counter() - t0

        reset_launches()
        hits = index.search(queries, top_k=top_k)
        torch.cuda.synchronize()
        counts = launch_counts()
        launches = counts[tier]
        x, b = index._vectors[:rows], index._bias[:rows]
        extra = () if quantize is None else (index._scales[:rows],)
        scale_bytes = 0 if quantize is None else index._scales.numel() * 4
        print(f"{tier}: filled in {fill_s:.1f} s; nbytes() {index.nbytes()} "
              f"({index.nbytes() / 1e9:.3f} GB, scales not counted), scales {scale_bytes} bytes; "
              f"search launches {counts}")
        check(launches > 0, f"{tier}: index.search never launched {KERNEL_NAMES[tier]}")
        check(all(n == 0 for t, n in counts.items() if t != tier), f"{tier}: other kernels ran")
        check(len(hits) == qn and all(len(h) == top_k for h in hits), f"{tier}: wrong shape")
        check(all(np.isfinite(s) for h in hits for _, s in h), f"{tier}: non-finite scores")
        check(hits[0][0][0].id == f"c{rows // 2}", f"{tier}: query 0 top hit {hits[0][0][0].id}")

        # the same device tensors the search used, through the plain version
        got_rows = torch.tensor([[index._id_to_row[c.id] for c, _ in h] for h in hits],
                                dtype=torch.int32)
        got_s = torch.tensor([[s for _, s in h] for h in hits], dtype=torch.float32)
        k_kernel = top_k
        if tier == "bfloat16":
            want = plain(qdev, x, b, top_k)
            err = compare_topk((got_s, got_rows), want, plain_scores(qdev, x, b).cpu(), tier)
        elif tier == "int8":
            err = compare_exact((got_s, got_rows), plain(qdev, x, *extra, b, top_k), tier)
        else:
            # int4: the kernel's k2 candidates, then the host re-rank
            k_kernel = 64
            cand = kernel(qdev, x, *extra, b, k_kernel)
            torch.cuda.synchronize()
            want = plain(qdev, x, *extra, b, k_kernel)
            err = compare_exact(cand, want, "int4 candidates")
            rs, rr = index._host_rerank_candidates(qpad, want[0].cpu().numpy(), want[1].cpu().numpy(),
                                                   index._host_q8, index._host_s8, top_k)
            check(np.array_equal(got_rows.numpy(), rr) and np.array_equal(got_s.numpy(), rs),
                  "int4: the search's re-ranked rows differ from the plain version's")
        print(f"{tier}: search (q = {qn}, top_k = {top_k}, kernel k = {k_kernel}) matches the plain version")

        res = {"launches": launches, "err": err, "k": k_kernel}
        for k in (k_kernel, 256, 1024):
            ms = time_ms(lambda: kernel(qdev, x, *extra, b, k))
            bms, by = bound(tier, part, rows, d, qn, k)
            row_bytes = {"bfloat16": 2 * d, "int8": d, "int4": d // 2}[tier]
            gbs = (rows * (row_bytes + (4 if tier == "bfloat16" else 8))) / ms / 1e6
            print(f"  {KERNEL_NAMES[tier]} {rows}x{d} q={qn} k={k}: {ms:.4f} ms/batch, {gbs:.1f} GB/s "
                  f"({gbs / (HBM_PEAK[part] / 1e9) * 100:.1f}% of {HBM_PEAK[part] / 1e12:.2f} TB/s); "
                  f"bound {bms:.4f} ms ({by})")
            res.setdefault("sweep", {})[k] = ms
            if k == k_kernel:
                res.update(ms=ms, bound_ms=bms, bound_by=by)
        res["plain_ms"] = time_ms(lambda: plain(qdev, x, *extra, b, k_kernel), bursts=3, burst=5)
        desc, call = library_call(tier, qdev, x, *(extra or (None,)), b, k_kernel)
        res["library_ms"] = None if call is None else time_ms(call)
        print(f"  plain {res['plain_ms']:.4f} ms; library "
              f"{'null' if call is None else format(res['library_ms'], '.4f') + ' ms'} [{desc}]")
        profile_split(lambda: kernel(qdev, x, *extra, b, k_kernel))
        out[tier] = res
        del index, x, b, extra, hits
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    phase("1 environment")
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this script needs an H100", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    part = "pcie" if "pcie" in name.lower() else "sxm"
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {name} ({part})")
    t_start = time.perf_counter()

    phase("2 build")
    build_all()

    phase("3 kernel vs plain")
    err3 = kernel_cases(args.seed)

    phase("4 main path, small corpus")
    launches4, err4 = small_corpus(args.seed)

    phase("5 main path, full size")
    full = full_size(args.seed, part)

    phase("6 summary")
    kernels = []
    for tier in TIERS:
        kname, f = KERNEL_NAMES[tier], full[tier]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": f"youtu_rag_tpu_torch/csrc/{kname}.cu",
            "replaces": REPLACES[kname],
            "launches": launches4[tier] + f["launches"],
            "max_abs_err": max(err3[tier], err4[tier], f["err"]),
            "ms": f["ms"],
            "plain_ms": f["plain_ms"],
            "bound_ms": f["bound_ms"],
            "bound_by": f["bound_by"],
            "library_ms": f["library_ms"],
        })
    print(f"phases 2-6: {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
