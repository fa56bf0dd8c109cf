#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (youtu_rag_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--seed 0]

Phases; any failure exits non-zero before the result lines:
  1. environment: the card's name and power limit, torch and CUDA versions;
     fails without a CUDA device;
  2. build: compiles the path's kernel from csrc/ and prints ptxas'
     register and shared-memory report;
  3. kernel vs plain: each kernel against its plain PyTorch version on the
     card, over the shapes and edge cases listed in KERNEL_CASES;
  4. main path, small corpus: about 20 markdown files through the port's
     KnowledgeBase (hash embedder → device index → kernel → retrievers),
     checked for the intended top documents and against the same KB on
     the CPU;
  5. main path, full size: a 1,048,576 × 768 bf16 cosine index filled
     through ``add``, searched with q = 8, k = 10, checked against the
     plain version, and timed with CUDA events beside its HBM bound, the
     plain version and a one-call PyTorch yardstick;
  6. one JSON line, {"kernels": [{"name": ..., "route", "source",
     "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
     "bound_by", "library_ms"}, ...]}: one entry per kernel, so later
     slices add theirs to the same list;
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
import time

import numpy as np
import torch

TOL = 1e-4  # unit vectors, f32 sums in another order than cuBLAS
ROWS = 1 << 20  # the full-size index: 1,048,576 × 768 bf16, 1.61 GB
HBM_PEAK = {"sxm": 3.35e12, "pcie": 2.0e12}  # bytes/s, NVIDIA data sheets
BF16_PEAK = {"sxm": 989e12, "pcie": 756e12}  # dense tensor-core flop/s


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAIL: {msg}")


# ---------------------------------------------------------------------------
# 3. kernel vs plain
# ---------------------------------------------------------------------------

KERNEL_CASES = [
    (q, d, n, k)
    for q in (1, 8, 64)
    for d in (256, 768)
    for n in (4096, 65536)
    for k in (1, 10, 50, 128)
]


def compare_topk(got, want, full_scores, what: str) -> float:
    """Live slots only: equal row sets (rows whose scores sit within TOL of
    the k-th may swap), scores within TOL, and the kernel's own ties in
    row order. Returns the max abs score error."""
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


def plain_scores(queries, x, bias):
    return queries.to(torch.bfloat16).float() @ x.float().T + bias[None, :]


def kernel_cases(seed: int) -> float:
    from youtu_rag_tpu_torch.ops.topk import NEG_INF, topk_pruned, topk_pruned_reference

    g = torch.Generator(device="cuda").manual_seed(seed)
    max_err = 0.0

    def unit(rows, d):
        v = torch.randn(rows, d, generator=g, device="cuda")
        return v / v.norm(dim=1, keepdim=True)

    cases = [(c, "mixed") for c in KERNEL_CASES]
    cases += [((8, 256, 4096, 10), "all_masked"), ((64, 768, 65536, 128), "all_masked")]
    # row counts that split into CTA ranges, 128-row tiles and 4-row groups unevenly
    cases += [((8, 768, 100003, 50), "mixed"), ((3, 256, 4099, 128), "mixed")]
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
        x = x.to(torch.bfloat16)
        got = topk_pruned(queries, x, bias, k)
        torch.cuda.synchronize()
        want = topk_pruned_reference(queries, x, bias, k)
        full = plain_scores(queries, x, bias).cpu()
        e = compare_topk(got, want, full, f"q={q} d={d} n={n} k={k} {kind}")
        if kind == "all_masked":
            check(bool((got[0] <= NEG_INF / 2).all()), f"all-masked q={q} returned live slots")
        max_err = max(max_err, e)
        torch.cuda.synchronize()
    print(f"kernel vs plain: {len(cases)} cases ok, max_abs_err {max_err}")
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


def write_corpus(root: str, seed: int) -> None:
    rng = np.random.default_rng(seed)
    for name, text in TOPICS.items():
        body = text
        if name != "tpu.md":  # the CLI demo file stays as it is
            for _ in range(3):  # ~3 chunks per file, so the KB holds > 50 chunks
                words = rng.choice(FILLER, size=160)
                body += "\n\n" + " ".join(words) + "."
        with open(os.path.join(root, name), "w") as f:
            f.write(body)


async def _drive_kb(kb, files):
    status = await kb.build_files(files)
    dense = [await kb.retriever.retrieve(q, top_k=5, similarity_threshold=0.0) for q, _ in QUERIES]
    hybrid = await kb.hybrid_retriever.retrieve(HYBRID_QUERY[0], top_k=5, similarity_threshold=0.0)
    return status, dense, hybrid


def small_corpus(seed: int) -> tuple[int, float]:
    from youtu_rag_tpu_torch.core.config import RAGConfig
    from youtu_rag_tpu_torch.ops.topk import topk_pruned, topk_pruned_reference
    from youtu_rag_tpu_torch.retrieval.kb import KnowledgeBase

    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
        write_corpus(root, seed)
        files = sorted(os.path.join(root, f) for f in os.listdir(root))
        kb = KnowledgeBase("smoke", RAGConfig(name="smoke"), device="cuda")
        topk_pruned.launches = 0
        status, dense, hybrid = asyncio.run(_drive_kb(kb, files))
        torch.cuda.synchronize()
        launches = topk_pruned.launches
        cpu_kb = KnowledgeBase("smoke-cpu", RAGConfig(name="smoke-cpu"), device="cpu")
        _, cpu_dense, cpu_hybrid = asyncio.run(_drive_kb(cpu_kb, files))

    chunks = status.total_chunks
    print(f"small corpus: {len(files)} files, {chunks} chunks, {launches} kernel launches")
    check(status.status == "completed" and not status.errors, f"build failed: {status.errors}")
    check(chunks > 50, f"only {chunks} chunks: the hybrid pool (k = 50) is not exercised")
    check(launches > 0, "the KB's searches never launched topk_pruned")
    err = 0.0
    for (query, want), got, ref in zip(QUERIES + [HYBRID_QUERY], dense + [hybrid], cpu_dense + [cpu_hybrid]):
        check(len(got) > 0, f"no hits for {query!r}")
        top = got[0].chunk.document_id
        print(f"  {query!r} -> {top} ({got[0].score:.4f})")
        check(top == want, f"{query!r}: top hit {top}, expected {want}")
        check(all(np.isfinite(r.score) for r in got), f"{query!r}: non-finite score")
        check([r.chunk.id for r in got] == [r.chunk.id for r in ref],
              f"{query!r}: CUDA and CPU KBs rank different chunks")
        err = max(err, max(abs(a.score - b.score) for a, b in zip(got, ref)))
    check(err <= TOL, f"CUDA vs CPU KB scores differ by {err}")

    # the kernel at the shapes this path gave it: q bucket 1, k 5 and 50
    index = kb.store.index
    emb = kb.embedder.embed_batch([q for q, _ in QUERIES])
    x, b = index._vectors, index._bias
    for qn in (1, len(QUERIES)):
        q = torch.from_numpy(emb[:qn]).cuda()
        for k in (5, 50):
            got = topk_pruned(q, x, b, k)
            torch.cuda.synchronize()
            err = max(err, compare_topk(got, topk_pruned_reference(q, x, b, k),
                                        plain_scores(q, x, b).cpu(), f"kb q={qn} k={k}"))
    return launches, err


# ---------------------------------------------------------------------------
# 5. main path at full size
# ---------------------------------------------------------------------------


def time_ms(fn, bursts: int = 5, burst: int = 20, warmup: int = 3) -> float:
    """Device time of one call: CUDA events around a burst of back-to-back
    calls (so the host's enqueue overlaps the card's work), divided by the
    burst length; the median over bursts. The 1.61 GB index is 32x the
    50 MB L2, so every call reads it from HBM."""
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
    print("device time per call: " + "; ".join(
        f"{name.replace('(anonymous namespace)::', '').split('(')[0].split('<')[0][:48]} {us / 1e3:.4f} ms"
        for us, name in sorted(rows, reverse=True)[:4]))


def full_size(seed: int, part: str) -> dict:
    from youtu_rag_tpu_torch.core.config import IndexConfig
    from youtu_rag_tpu_torch.core.types import Chunk
    from youtu_rag_tpu_torch.index.device_index import DeviceVectorIndex
    from youtu_rag_tpu_torch.ops.topk import topk_pruned, topk_pruned_reference

    rows, d, qn, k, batch = ROWS, 768, 8, 10, 65536
    rng = np.random.default_rng(seed)
    index = DeviceVectorIndex(d, IndexConfig(storage_dtype="bfloat16", metric="cosine"), device="cuda")
    index.reserve(rows)
    t0 = time.perf_counter()
    for start in range(0, rows, batch):
        n = min(batch, rows - start)
        v = rng.standard_normal((n, d), dtype=np.float32)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        index.add([Chunk(f"c{start + i}", f"doc{(start + i) // 64}", "", i % 64)
                   for i in range(n)], v)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    queries = rng.standard_normal((qn, d), dtype=np.float32)
    queries[0] = index._vectors[rows // 2].float().cpu().numpy()  # a stored row: top-1 known

    topk_pruned.launches = 0
    hits = index.search(queries, top_k=k)
    torch.cuda.synchronize()
    launches = topk_pruned.launches
    print(f"full size: {rows} x {d} bf16 filled in {fill_s:.1f} s "
          f"({index.nbytes() / 1e9:.3f} GB on the card), search launches {launches}")
    check(launches > 0, "index.search never launched topk_pruned")
    check(len(hits) == qn and all(len(h) == k for h in hits), "search returned the wrong shape")
    check(all(np.isfinite(s) for h in hits for _, s in h), "non-finite search scores")
    check(hits[0][0][0].id == f"c{rows // 2}", f"query 0 top hit {hits[0][0][0].id}")

    # the same device tensors the search used, through the plain version
    qpad = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    qdev = torch.from_numpy(qpad.astype(np.float32)).cuda()
    x, b = index._vectors[:rows], index._bias[:rows]
    want = topk_pruned_reference(qdev, x, b, k)
    got_rows = [[index._id_to_row[c.id] for c, _ in h] for h in hits]
    got_s = torch.tensor([[s for _, s in h] for h in hits])
    err = compare_topk((got_s, torch.tensor(got_rows, dtype=torch.int32)), want,
                       plain_scores(qdev, x, b).cpu(), "full-size search")

    ms = time_ms(lambda: topk_pruned(qdev, x, b, k))
    plain_ms = time_ms(lambda: topk_pruned_reference(qdev, x, b, k))
    q16 = qdev.to(torch.bfloat16)
    try:
        torch.mm(q16, x.T, out_dtype=torch.float32)
        library = "torch.topk(torch.mm(q, x.T, out_dtype=float32) + bias, k)"

        def lib_call():
            return torch.topk(torch.mm(q16, x.T, out_dtype=torch.float32) + b, k)
    except (RuntimeError, TypeError):
        library = "torch.topk(torch.mm(q, x.T).float() + bias, k)"

        def lib_call():
            return torch.topk(torch.mm(q16, x.T).float() + b, k)
    library_ms = time_ms(lib_call)

    profile_split(lambda: topk_pruned(qdev, x, b, k))
    sweep = {kk: time_ms(lambda: topk_pruned(qdev, x, b, kk)) for kk in (1, 50, 128)}
    print("topk_pruned at other k (ms/batch): "
          + ", ".join(f"k={kk} {t:.4f}" for kk, t in sweep.items()))

    nbytes = rows * d * 2 + rows * 4 + qn * d * 4 + qn * k * 8
    flops = 2 * qn * rows * d
    bound_bytes_ms = nbytes / HBM_PEAK[part] * 1e3
    bound_ops_ms = flops / BF16_PEAK[part] * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    print(f"topk_pruned {rows}x{d} q={qn} k={k}: {ms:.4f} ms/batch, "
          f"{nbytes / ms / 1e6:.1f} GB/s ({nbytes / ms / 1e6 / (HBM_PEAK[part] / 1e9) * 100:.1f}% "
          f"of {HBM_PEAK[part] / 1e12:.2f} TB/s); bound {bound_ms:.4f} ms "
          f"(bytes {bound_bytes_ms:.4f}, ops {bound_ops_ms:.4f}); "
          f"plain {plain_ms:.4f} ms; library {library_ms:.4f} ms [{library}]")
    return {"launches": launches, "err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"}


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

    from youtu_rag_tpu_torch.ops import _build

    phase("2 build")
    t0 = time.perf_counter()
    built = _build.build("topk_pruned", verbose=True)
    print(f"built topk_pruned in {time.perf_counter() - t0:.1f} s")
    print("\n".join(line for line in built["log"].splitlines() if "registers" in line or "stack" in line))

    phase("3 kernel vs plain")
    err3 = kernel_cases(args.seed)

    phase("4 main path, small corpus")
    launches4, err4 = small_corpus(args.seed)

    phase("5 main path, full size")
    full = full_size(args.seed, part)

    phase("6 summary")
    kernels = [{
        "name": "topk_pruned",
        "route": "cuda",
        "source": "youtu_rag_tpu_torch/csrc/topk_pruned.cu",
        "replaces": "youtu_rag_tpu/ops/topk.py:299",
        "launches": launches4 + full["launches"],
        "max_abs_err": max(err3, err4, full["err"]),
        "ms": full["ms"],
        "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"],
        "bound_by": full["bound_by"],
        "library_ms": full["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
