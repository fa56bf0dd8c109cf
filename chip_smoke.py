#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (youtu_rag_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--seed 0]

Phases; any failure exits non-zero before the result lines:
  1. environment: the card's name and power limit, torch and CUDA versions;
     fails without a CUDA device;
  2. build: compiles the path's six kernel sources from csrc/ at once (one
     nvcc per source) and prints each build's time and ptxas' register and
     spill report and warnings (the scan kernels in three k classes; the
     attention source's Hopper kernels, attention_wgmma.cuh's
     attention_kernel for hd 64 and 128 and its three entries, blockwise,
     flash and the hop's stats, and its mma.sync kernels for f32), then one
     line per attention kernel, brute int4 scan kernel (the tensor-core
     scorer) and IVF kernel (ivf_scan_tma.cuh: the bf16, int8 and int4 DMA
     entries and the bf16 / int8 per-block ones) with its registers and
     spills, and the TMA IVF entries' shared-memory plan and CTAs per SM for
     d 128-8192 (int4 256-8192) x k 1-4096 (fails where a cell has none);
  3. kernel vs plain, top-k: each top-k kernel against its plain PyTorch
     version on the card, over the shapes and edge cases of KERNEL_CASES
     (k up to 1024): bf16 within TOL, int8 and int4 bit-equal on the same
     quantized tensors; then the int4 kernel alone over INT4_CASES (d 256
     and 4096, row counts that are not a multiple of 16);
  3x. kernel vs plain, any query count and k above 1024: q = 0 (no launch,
     an empty result), 65, 100 and 130 (one launch per 64 queries) through
     all ten top-k wrappers (the per-block IVF ones merged by their kernel
     and as candidates); k = 2048 and 4096 (bf16, int4) and 8192 (int8)
     through the pruned kernels, k = 2048 through one IVF case and the
     per-block candidates, and the merged per-block IVF calls at k = 1024,
     2048 and 4096 (= block_rows); each held to its plain version as in
     phases 3, 3c and 3d;
  3b. kernel vs plain, attention: blockwise (T 256, 384, 512, 640, 4096)
     and flash (T 4224, 8192) against their plain versions, hd 64 and 128,
     bf16 (the Hopper kernels) and f32, with padded keys and a batch row
     whose every key is masked, and both entries on the encoder's strided
     q, k, v views, within compare_attention's tolerance; any NaN fails;
  3e. kernel vs plain, the ring hop: ``flash_attention_stats`` (bf16 on
     the Hopper kernel's stats entry, f32 on the mma.sync kernel) at T =
     T_kv = 128 (one key tile), 256, 1024 and 8192, T = 1024 against T_kv =
     128, 512 and 4096, hd 64 and 128, bf16 and f32, padded keys, a fully
     masked row and a span whose every key is padding, the encoder's
     strided q, k, v views, and [16, 12, 512, 64] (768 work items, several
     per CTA): m, l and acc / l (compare_stats); two half-span hops
     combined against ``flash_attention`` on the whole span;
  3c. kernel vs plain, IVF: each IVF kernel against its plain version over
     IVF_CASES (k 1 to 1024, q 1 to 64, block_rows 64, 1024 and 4096) and
     the plan's edges (n_valid 0, 1 and max_blocks, garbage ids past
     n_valid, NEG_INF and -inf rows, fewer live rows than k): bf16 within
     TOL, int8 and int4 bit-equal; then the int4 kernel alone at block_rows
     4, 8 and 12 (stages and 16-row groups that straddle blocks) and k up
     to 2048, and the three kernels over IVF_TMA_CASES (q 1, 7, 9, 65;
     k 1, 129, 1025; block_rows 4, 12, 4096; f32 queries and ascending ids,
     bf16 queries and shuffled ids; a zero query row), one launch per 64
     queries;
  3f. kernel vs plain, IVF inputs JAX takes: the three DMA entries at
     block_rows 1, 2, 6, 66 and 1026 with bias and scales 4 bytes past a
     16-byte boundary, k up to block_rows; the three DMA entries and the
     bf16 and int8 merged per-block entries at d 4096 and 8192 with k up to
     4096 (lists in device memory; bf16 at d = 8192 the wide plan); as in
     phases 3c, 3d;
  3d. kernel vs plain, per-block: the four per-block kernels (``topk``,
     ``topk_int8``, ``ivf_topk``, ``ivf_topk_int8``) against their plain
     versions over BLOCKS_CASES (k 1 to 1024 and k = block_rows, q 1 to
     64, block_rows 256 to 4096, IVF also 4, 6 and 12; NEG_INF and -inf rows,
     a block scoring -inf throughout, fewer live rows than k, no live row
     with position 0 all -inf (the tail's last slot from position 1, the
     pad or a one-block plan's -inf); plans with n_valid 0, 1, half and
     max_blocks, ids ascending and shuffled): every candidate slot of
     ``csrc/topk_blocks.cu``, the fill and the pad included, and the merged
     result: brute the merged candidates against
     ``fused_topk(backend="pallas_interpret")`` (bf16) or the merged plain
     candidates, IVF the merged call (the per-block entries of
     ``csrc/ivf_scan_tma.cuh``, one launch per 64 queries) against the
     merged plain candidates, ties in probe order; rows equal (bf16: a swap
     of two rows scoring within TOL of each other allowed), bf16 scores
     within TOL, int8 bit-equal, the tail slot for slot;
  4. main path, small corpus: about 20 markdown files through the port's
     KnowledgeBase (hash embedder → device index → kernel → retrievers)
     as three KBs, one per storage tier (bf16, int8, int4), each checked
     for the intended top documents and against the same KB on the CPU;
     the int4 hybrid query asks its kernel for k = 256; the int4 KB is
     then saved and loaded into a fresh CUDA KB, which answers the same;
  4c. main path, small corpus, IVF: the phase-4 corpus through a CUDA KB per
     tier with block_rows 64 and ``build_ivf()``: the intended top
     documents, the same top documents as the CPU twin, IVF launches and no
     brute launch; each IVF call of the path held against its plain
     version; then save and load into a fresh CUDA KB that builds IVF
     again and answers the same;
  4b. main path, small corpus, encoder (provider "tpu"): (a) the default
     full-width encoder (768 x 12 layers, seeded, attention_impl "pallas")
     through a CUDA KB of the phase-4 corpus and three exact-identifier
     documents, held to the same KB on the CPU (the kernels' plain
     versions) by ENC_TOL; blockwise launches a multiple of 12; (b) the
     committed yrt_tiny_lex as its config says (no attention launches),
     ranking the exact-identifier documents, then served with "pallas",
     which must give the same top documents;
  4d. main path, small corpus, long documents: six documents of ~1,200
     tokens whose own passage starts past token 512, one chunk each at
     ``chunk_size`` 10,000, through a CUDA KB served by the default
     full-width encoder with sp_mesh=4: every query answered from its
     document, hop launches a positive multiple of 12 x 4 (the same KB cut
     at max_len is printed for contrast); then a small encoder (128 wide,
     2 layers, 2 heads of 64) with sp_mesh=4, whose top documents on the
     card equal its CPU twin's;
  4e. main path, a pretrained BERT-family checkpoint: a BERT-base embedder
     (bge-base-en-v1.5's config, CLS pooling; safetensors F32) and a
     one-label cross-encoder (bert-base-uncased's widths; BF16) written
     from a seed with a 30,522-entry vocab.txt, served through a CUDA KB
     with ``EmbeddingConfig(provider="tpu", pretrained_dir=...)`` and
     ``TorchReranker.from_pretrained`` over phase 4's topics as one chunk
     of ~450 tokens each (T = 512): the stored embeddings and every
     document's dense rank against a CPU f32 twin, the same forward with
     plain attention, the kernel's attention output against plain
     attention within one bf16 ulp, the cross-encoder's scores and order
     against a CPU f32 twin (ENC_TOL), blockwise launches 12 per forward
     at T >= 256 and none below; then BERT-base embeddings/s at B = 128,
     T = 512 (device and embed_batch, WordPiece apart), the forward's split
     (attention kernel, GEMMs, the rest), the forward with SDPA in the
     kernel's place, and cross-encoder pairs/s at B = 64, T = 512;
  5. main path, full size: 1,048,576 × 768 cosine indexes of each tier
     filled through ``add`` from one set of seeded vectors, searched with
     q = 8, top_k = 10 (int4 asks its kernel for 64 candidates and
     re-ranks them on the host), checked against the plain versions on the
     same device tensors, and timed with CUDA events beside their bounds,
     the plain versions, a one-call PyTorch yardstick where one exists and
     the recorded time of the kernel's earlier design (EARLIER_MS);
  5c. main path, full size, IVF: ``configs/rag/ivf_int8.yaml``'s index
     settings (block_rows 1024, n_lists 1024, n_probe 64, adaptive margin
     0.15, recall target 0.95) over 1,048,576 × 768 clustered unit vectors
     drawn on the card (``scripts/bench_scale.py``'s generator: 1024
     centers, spread 0.7), one index per tier: ``build_ivf`` timed, a
     q = 8, top_k = 10 search checked against the plain version on the same
     plan, recall@10 against the brute kernel, the IVF kernel timed beside
     its bound (the probed bytes), its plain version and the brute kernel,
     one call's launches (1) and five calls' device kernels (the scan
     alone, after a memset), the search's device time split by
     torch.profiler (no merge kernel); then again with the adaptive margin
     off (a fixed n_probe 64 plan); each beside the earlier design's
     recorded time (EARLIER_MS, EARLIER_FIXED_MS);
  5d. the ops path at full size, on phase 5's and 5c's device tensors:
     ``fused_topk(q, x_bf16, bias, 10)`` (backend "auto", which must take
     the kernel), ``topk_int8`` at block_rows 2048, and ``ivf_topk`` /
     ``ivf_topk_int8`` on 5c's adaptive plan at its block_rows 1024; each
     checked against its plain version (merged and as candidates) and, on
     its live slots, against the pruned or DMA kernel on the same tensors
     (the same rows and scores; against the bf16 DMA kernel, which sums on
     the tensor cores, as compare_topk holds two bf16 results), then
     timed: brute the candidates kernel (CUDA events) beside its bound,
     the merge alone, its plain version and a one-call PyTorch yardstick;
     IVF the merged call (one kernel on the card and no sort, torch.profiler;
     held timer, L2 cold) beside its bound (the probed rows, the queries
     and the result), the earlier design (the candidates kernel and
     merge_blocks), the DMA kernel on the same plan and its plain version;
  5b. main path, full size, encoder: the default encoder embeds 128 texts
     at T = 512 (embeddings/s, the forward's device time and its split by
     kernel), and the same encoder with max_len 8192 embeds two long
     documents at T = 8192 (flash; the forward of the two, B = 2, timed
     and split by kernel); each kernel, on the last layer's
     tensors of its run, is held against its plain version and timed
     beside its bound, its plain version and scaled_dot_product_attention
     (the kernel and SDPA by two timers: time_ms, bursts of calls, and
     time_held_ms, one call's device time behind a spin of the card);
  5e. main path, full size, the ring: the default encoder with sp_mesh=4
     embeds 8 documents of ~3,500 words (T 4096, Tl 1024): embeddings/s,
     the forward's device time and its split by kernel, the same top-1
     neighbours as the unsharded forward at T = 4096 (blockwise) within
     ENC_TOL, and in f32 at T = 2048 within 2e-5; the hop kernel on the
     main path's tensors, then at [2, 12, 8192, 64] bf16 against 8192 keys
     (sp 4 over T = 32,768) timed beside its bound, its plain version, the
     efficient-attention call that returns (out, logsumexp) and EARLIER_MS;
  6. one JSON line, {"kernels": [{"name": ..., "route", "source",
     "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
     "bound_by", "library_ms"}, ...]}: one entry per kernel, thirteen;
  7. the last line: {"ok": true, "device": {...}}.

The main path's launch counts are set to 0 just before phases 4, 4b (a),
4c, 4d, 4e, 5, 5c, 5d, 5b and 5e drive it and read just after; launches made to
compare or time a kernel are not counted. Every phase prints its wall time.
"""

from __future__ import annotations

import argparse
import asyncio
import importlib
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
ATTENTION_NAMES = ("blockwise_attention", "flash_attention")
IVF_NAMES = {"bfloat16": "ivf_topk_dma", "int8": "ivf_topk_int8_dma", "int4": "ivf_topk_int4_dma"}
BLOCKS_NAMES = ("topk", "topk_int8", "ivf_topk", "ivf_topk_int8")
REPLACES = {  # the pallas_call of each TPU kernel
    "topk_pruned": "youtu_rag_tpu/ops/topk.py:299",
    "topk_int8_pruned": "youtu_rag_tpu/ops/topk.py:494",
    "topk_int4_pruned": "youtu_rag_tpu/ops/topk.py:665",
    "blockwise_attention": "youtu_rag_tpu/ops/attention.py:80",
    "flash_attention": "youtu_rag_tpu/ops/attention.py:307",
    "flash_attention_stats": "youtu_rag_tpu/ops/attention.py:229",
    "ivf_topk_dma": "youtu_rag_tpu/ops/ivf.py:461",
    "ivf_topk_int8_dma": "youtu_rag_tpu/ops/ivf.py:527",
    "ivf_topk_int4_dma": "youtu_rag_tpu/ops/ivf.py:596",
    "topk": "youtu_rag_tpu/ops/topk.py:174",
    "topk_int8": "youtu_rag_tpu/ops/topk.py:407",
    "ivf_topk": "youtu_rag_tpu/ops/ivf.py:103",
    "ivf_topk_int8": "youtu_rag_tpu/ops/ivf.py:188",
}
SOURCES = ("topk_pruned", "topk_int8_pruned", "topk_int4_pruned", "ivf_topk", "attention",
           "topk_blocks")
# Each redesigned kernel's time before its redesign, as PERF.md §6 records
# it (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W): the hop on the
# mma.sync kernel at [2, 12, 8192, 64] against 8192 keys, the brute int4
# scan on the __dp4a scorer (k = 64), the IVF scans on topk_select.cuh's
# scan with a merge launch after it (phase 5c's adaptive plan; int4 with
# the tensor-core scorer, k = 64).
EARLIER_MS = {"flash_attention_stats": 1.9755, "topk_int4_pruned": 0.4772,
              "ivf_topk_int4_dma": 0.1544, "ivf_topk_dma": 0.0918, "ivf_topk_int8_dma": 0.0879}
# ... and the IVF scans' on phase 5c's fixed plan
EARLIER_FIXED_MS = {"ivf_topk_dma": 0.4670, "ivf_topk_int8_dma": 0.3168,
                    "ivf_topk_int4_dma": 0.4119}

_phase_t0: list[tuple[str, float]] = []


def phase(name: str) -> None:
    """Start a phase; prints the wall time of the one before."""
    now = time.perf_counter()
    if _phase_t0:
        prev, t0 = _phase_t0[-1]
        print(f"-- phase {prev}: {now - t0:.1f} s wall", flush=True)
    _phase_t0.append((name.split()[0], now))
    print(f"== {name}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAIL: {msg}")


def ops():
    """The port's kernels by tier: (wrapper, plain version, quantizer)."""
    # by its path: youtu_rag_tpu_torch.ops.topk is also the name of a function
    t = importlib.import_module("youtu_rag_tpu_torch.ops.topk")

    return {
        "bfloat16": (t.topk_pruned, t.topk_pruned_reference, None),
        "int8": (t.topk_int8_pruned, t.topk_int8_pruned_reference, t.quantize_rows_int8),
        "int4": (t.topk_int4_pruned, t.topk_int4_pruned_reference, t.quantize_rows_int4),
    }


def attention_ops():
    """The attention kernels by name: (wrapper, plain version)."""
    from youtu_rag_tpu_torch.ops import attention as a

    return {"blockwise_attention": (a.blockwise_attention, a.blockwise_attention_reference),
            "flash_attention": (a.flash_attention, a.flash_attention_reference),
            "flash_attention_stats": (a.flash_attention_stats, a.flash_attention_stats_reference)}


def ivf_ops():
    """The port's IVF kernels by tier: (wrapper, plain version, quantizer)."""
    v = importlib.import_module("youtu_rag_tpu_torch.ops.ivf")
    t = importlib.import_module("youtu_rag_tpu_torch.ops.topk")

    return {
        "bfloat16": (v.ivf_topk_dma, v.ivf_topk_dma_reference, None),
        "int8": (v.ivf_topk_int8_dma, v.ivf_topk_int8_dma_reference, t.quantize_rows_int8),
        "int4": (v.ivf_topk_int4_dma, v.ivf_topk_int4_dma_reference, t.quantize_rows_int4),
    }


def blocks_ops():
    """The per-block kernels by name: (wrapper, plain version, tier, takes a plan)."""
    v = importlib.import_module("youtu_rag_tpu_torch.ops.ivf")
    t = importlib.import_module("youtu_rag_tpu_torch.ops.topk")

    return {"topk": (t.topk, t.topk_reference, "bfloat16", False),
            "topk_int8": (t.topk_int8, t.topk_int8_reference, "int8", False),
            "ivf_topk": (v.ivf_topk, v.ivf_topk_reference, "bfloat16", True),
            "ivf_topk_int8": (v.ivf_topk_int8, v.ivf_topk_int8_reference, "int8", True)}


def reset_launches() -> None:
    for wrapper, _, _ in [*ops().values(), *ivf_ops().values()]:
        wrapper.launches = 0
    for wrapper, _ in attention_ops().values():
        wrapper.launches = 0
    for wrapper, *_ in blocks_ops().values():
        wrapper.launches = 0


def blocks_counts() -> dict[str, int]:
    return {name: wrapper.launches for name, (wrapper, *_) in blocks_ops().items()}


def launch_counts() -> dict[str, int]:
    return {tier: wrapper.launches for tier, (wrapper, _, _) in ops().items()}


def ivf_counts() -> dict[str, int]:
    return {tier: wrapper.launches for tier, (wrapper, _, _) in ivf_ops().items()}


def attention_counts() -> dict[str, int]:
    return {name: wrapper.launches for name, (wrapper, _) in attention_ops().items()}


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
    threads = [threading.Thread(target=run, args=(n,)) for n in SOURCES]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for name in SOURCES:
        got = done[name]
        if isinstance(got, BaseException):
            raise SystemExit(f"FAIL: build of {name}: {got}")
        print(f"built {name} in {got['seconds']:.1f} s")
        print("\n".join(line for line in got["log"].splitlines()
                        if any(w in line for w in ("registers", "stack", "Compiling entry",
                                                   "warning"))))
    print(f"all builds: {time.perf_counter() - t0:.1f} s wall")
    from youtu_rag_tpu_torch.bench.ab_kernels import ptxas_report

    for name in ("attention", "topk_int4_pruned", "ivf_topk"):
        for kernel, regs, spills in ptxas_report(done[name]["log"]):
            if kernel.startswith(("attention", "ivf_tma")) or "Int4Scorer" in kernel:
                print(f"  {name}: {kernel}: {regs} registers, spill stores/loads {spills}")
    ivf_plan_table()


# the (d, k) grid of the TMA IVF entries' shared-memory plans (int4 takes
# d % 256 == 0: its first width is 256)
PLAN_WIDTHS = (128, 768, 1024, 2048, 4096, 8192)
PLAN_KS = (1, 10, 128, 1024, 2048, 4096)
TMA_ENTRIES = ("ivf_topk_bf16", "ivf_topk_int8", "ivf_topk_int4", "ivf_blocks_bf16",
               "ivf_blocks_int8")


def ivf_plan_table() -> None:
    """Per TMA IVF entry of csrc/ivf_topk.cu and (d, k): the CTAs one SM
    holds (``<entry>_ctas_per_sm``, before the wrapper's cap of 2) and the
    plan, rows x stages, "dev" where the lists live in device memory and
    "wide" where the query tile does. Fails where a cell has no plan."""
    from youtu_rag_tpu_torch.ops.ivf import _library, scan_plan

    lib = _library()
    print("IVF TMA plans, ctas_per_sm/rows x stages[ dev][ wide], k across:",
          " ".join(str(k) for k in PLAN_KS))
    for entry in TMA_ENTRIES:
        for d in PLAN_WIDTHS:
            if entry.endswith("int4") and d == 128:
                d = 256
            cells = []
            for k in PLAN_KS:
                per_sm = getattr(lib, f"{entry}_ctas_per_sm")(d, k)
                rows, stages, dev, wide = scan_plan(entry, d, k)
                check(per_sm >= 1 and rows > 0, f"{entry} d={d} k={k}: no plan ({per_sm})")
                cells.append(f"{per_sm}/{rows}x{stages}{' dev' if dev else ''}"
                             f"{' wide' if wide else ''}")
            print(f"  {entry} d={d}: " + ", ".join(cells))


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
# the int4 kernel alone (its tensor-core scorer takes 16-row warp tiles):
# d 256 (two chunk rounds) and 4096 (32), row counts that are not a
# multiple of 16 (the last warp tile of the last CTA partly past the end)
INT4_CASES = [(q, d, n, k) for q in (1, 8, 64) for d in (256, 4096) for n in (4099, 20011)
              for k in (1, 64, 1024)]


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
    kernel, plain, quantize = ops()["int4"]
    for q, d, n, k in INT4_CASES:
        x = unit(n, d)
        x[100:110] = x[5]
        queries = unit(q, d)
        queries[0] = x[5]
        bias = torch.zeros(n, device="cuda")
        bias[::7] = NEG_INF
        bias[3::11] = float("-inf")
        xt, xs = quantize(x)
        got = kernel(queries, xt, xs, bias, k)
        torch.cuda.synchronize()
        compare_exact(got, plain(queries, xt, xs, bias, k), f"int4 q={q} d={d} n={n} k={k}")
        ties = [r for r in (5, *range(100, 110)) if bias[r] == 0]
        top = got[1][0, : min(k, len(ties))].tolist()
        check(top == ties[: len(top)], f"int4 q={q} d={d} n={n} k={k}: tie order {top}")
    print(f"kernel vs plain: {len(cases)} cases x {len(TIERS)} kernels and {len(INT4_CASES)} "
          "int4 cases (d 256 and 4096, rows not a multiple of 16) ok, max_abs_err "
          + ", ".join(f"{KERNEL_NAMES[t]} {e}" for t, e in max_err.items()))
    return max_err


# ---------------------------------------------------------------------------
# 3b. kernel vs plain, attention
# ---------------------------------------------------------------------------

# (name, T, hd, dtype, layout): blockwise T 256 (two key tiles, fewer than
# the Hopper kernel's ring stages), 384 and 640 (tile counts the ring's
# stages do not divide); "strided" takes q, k and v as the encoder passes
# them, [B, T, H, hd] viewed through transpose(1, 2)
ATTN_CASES = [
    (name, t, hd, dtype, "contiguous")
    for name, ts in (("blockwise_attention", (256, 384, 512, 640, 4096)),
                     ("flash_attention", (4224, 8192)))
    for t in ts
    for hd in (64, 128)
    for dtype in (torch.bfloat16, torch.float32)
] + [
    (name, t, hd, dtype, "strided")
    for name, t in (("blockwise_attention", 512), ("flash_attention", 4224))
    for hd in (64, 128)
    for dtype in (torch.bfloat16, torch.float32)
]


def attention_inputs(b: int, h: int, t: int, hd: int, dtype, g, layout: str = "contiguous"):
    """q, k, v on the card and the encoder's -1e9 padding bias: row 0
    padded past t/2 + 3, the last batch row fully masked. "strided": q, k
    and v are [B, T, H, hd] tensors seen as [B, H, T, hd] (row stride
    H·hd), as the encoder's projections reach the kernels."""
    if layout == "strided":
        q, k, v = (torch.randn(b, t, h, hd, generator=g, device="cuda").to(dtype).transpose(1, 2)
                   for _ in range(3))
    else:
        q, k, v = (torch.randn(b, h, t, hd, generator=g, device="cuda").to(dtype)
                   for _ in range(3))
    mask = torch.ones(b, t, device="cuda")
    mask[0, t // 2 + 3 :] = 0
    mask[-1] = 0
    return q, k, v, (1.0 - mask) * -1e9


def compare_attention(got, want, what: str) -> float:
    """ATTN_TOL: bf16 within one bf16 ulp of the output (rtol 2^-7, atol
    2^-10 near zero): sums in another order, and flash's 64-key tiles
    against the JAX key blocks the plain version follows, move a value
    across a bf16 rounding; f32 within 1e-5 (the kernel splits each f32
    operand into three bf16 terms and sums the products in another order).
    Any NaN fails. Returns the max abs error."""
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check(got.dtype == want.dtype and got.shape == want.shape, f"{what}: dtype or shape")
    g, w = got.float(), want.float()
    rtol, atol = (2**-7, 2**-10) if got.dtype == torch.bfloat16 else (1e-5, 1e-5)
    bad = (g - w).abs() > atol + rtol * w.abs()
    err = float((g - w).abs().max())
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} outputs beyond tolerance, max {err}")
    return err


def attention_cases(seed: int) -> dict[str, float]:
    g = torch.Generator(device="cuda").manual_seed(seed)
    kernels = attention_ops()
    max_err = dict.fromkeys(kernels, 0.0)
    for name, t, hd, dtype, layout in ATTN_CASES:
        kernel, plain = kernels[name]
        args = attention_inputs(3, 2, t, hd, dtype, g, layout)
        got = kernel(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        what = f"{name} T={t} hd={hd} {str(dtype)[6:]} {layout}"
        max_err[name] = max(max_err[name], compare_attention(got, want, what))
    print(f"attention kernel vs plain: {len(ATTN_CASES)} cases ok, max_abs_err "
          + ", ".join(f"{n} {e}" for n, e in max_err.items()))
    return max_err


# ---------------------------------------------------------------------------
# 3c. kernel vs plain, IVF
# ---------------------------------------------------------------------------

IVF_N, IVF_D = 65536, 256
IVF_CASES = [(q, k, br) for q in (1, 8, 64) for k in (1, 10, 128, 129, 1024)
             for br in (64, 1024, 4096)]
IVF_GARBAGE = 1 << 28  # an id past n_valid that points far outside the index
# the int4 kernel alone at block_rows 4, 8 and 12: its 32-row stages and
# 16-row groups straddle blocks (IVF4_N rows: a multiple of 12 and of 16)
IVF4_N = 49152
IVF4_CASES = [(q, k, br) for q in (8, 64) for k in (1, 64, 1024, 2048) for br in (4, 8, 12)]
# the three kernels (csrc/ivf_scan_tma.cuh) alone: query counts around the
# 8-query tiles and the 64 of a launch, k in the three list classes,
# block_rows 4 and 12 (a 32-row stage spans several blocks) and 4096;
# queries f32 with ids ascending, or bf16 with ids shuffled; query row 1 is
# zero (its int8 scale 1e-12 / 127)
IVF_TMA_CASES = [(q, k, br, qdtype, order) for q in (1, 7, 9, 65) for k in (1, 129, 1025)
                 for br in (4, 12, 4096) for qdtype, order in (("f32", "sorted"),
                                                              ("bf16", "shuffled"))]


def ivf_plan(n_blocks: int, n_valid: int, g, order: str = "sorted"
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """A plan of max_blocks = n_blocks ids: n_valid probed blocks in
    ascending id (or shuffled; blocks 0 and 1, which hold the exact ties,
    among them), then garbage ids the kernel must never read."""
    rest = torch.randperm(n_blocks - 2, generator=g, device="cuda")[: max(n_valid - 2, 0)] + 2
    chosen = torch.cat([torch.arange(min(n_valid, 2), device="cuda"), rest])
    if order == "sorted":
        chosen = torch.sort(chosen)[0]
    else:
        chosen = chosen[torch.randperm(chosen.numel(), generator=g, device="cuda")]
    ids = torch.full((n_blocks,), IVF_GARBAGE, dtype=torch.int32, device="cuda")
    ids[:n_valid] = chosen.to(torch.int32)
    return ids, torch.tensor(n_valid, dtype=torch.int32, device="cuda")


def compare_ivf(tier: str, got, want, full_scores, what: str) -> float:
    """compare_topk / compare_exact on the live slots, and every other slot
    (NEG_INF, row 0) in both."""
    from youtu_rag_tpu_torch.ops.topk import NEG_INF

    for res in (got, want):
        s, i = (t.cpu() for t in res)
        dead = s <= NEG_INF / 2
        check(bool((s[dead] == NEG_INF).all() and (i[dead] == 0).all()),
              f"{what}: an empty slot is not (NEG_INF, 0)")
    if tier == "bfloat16":
        return compare_topk(got, want, full_scores, what)
    return compare_exact(got, want, what)


def ivf_kernel_cases(seed: int) -> dict[str, float]:
    from youtu_rag_tpu_torch.ops.topk import NEG_INF

    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    x = torch.randn(IVF_N, IVF_D, generator=g, device="cuda")
    x /= x.norm(dim=1, keepdim=True)
    x[100:110] = x[5]  # exact ties, in blocks 0 and 1 at every block_rows
    bias = torch.zeros(IVF_N, device="cuda")
    bias[::7] = NEG_INF
    bias[3::11] = float("-inf")
    bias[104] = NEG_INF
    sparse = torch.full((IVF_N,), NEG_INF, device="cuda")
    sparse[torch.arange(3, IVF_N, IVF_N // 5, device="cuda")] = 0.0  # 5 live rows
    ties = [r for r in (5, *range(100, 110)) if bias[r] == 0]
    stored = {}  # tier → (stored rows, scales as extra arguments)
    for tier, (_, _, quantize) in ivf_ops().items():
        if quantize is None:
            stored[tier] = (x.to(torch.bfloat16), ())
        else:
            xq, xs = quantize(x)
            stored[tier] = (xq, (xs,))
    cases = [(q, k, br, IVF_N // br // 2, "mixed") for q, k, br in IVF_CASES]
    for br in (64, 1024, 4096):
        nb = IVF_N // br
        cases += [(8, 10, br, 0, "mixed"), (8, 10, br, 1, "mixed"), (8, 129, br, nb, "mixed"),
                  (8, 50, br, nb, "sparse"), (64, 1024, br, 2, "mixed")]
    max_err = dict.fromkeys(TIERS, 0.0)
    for q, k, br, n_valid, kind in cases:
        queries = torch.randn(q, IVF_D, generator=g, device="cuda")
        queries /= queries.norm(dim=1, keepdim=True)
        queries[0] = x[5]
        ids, nv = ivf_plan(IVF_N // br, n_valid, g)
        b = bias if kind == "mixed" else sparse
        full = plain_scores(queries, stored["bfloat16"][0], b).cpu()
        for tier, (kernel, plain, _) in ivf_ops().items():
            xt, extra = stored[tier]
            what = f"ivf {tier} q={q} k={k} block_rows={br} n_valid={n_valid} {kind}"
            got = kernel(queries, xt, *extra, b, ids, nv, k, block_rows=br)
            torch.cuda.synchronize()
            want = plain(queries, xt, *extra, b, ids, nv, k, block_rows=br)
            max_err[tier] = max(max_err[tier], compare_ivf(tier, got, want, full, what))
            if kind == "mixed" and n_valid >= 2 and tier != "bfloat16":
                top = got[1][0, : min(k, len(ties))].tolist()
                check(top == ties[: len(top)], f"{what}: tie order {top}")
            if n_valid == 0:
                check(bool((got[0] == NEG_INF).all()), f"{what}: an empty plan returned rows")
    kernel, plain, quantize = ivf_ops()["int4"]
    x4, s4 = quantize(x[:IVF4_N])
    b4 = bias[:IVF4_N]
    for q, k, br in IVF4_CASES:
        queries = torch.randn(q, IVF_D, generator=g, device="cuda")
        queries /= queries.norm(dim=1, keepdim=True)
        queries[0] = x[5]
        ids, nv = ivf_plan(IVF4_N // br, IVF4_N // br // 2, g)
        what = f"ivf int4 q={q} k={k} block_rows={br}"
        got = kernel(queries, x4, s4, b4, ids, nv, k, block_rows=br)
        torch.cuda.synchronize()
        want = plain(queries, x4, s4, b4, ids, nv, k, block_rows=br)
        compare_ivf("int4", got, want, None, what)
    for q, k, br, qdtype, order in IVF_TMA_CASES:
        queries = torch.randn(q, IVF_D, generator=g, device="cuda")
        queries /= queries.norm(dim=1, keepdim=True)
        queries[0] = x[5]
        if q > 1:
            queries[1] = 0.0
        if qdtype == "bf16":
            queries = queries.to(torch.bfloat16)
        n = IVF_N - IVF_N % br  # the rows that whole blocks cover
        ids, nv = ivf_plan(n // br, n // br // 2, g, order)
        b = bias[:n]
        full = plain_scores(queries, stored["bfloat16"][0][:n], b).cpu()
        for tier in TIERS:
            kernel, plain, _ = ivf_ops()[tier]
            xt, extra = stored[tier]
            xt, extra = xt[:n], tuple(e[:n] for e in extra)
            what = f"ivf {tier} q={q} k={k} block_rows={br} {qdtype} queries, ids {order}"
            before = kernel.launches
            got = kernel(queries, xt, *extra, b, ids, nv, k, block_rows=br)
            torch.cuda.synchronize()
            check(kernel.launches - before == -(-q // 64), f"{what}: launches")
            want = plain(queries, xt, *extra, b, ids, nv, k, block_rows=br)
            max_err[tier] = max(max_err[tier], compare_ivf(tier, got, want, full, what))
    print(f"IVF kernel vs plain: {len(cases)} cases x {len(TIERS)} kernels, {len(IVF4_CASES)} "
          f"int4 cases (block_rows 4, 8, 12) and {len(IVF_TMA_CASES)} cases x 3 kernels "
          "(ivf_scan_tma.cuh: q 1-65, k to 1025, block_rows 4, 12, 4096, bf16 queries, a zero "
          "query, shuffled ids) ok, max_abs_err "
          + ", ".join(f"{IVF_NAMES[t]} {e}" for t, e in max_err.items()))
    return max_err


# ---------------------------------------------------------------------------
# 3f. kernel vs plain, IVF: any block_rows and alignment, wide rows
# ---------------------------------------------------------------------------

# block_rows off 4-row boundaries (JAX asks only that they divide the rows),
# each with k = 1, 10 (at most block_rows) and block_rows
REPAIR_BLOCK_ROWS = (1, 2, 6, 66, 1026)
# (d, k): where the lists or the query tile outgrow shared memory
WIDE_CASES = ((4096, 1024), (8192, 1024), (8192, 4096), (4096, 10))


def _offset(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` that starts 4 bytes past a 16-byte boundary."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    out.copy_(t)
    return out


def ivf_repair_cases(seed: int) -> dict[str, float]:
    """3f: (i) the three DMA entries at block_rows 1, 2, 6, 66 and 1026 with
    bias and scales 4 bytes past a 16-byte boundary, k up to block_rows;
    (ii) the three DMA entries and the bf16 and int8 merged per-block
    entries at d 4096 and 8192, k up to 4096 (device lists; bf16 at d =
    8192 the wide plan). Each
    against its plain version: rows equal, bf16 within TOL, int8/int4
    bit-equal. Returns the max abs error per kernel name."""
    from youtu_rag_tpu_torch.ops.topk import NEG_INF

    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    err: dict[str, float] = {}
    n_cases = 0
    d = IVF_D
    for br in REPAIR_BLOCK_ROWS:
        n = br * max(8, 8208 // br)
        x = torch.randn(n, d, generator=g, device="cuda")
        x /= x.norm(dim=1, keepdim=True)
        bias = torch.zeros(n, device="cuda")
        bias[::7] = NEG_INF
        bias[3::11] = float("-inf")
        bias = _offset(bias)
        ids, nv = ivf_plan(n // br, n // br // 2, g, "shuffled")
        queries = torch.randn(9, d, generator=g, device="cuda")
        queries /= queries.norm(dim=1, keepdim=True)
        full = plain_scores(queries, x.to(torch.bfloat16), bias).cpu()
        for tier, (kernel, plain, quantize) in ivf_ops().items():
            if quantize is None:
                xt, extra = x.to(torch.bfloat16), ()
            else:
                xt, xs = quantize(x)
                extra = (_offset(xs),)
            check(bias.data_ptr() % 16 == 4 and all(e.data_ptr() % 16 == 4 for e in extra),
                  "3f: the bias and scales must start 4 bytes past a 16-byte boundary")
            for k in sorted({1, min(10, br), br}):
                what = f"ivf {tier} block_rows={br} k={k}, bias and scales at +4 bytes"
                got = kernel(queries, xt, *extra, bias, ids, nv, k, block_rows=br)
                torch.cuda.synchronize()
                want = plain(queries, xt, *extra, bias, ids, nv, k, block_rows=br)
                name = IVF_NAMES[tier]
                err[name] = max(err.get(name, 0.0), compare_ivf(tier, got, want, full, what))
                n_cases += 1
    blocks = blocks_ops()
    for wd, k in WIDE_CASES:
        n, br = 3 * 4096, 4096
        x = torch.randn(n, wd, generator=g, device="cuda")
        x /= x.norm(dim=1, keepdim=True)
        bias = torch.zeros(n, device="cuda")
        bias[::5] = NEG_INF
        queries = torch.randn(9, wd, generator=g, device="cuda")
        queries /= queries.norm(dim=1, keepdim=True)
        ids = torch.tensor([2, 0, 1], dtype=torch.int32, device="cuda")
        nv = torch.tensor(2, dtype=torch.int32, device="cuda")
        full = plain_scores(queries, x.to(torch.bfloat16), bias).cpu()
        for tier in TIERS:
            kernel, plain, quantize = ivf_ops()[tier]
            if quantize is None:
                xt, extra = x.to(torch.bfloat16), ()
            else:
                xq, xs = quantize(x)
                xt, extra = xq, (xs,)
            what = f"ivf {tier} d={wd} k={k}"
            got = kernel(queries, xt, *extra, bias, ids, nv, k, block_rows=br)
            torch.cuda.synchronize()
            want = plain(queries, xt, *extra, bias, ids, nv, k, block_rows=br)
            name = IVF_NAMES[tier]
            err[name] = max(err.get(name, 0.0), compare_ivf(tier, got, want, full, what))
            n_cases += 1
            if tier == "int4":  # no per-block int4 kernel (JAX has none)
                continue
            name = "ivf_topk" if tier == "bfloat16" else "ivf_topk_int8"
            kernel, plain = blocks[name][:2]
            got = kernel(queries, xt, *extra, bias, ids, nv, k, block_rows=br)
            torch.cuda.synchronize()
            want = plain(queries, xt, *extra, bias, ids, nv, k, block_rows=br)
            tier_b = "bf16" if tier == "bfloat16" else "int8"
            err[name] = max(err.get(name, 0.0),
                            compare_blocks(tier_b, got, want, full, f"{name} d={wd} k={k}"))
            n_cases += 1
        del x, full
    print(f"IVF any block_rows and alignment, wide rows: {n_cases} cases ok (block_rows "
          f"{REPAIR_BLOCK_ROWS} at +4-byte bias and scales; (d, k) {WIDE_CASES}), max_abs_err "
          + ", ".join(f"{n} {e}" for n, e in err.items()))
    return err


# ---------------------------------------------------------------------------
# 3d. kernel vs plain, per-block
# ---------------------------------------------------------------------------

BLOCKS_N, BLOCKS_D = 65536, 256
BLOCK_TIES = (5, 5000, 20000, 40000)  # copies of row 5, in four blocks at every block_rows
# (q, k, block_rows, bias kind, plan): plan None (brute) or (n_valid, id order);
# n_valid "only" is a plan of one listed block
BLOCKS_CASES = (
    [(q, k, 1024, "mixed", None) for q in (1, 8, 64) for k in (1, 10, 128, 129, 1024)]
    + [(8, k, br, "mixed", None) for br in (256, 2048, 4096) for k in (10, 129)]
    + [(8, k, 1024, kind, None) for kind in ("sparse", "allinf0", "none") for k in (10, 128)]
    + [(8, 10, br, "mixed", (nv, order)) for br in (256, 1024, 4096)
       for nv in ("0", "1", "half", "max") for order in ("ascending", "shuffled")]
    + [(q, k, 1024, "mixed", ("half", "shuffled")) for q, k in ((1, 1), (64, 128), (8, 129),
                                                               (8, 1024))]
    + [(8, k, 1024, kind, ("half", "shuffled")) for kind in ("sparse", "allinf0", "none")
       for k in (10, 128)]
    # block_rows 4, 6 and 12 (a 32-row stage spans several blocks; at 6 runs
    # start off 4-row boundaries, so the merged kernel copies bias and scales
    # element by element) and k = block_rows
    + [(8, k, br, kind, plan) for br in (4, 6, 12) for k in (1, br)
       for kind in ("mixed", "deadcols") for plan in (("half", "shuffled"), ("max", "ascending"))]
    + [(8, 256, 256, kind, ("half", "shuffled")) for kind in ("mixed", "deadcols")]
    # no live row, position 0 (block 0) scoring -inf throughout: the tail's
    # last slot comes from position 1 (k a multiple of 128), from the pad
    # (k = 10) or is position 0's -inf entry (one listed block)
    + [(8, k, br, "allinf0dead", (nv, "ascending"))
       for k, br, nv in ((128, 256, "max"), (128, 4096, "max"), (1024, 1024, "1"),
                         (10, 256, "half"), (128, 256, "only"))]
)


def compare_blocks(tier: str, got, want, full, what: str) -> float:
    """Per-block results, candidates [blocks, q, k_pad] or merged [q, k]:
    the same live slots; every other slot (the fill and the pad) the same
    row and the same score bits; int8 live slots the same rows and score
    bits; bf16 live slots scores within TOL and the same rows, except that
    a slot may hold another row whose plain score (``full`` [q, N]) is
    within TOL of the plain version's there (two rows that close may swap
    when the sums run in another order). Returns the max abs score error."""
    from youtu_rag_tpu_torch.ops.topk import NEG_INF

    gs, gi = (t.cpu() for t in got)
    ws, wi = (t.cpu() for t in want)
    check(gs.shape == ws.shape and gi.shape == wi.shape, f"{what}: shapes {gs.shape} {ws.shape}")
    live = ws > NEG_INF / 2
    check(torch.equal(gs > NEG_INF / 2, live), f"{what}: live slots differ")
    check(torch.equal(gi[~live], wi[~live]), f"{what}: a fill or pad slot holds another row")
    check(torch.equal(gs[~live].view(torch.int32), ws[~live].view(torch.int32)),
          f"{what}: a fill or pad slot holds another score")
    if tier == "int8":
        check(torch.equal(gi, wi), f"{what}: rows differ")
        check(torch.equal(gs.view(torch.int32), ws.view(torch.int32)), f"{what}: scores not bit-equal")
        return 0.0
    if not bool(live.any()):
        return 0.0
    err = float((gs[live] - ws[live]).abs().max())
    check(err <= TOL, f"{what}: score error {err} > {TOL}")
    swapped = live & (gi != wi)
    if bool(swapped.any()):
        qidx = torch.arange(gi.shape[-2])[:, None].expand(gi.shape[-2:]).expand(gi.shape)
        alt = full[qidx[swapped], gi[swapped].long()]
        gap = float((alt - ws[swapped]).abs().max())
        check(gap <= TOL, f"{what}: {int(swapped.sum())} rows differ beyond near-ties ({gap})")
    return err


def blocks_plan(nb: int, nv_kind: str, order: str, g) -> tuple[torch.Tensor, torch.Tensor, int]:
    """A plan over nb blocks: max_blocks = 3/4 of them (at least 1), every
    id in range as the probe plan lists them, block 0 (a block scoring -inf
    throughout in the allinf0 bias) among the first n_valid; those first
    n_valid ascending or shuffled. Returns (ids, n_valid tensor, n_valid)."""
    mb = 1 if nv_kind == "only" else max(1, 3 * nb // 4)
    nv = {"0": 0, "1": 1, "half": mb // 2, "max": mb, "only": 1}[nv_kind]
    perm = torch.cat([torch.zeros(1, dtype=torch.long, device="cuda"),
                      torch.randperm(nb - 1, generator=g, device="cuda") + 1])[:mb]
    head = perm[:nv]
    head = torch.sort(head)[0] if order == "ascending" else head[
        torch.randperm(nv, generator=g, device="cuda")]
    ids = torch.cat([head, perm[nv:]]).to(torch.int32)
    return ids, torch.tensor(nv, dtype=torch.int32, device="cuda"), nv


def blocks_kernel_cases(seed: int) -> dict[str, float]:
    from youtu_rag_tpu_torch.ops.topk import NEG_INF, fused_topk, merge_blocks, quantize_rows_int8

    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    n = BLOCKS_N
    x = torch.randn(n, BLOCKS_D, generator=g, device="cuda")
    x /= x.norm(dim=1, keepdim=True)
    x[list(BLOCK_TIES[1:])] = x[BLOCK_TIES[0]].clone()
    mixed = torch.zeros(n, device="cuda")
    mixed[::7] = NEG_INF
    mixed[3::11] = float("-inf")
    sparse = torch.full((n,), NEG_INF, device="cuda")
    sparse[:3] = float("-inf")
    sparse[torch.arange(3, n, n // 5, device="cuda")] = 0.0  # 5 live rows
    allinf0 = mixed.clone()
    allinf0[:4096] = float("-inf")  # block 0 at every block_rows scores -inf throughout
    # no live row: NEG_INF, except rows 0-4095 -inf and columns 0-2 of every
    # 4096-row block past them (block 1's lowest column scoring NEG_INF is 3)
    allinf0dead = torch.full((n,), NEG_INF, device="cuda")
    allinf0dead[torch.arange(n, device="cuda") % 4096 < 3] = float("-inf")
    allinf0dead[:4096] = float("-inf")
    # five live rows; rows r % 256 < 3 -inf, the rest NEG_INF (the fill of a
    # block whose first columns score -inf is its column 3, or 0 at block_rows 4)
    deadcols = torch.full((n,), NEG_INF, device="cuda")
    deadcols[torch.arange(n, device="cuda") % 256 < 3] = float("-inf")
    deadcols[torch.arange(100, n, n // 5, device="cuda")] = 0.0
    biases = {"mixed": mixed, "sparse": sparse, "allinf0": allinf0, "allinf0dead": allinf0dead,
              "deadcols": deadcols, "none": torch.full((n,), NEG_INF, device="cuda")}
    xq, xs = quantize_rows_int8(x)
    stored = {"bfloat16": (x.to(torch.bfloat16), ()), "int8": (xq, (xs,))}
    max_err = dict.fromkeys(BLOCKS_NAMES, 0.0)
    n_checked = 0
    for q, k, br, kind, plan_kind in BLOCKS_CASES:
        nr = n - n % br  # the rows whole blocks cover
        queries = torch.randn(q, BLOCKS_D, generator=g, device="cuda")
        queries /= queries.norm(dim=1, keepdim=True)
        queries[0] = x[BLOCK_TIES[0]]
        b = biases[kind][:nr]
        full = plain_scores(queries, stored["bfloat16"][0][:nr], b).cpu()
        plan, probe = (), None
        if plan_kind is not None:
            ids, nv, n_valid = blocks_plan(nr // br, *plan_kind, g)
            plan = (ids, nv)
            probe = ids[:n_valid].tolist()
        for name, (kernel, plain, tier, ivf) in blocks_ops().items():
            if ivf != (plan_kind is not None):
                continue
            xt, extra = stored[tier]
            xt, extra = xt[:nr], tuple(e[:nr] for e in extra)
            args = (queries, xt, *extra, b, *plan, k)
            what = f"{name} q={q} k={k} block_rows={br} {kind} plan={plan_kind}"
            got = kernel(*args, block_rows=br, candidates=True)
            torch.cuda.synchronize()
            want = plain(*args, block_rows=br, candidates=True)
            err = compare_blocks(tier, got, want, full, what + " candidates")
            if name == "topk":
                merged = merge_blocks(*got, k)
                ref = fused_topk(queries, xt, b, k, block_rows=br, backend="pallas_interpret")
            elif not ivf:
                merged, ref = merge_blocks(*got, k), merge_blocks(*want, k)
            else:  # the merged call: csrc/ivf_scan_tma.cuh's per-block entry, one launch
                before = kernel.launches
                merged = kernel(*args, block_rows=br)
                torch.cuda.synchronize()
                check(kernel.launches - before == -(-q // 64), f"{what}: merged call's launches")
                ref = merge_blocks(*want, k)
            err = max(err, compare_blocks(tier, merged, ref, full, what))
            if kind == "mixed" and k >= len(BLOCK_TIES):
                # exact ties in position order: block order, or probe order
                live = [r for r in BLOCK_TIES if b[r] == 0]
                ties = (live if probe is None else
                        [r for p in probe for r in live if r // br == p])
                top = merged[1][0, : len(ties)].tolist()
                check(top == ties, f"{what}: tie order {top}, expected {ties}")
            max_err[name] = max(max_err[name], err)
            n_checked += 1
    torch.cuda.synchronize()
    print(f"per-block kernel vs plain: {len(BLOCKS_CASES)} cases, {n_checked} kernel checks ok "
          "(candidates, and merged: IVF through the merged kernel; block_rows 4-4096, k to 1024 "
          "and k = block_rows, tails past position 0), max_abs_err "
          + ", ".join(f"{name} {e}" for name, e in max_err.items()))
    return max_err


# ---------------------------------------------------------------------------
# 3 (continued). any query count, k above 1024
# ---------------------------------------------------------------------------

QUERY_COUNTS = (0, 65, 100, 130)  # around and past the 64 queries of one launch
BIG_K = {"bfloat16": (2048, 4096), "int8": (8192,), "int4": (2048, 4096)}


def all_topk_wrappers() -> dict:
    """Every top-k wrapper: name → (wrapper, plain version, tier, kind);
    kind "brute", "ivf" (a plan, merged) or "blocks"/"ivf_blocks"."""
    out = {KERNEL_NAMES[t]: (w, p, t, "brute") for t, (w, p, _) in ops().items()}
    out.update({IVF_NAMES[t]: (w, p, t, "ivf") for t, (w, p, _) in ivf_ops().items()})
    out.update({name: (w, p, tier, "ivf_blocks" if plan else "blocks")
                for name, (w, p, tier, plan) in blocks_ops().items()})
    return out


def wrapper_args(tier: str, kind: str, stored: dict, bias, plan):
    """The arguments after the queries and before k, and the keywords."""
    x, extra = stored[tier]
    kw = {} if kind == "brute" else {"block_rows": plan[2]}
    return (x, *extra, bias, *(plan[:2] if kind in ("ivf", "ivf_blocks") else ())), kw


def compare_tier(tier: str, got, want, full, what: str) -> float:
    if tier == "bfloat16":
        return compare_topk(got, want, full, what)
    return compare_exact(got, want, what)


def query_k_cases(seed: int) -> dict[str, float]:
    """q = 0 (no launch, an empty result), 65, 100 and 130 (one launch per
    64 queries) through every top-k wrapper; k = 2048 / 4096 (bf16, int4)
    and 8192 (int8) through the pruned kernels, and k = 2048 through one
    IVF and one per-block case (the device-memory list class). Each held to
    its plain version on the same tensors."""
    from youtu_rag_tpu_torch.ops.topk import NEG_INF, quantize_rows_int4, quantize_rows_int8

    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    n, d = 65536, 256
    x = torch.randn(n, d, generator=g, device="cuda")
    x /= x.norm(dim=1, keepdim=True)
    bias = torch.zeros(n, device="cuda")
    bias[::7] = NEG_INF
    bias[3::11] = float("-inf")
    stored = {"bfloat16": (x.to(torch.bfloat16), ()), "int8": (lambda t: (t[0], (t[1],)))(
        quantize_rows_int8(x)), "int4": (lambda t: (t[0], (t[1],)))(quantize_rows_int4(x))}
    ids, nv = ivf_plan(n // 1024, n // 1024 // 2, g)
    plan = (ids, nv, 1024)
    max_err = {}
    wrappers = all_topk_wrappers()
    n_checked = 0
    for qn in QUERY_COUNTS:
        queries = torch.randn(qn, d, generator=g, device="cuda")
        queries /= queries.norm(dim=1, keepdim=True).clamp_min(1e-12)
        full = plain_scores(queries, stored["bfloat16"][0], bias).cpu()
        for name, (wrapper, plain, tier, kind) in wrappers.items():
            args, kw = wrapper_args(tier, kind, stored, bias, plan)
            what = f"{name} q={qn}"
            before = wrapper.launches
            got = wrapper(queries, *args, 10, **kw)
            torch.cuda.synchronize()
            launched = wrapper.launches - before
            check(launched == -(-qn // 64), f"{what}: {launched} launches, want {-(-qn // 64)}")
            want = plain(queries, *args, 10, **kw)
            check(tuple(got[0].shape) == tuple(want[0].shape) == (qn, 10),
                  f"{what}: shapes {tuple(got[0].shape)} {tuple(want[0].shape)}")
            if kind in ("blocks", "ivf_blocks"):
                err = compare_blocks(tier, got, want, full, what)
                cand = wrapper(queries, *args, 10, candidates=True, **kw)
                cand_want = plain(queries, *args, 10, candidates=True, **kw)
                check(cand[0].shape[1] == qn, f"{what}: candidates {tuple(cand[0].shape)}")
                err = max(err, compare_blocks(tier, cand, cand_want, full, what + " candidates"))
            else:
                err = compare_tier(tier, got, want, full, what) if qn else 0.0
            max_err[name] = max(max_err.get(name, 0.0), err)
            n_checked += 1
    big = [(tier, k, qn) for tier, ks in BIG_K.items() for k in ks for qn in (8, 65)]
    for tier, k, qn in big:
        queries = torch.randn(qn, d, generator=g, device="cuda")
        queries /= queries.norm(dim=1, keepdim=True)
        full = plain_scores(queries, stored["bfloat16"][0], bias).cpu()
        name = KERNEL_NAMES[tier]
        wrapper, plain, _, _ = wrappers[name]
        args, _ = wrapper_args(tier, "brute", stored, bias, plan)
        got = wrapper(queries, *args, k)
        torch.cuda.synchronize()
        err = compare_tier(tier, got, plain(queries, *args, k), full, f"{name} q={qn} k={k}")
        max_err[name] = max(max_err[name], err)
        n_checked += 1
    queries = torch.randn(8, d, generator=g, device="cuda")
    queries /= queries.norm(dim=1, keepdim=True)
    full = plain_scores(queries, stored["bfloat16"][0], bias).cpu()
    # the per-block IVF wrappers: the candidates (csrc/topk_blocks.cu) and
    # the merged call (csrc/ivf_scan_tma.cuh) in the shared and device list
    # classes, k = block_rows included
    big_blocks = [("ivf_topk_dma", 2048, 1024, False), ("topk", 2048, 4096, True),
                  ("ivf_topk_int8", 2048, 4096, True), ("ivf_topk_int8", 2048, 4096, False),
                  ("ivf_topk", 1024, 4096, False), ("ivf_topk", 4096, 4096, False)]
    for name, k, br, cand in big_blocks:
        wrapper, plain, tier, kind = wrappers[name]
        kplan = plan if br == 1024 else (*ivf_plan(n // br, n // br // 2, g), br)
        args, kw = wrapper_args(tier, kind, stored, bias, kplan)
        if "blocks" in kind:
            kw["candidates"] = cand
        what = f"{name} q=8 k={k} block_rows={br}" + (" candidates" if cand else "")
        got = wrapper(queries, *args, k, **kw)
        torch.cuda.synchronize()
        want = plain(queries, *args, k, **kw)
        err = (compare_blocks(tier, got, want, full, what) if "blocks" in kind
               else compare_ivf(tier, got, want, full, what))
        max_err[name] = max(max_err[name], err)
        n_checked += 1
    print(f"any q and k above 1024: {n_checked} checks ok (q {QUERY_COUNTS} through "
          f"{len(wrappers)} wrappers, the per-block IVF ones merged by their kernel and as "
          f"candidates; k {BIG_K} brute; k 2048 IVF, per-block k 1024-4096), max_abs_err "
          + ", ".join(f"{n} {e}" for n, e in max_err.items()))
    return max_err


# ---------------------------------------------------------------------------
# 3e. kernel vs plain, the ring hop
# ---------------------------------------------------------------------------

# (T, T_kv, bias kind, hd, dtype, layout, B, H): "mixed" pads row 0's keys
# past T_kv / 2 + 3 and masks the last row throughout; "allpad" masks every
# key of the span (the encoder's -1e9: m is about -1e9, not -1e30); T_kv =
# 128 is one key tile (the Hopper kernel's peeled tile is also its last);
# "strided" takes q, k, v as the encoder's [B, T, H, hd] views; [16, 12,
# 512, 64] gives 768 work items, several per CTA of the persistent grid
STATS_CASES = [(t, t_kv, kind, hd, dtype, "contiguous", 3, 2)
               for t, t_kv, kind in ((128, 128, "mixed"), (256, 256, "mixed"),
                                     (1024, 1024, "mixed"), (8192, 8192, "mixed"),
                                     (1024, 128, "mixed"), (1024, 512, "mixed"),
                                     (1024, 4096, "mixed"), (1024, 512, "allpad"),
                                     (1024, 128, "allpad"))
               for hd in (64, 128) for dtype in (torch.bfloat16, torch.float32)]
STATS_CASES += [(1024, t_kv, "mixed", hd, dtype, "strided", 3, 2) for t_kv in (1024, 512)
                for hd in (64, 128) for dtype in (torch.bfloat16, torch.float32)]
STATS_CASES += [(512, 512, "mixed", 64, torch.bfloat16, "contiguous", 16, 12)]


def compare_stats(got, want, what: str) -> float:
    """m within f32 summation order (1e-5 absolute plus 1e-6 relative), l
    and acc / l within the flash entry's tolerance (bf16 one bf16 ulp,
    rtol 2^-7 and 2^-10 absolute; f32 1e-5, l relative); no NaN. Returns
    the max abs error of acc / l."""
    (ga, gm, gl), (wa, wm, wl) = got, want
    for t in (ga, gm, gl):
        check(bool(torch.isfinite(t).all()), f"{what}: non-finite acc, m or l")
    check(ga.dtype == gm.dtype == gl.dtype == torch.float32, f"{what}: dtypes")
    check(ga.shape == wa.shape and gm.shape == wm.shape == gl.shape, f"{what}: shapes")
    dm = (gm - wm).abs()
    check(bool((dm <= 1e-5 + 1e-6 * wm.abs()).all()), f"{what}: m differs by {float(dm.max())}")
    rtol = 2**-7 if what.endswith("bfloat16") else 1e-5
    dl = (gl - wl).abs() / wl.abs()
    check(bool((dl <= rtol).all()), f"{what}: l differs by {float(dl.max())} relative")
    go, wo = ga / gl[..., None], wa / wl[..., None]
    atol = 2**-10 if rtol > 1e-5 else 1e-5
    bad = (go - wo).abs() > atol + rtol * wo.abs()
    err = float((go - wo).abs().max())
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} acc / l beyond tolerance, max {err}")
    return err


def stats_inputs(t: int, t_kv: int, kind: str, hd: int, dtype, g, layout: str = "contiguous",
                 b: int = 3, h: int = 2):
    if layout == "strided":  # [B, T, H, hd] seen as [B, H, T, hd], as the encoder passes them
        q = torch.randn(b, t, h, hd, generator=g, device="cuda").to(dtype).transpose(1, 2)
        k, v = (torch.randn(b, t_kv, h, hd, generator=g, device="cuda").to(dtype).transpose(1, 2)
                for _ in range(2))
    else:
        q = torch.randn(b, h, t, hd, generator=g, device="cuda").to(dtype)
        k, v = (torch.randn(b, h, t_kv, hd, generator=g, device="cuda").to(dtype)
                for _ in range(2))
    mask = torch.ones(b, t_kv, device="cuda")
    if kind == "mixed":
        mask[0, t_kv // 2 + 3 :] = 0
        mask[-1] = 0
    else:
        mask[:] = 0
    return q, k, v, (1.0 - mask) * -1e9


def combine_hops(hops, dtype):
    """The ring's combine of (acc, m, l) hops, then the divide."""
    acc, m, l = hops[0]
    for acc_h, m_h, l_h in hops[1:]:
        m_new = torch.maximum(m, m_h)
        a_old, a_hop = torch.exp(m - m_new), torch.exp(m_h - m_new)
        l = l * a_old + l_h * a_hop
        acc = acc * a_old[..., None] + acc_h * a_hop[..., None]
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(dtype)


def stats_cases(seed: int) -> float:
    from youtu_rag_tpu_torch.ops.attention import (
        flash_attention,
        flash_attention_stats,
        flash_attention_stats_reference,
    )

    g = torch.Generator(device="cuda").manual_seed(seed + 4)
    max_err = 0.0
    for t, t_kv, kind, hd, dtype, layout, b, h in STATS_CASES:
        args = stats_inputs(t, t_kv, kind, hd, dtype, g, layout, b, h)
        got = flash_attention_stats(*args)
        torch.cuda.synchronize()
        what = (f"flash_attention_stats [{b}, {h}, {t}, {hd}] T_kv={t_kv} {kind} {layout} "
                f"{str(dtype)[6:]}")
        max_err = max(max_err, compare_stats(got, flash_attention_stats_reference(*args), what))
    # two half-span hops, combined, against the flash kernel on the whole span
    for hd in (64, 128):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, bias = attention_inputs(3, 2, 1024, hd, dtype, g)
            halves = [flash_attention_stats(q, k[:, :, s], v[:, :, s], bias[:, s])
                      for s in (slice(0, 512), slice(512, 1024))]
            got = combine_hops(halves, dtype)
            torch.cuda.synchronize()
            err = compare_attention(got, flash_attention(q, k, v, bias),
                                    f"two hops vs flash_attention hd={hd} {str(dtype)[6:]}")
            max_err = max(max_err, err)
    print(f"ring hop kernel vs plain: {len(STATS_CASES)} cases and 4 two-hop combines ok, "
          f"max_abs_err {max_err}")
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
# 4c. main path, small corpus, IVF
# ---------------------------------------------------------------------------


class Recorder:
    """Stands in for an IVF wrapper in the index module and keeps the
    inputs of each call (the kernel still counts its launches)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kw):
        self.calls.append((args, kw))
        return self.fn(*args, **kw)


def ivf_config(name: str, tier: str):
    from youtu_rag_tpu_torch.core.config import IndexConfig, RAGConfig, VectorStoreConfig

    return RAGConfig(name=name, vector_store=VectorStoreConfig(
        index=IndexConfig(storage_dtype=tier, block_rows=64)))


def top_documents(answers) -> list[str]:
    return [hits[0].chunk.document_id for hits in answers]


def small_corpus_ivf(seed: int) -> tuple[dict[str, int], dict[str, float]]:
    import youtu_rag_tpu_torch.index.device_index as device_index
    from youtu_rag_tpu_torch.retrieval.kb import KnowledgeBase

    launches, errs = {}, dict.fromkeys(TIERS, 0.0)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
        write_corpus(root, seed)
        files = sorted(os.path.join(root, f) for f in os.listdir(root))
        for tier in TIERS:
            kernel, plain, _ = ivf_ops()[tier]
            kb = KnowledgeBase(f"ivf-{tier}", ivf_config("ivf", tier), device="cuda")
            cpu_kb = KnowledgeBase(f"ivf-{tier}-cpu", ivf_config("ivf", tier), device="cpu")
            asyncio.run(kb.build_files(files))
            asyncio.run(cpu_kb.build_files(files))
            for k_b in (kb, cpu_kb):
                k_b.store._index.build_ivf()
            spy = Recorder(getattr(device_index, IVF_NAMES[tier]))
            setattr(device_index, IVF_NAMES[tier], spy)
            try:
                reset_launches()
                got = asyncio.run(_answers(kb))
                torch.cuda.synchronize()
                counts, brute = ivf_counts(), launch_counts()
            finally:
                setattr(device_index, IVF_NAMES[tier], spy.fn)
            ref = asyncio.run(_answers(cpu_kb))
            st = kb.store._index._ivf
            print(f"IVF KB {tier}: {kb.store._index.count()} chunks, {st.n_lists} lists, "
                  f"n_probe {st.n_probe}; IVF launches {counts}, brute {brute}")
            for (query, want), hits in zip(QUERIES + [HYBRID_QUERY], got):
                check(bool(hits) and hits[0].chunk.document_id == want,
                      f"IVF KB {tier}: {query!r} top hit {hits and hits[0].chunk.document_id}")
                check(all(np.isfinite(r.score) for r in hits), f"IVF KB {tier}: non-finite score")
            check(top_documents(got) == top_documents(ref),
                  f"IVF KB {tier}: top documents differ from the CPU twin's")
            check(counts[tier] > 0 and sum(counts.values()) == counts[tier],
                  f"IVF KB {tier}: IVF launches {counts}")
            check(sum(brute.values()) == 0, f"IVF KB {tier}: brute launches {brute} (no tuner)")
            launches[tier] = counts[tier]
            # each IVF call of the path, against the plain version
            for args, kw in spy.calls:
                want = plain(*args, **kw)
                res = kernel(*args, **kw)
                torch.cuda.synchronize()
                # (queries, x, bias, ...) for bf16; compare_exact needs no scores
                full = plain_scores(*args[:3]).cpu() if tier == "bfloat16" else None
                errs[tier] = max(errs[tier], compare_ivf(tier, res, want, full,
                                                         f"IVF KB {tier} call k={args[-1]}"))
            print(f"  {len(spy.calls)} IVF calls of the path match the plain version; "
                  f"top documents {top_documents(got)} as the CPU twin's")
            # through a snapshot into a fresh CUDA KB, which builds IVF again
            snap = os.path.join(root, f"snap-{tier}")
            kb.save(snap)
            fresh = KnowledgeBase(f"ivf-{tier}-loaded", ivf_config("ivf", tier), device="cuda")
            reset_launches()
            fresh.load(snap)
            again = asyncio.run(_answers(fresh))
            torch.cuda.synchronize()
            n = ivf_counts()[tier]
            launches[tier] += n
            check(fresh.store._index._ivf is not None and n > 0,
                  f"IVF KB {tier}: the reloaded KB has no IVF or never launched it ({n})")
            check(top_documents(again) == top_documents(got),
                  f"IVF KB {tier}: the reloaded KB's top documents differ")
            print(f"  saved and loaded into a fresh CUDA KB: IVF rebuilt "
                  f"({fresh.store._index._ivf.n_lists} lists), same top documents, {n} launches")
    return launches, errs


# ---------------------------------------------------------------------------
# 4b. main path, small corpus, encoder
# ---------------------------------------------------------------------------

WEIGHTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "benchmarks", "models", "yrt_tiny_lex")
ENC_TOL = 3e-2  # the JAX package's bf16 encoder tolerance (tests/ops/test_attention.py:41)
IDENTIFIER_DOCS = {  # tests/models/test_weights_dir.py:34-45, in its ranking order
    "kl4407.md": "Maintenance log for unit KL-4407. The inventory tag recorded for "
                 "unit KL-4407 is 88213.",
    "qx9911.md": "Maintenance log for unit QX-9911. The inventory tag recorded for "
                 "unit QX-9911 is 55120.",
    "glacier_survey.md": "An unrelated paragraph about glacier hydrology field surveys.",
}
IDENTIFIER_QUERY = "What is the inventory tag recorded for KL-4407?"


def encoder_config(name: str, weights_dir: str | None = None):
    from youtu_rag_tpu_torch.core.config import EmbeddingConfig, RAGConfig

    cfg = RAGConfig(name=name)
    cfg.knowledge_builder.embedding = EmbeddingConfig(provider="tpu", weights_dir=weights_dir)
    return cfg


def serve_with(kb, embedder) -> None:
    """Put ``embedder`` in every part of ``kb`` that embeds (a CPU twin
    that runs the kernels' plain versions; a re-serve with "pallas")."""
    for part in (kb, kb.retriever, kb.hybrid_retriever, kb.builder):
        part.embedder = embedder


def stored_vectors(kb) -> dict[str, np.ndarray]:
    index = kb.store.index
    return {cid: index._vectors[row].float().cpu().numpy() for cid, row in index._id_to_row.items()}


def identifier_order(kb) -> list[str]:
    """The identifier documents in the order the KB ranks them for the
    identifier query (dense, top 50; a document it does not return is last)."""
    hits = asyncio.run(kb.retriever.retrieve(IDENTIFIER_QUERY, top_k=50, similarity_threshold=0.0))
    ranked = [h.chunk.document_id for h in hits if h.chunk.document_id in IDENTIFIER_DOCS]
    return list(dict.fromkeys(ranked + list(IDENTIFIER_DOCS)))


def check_encoder_answers(got, ref, what: str) -> float:
    """ENC_TOL rule: finite scores; per query the same top chunk, or one the
    reference ranks in its top 5 within ENC_TOL of its top score (a
    near-tie bf16 rounding can swap); the scores of equal ranks within
    ENC_TOL. Returns the max score difference."""
    err = 0.0
    for (query, _), hits, ref_hits in zip(QUERIES + [HYBRID_QUERY], got, ref):
        check(len(hits) > 0 and all(np.isfinite(r.score) for r in hits), f"{what}: {query!r}")
        ref_scores = {r.chunk.id: r.score for r in ref_hits}
        top = hits[0].chunk.id
        check(top == ref_hits[0].chunk.id
              or (top in ref_scores and ref_hits[0].score - ref_scores[top] <= ENC_TOL),
              f"{what}: {query!r} top chunk {top} is not the reference's {ref_hits[0].chunk.id}")
        err = max(err, max(abs(a.score - b.score) for a, b in zip(hits, ref_hits)))
    check(err <= ENC_TOL, f"{what}: scores differ by {err}")
    return err


def encoder_corpus(seed: int) -> tuple[dict, dict[str, float]]:
    """4b: (a) the default full-width encoder, (b) yrt_tiny_lex. Returns
    ((a)'s embedder and main-path launch counts, the max differences)."""
    import dataclasses

    from youtu_rag_tpu_torch.models.embedder import TorchEmbedder
    from youtu_rag_tpu_torch.models.encoder import EncoderConfig
    from youtu_rag_tpu_torch.retrieval.kb import KnowledgeBase

    errs = {}
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
        write_corpus(root, seed)
        for name, text in IDENTIFIER_DOCS.items():
            with open(os.path.join(root, name), "w") as f:
                f.write(text)
        files = sorted(os.path.join(root, f) for f in os.listdir(root))

        # (a) the default encoder through a CUDA KB, against its CPU twin
        t0 = time.perf_counter()
        kb = KnowledgeBase("smoke-enc", encoder_config("smoke-enc"), device="cuda")
        cfg = kb.embedder.cfg
        check(cfg == EncoderConfig(attention_impl="pallas"),
              f"the CUDA KB's default encoder is {cfg}")
        reset_launches()
        status, got = asyncio.run(_drive_kb(kb, files))
        order = identifier_order(kb)
        torch.cuda.synchronize()
        counts = attention_counts()
        t_card = time.perf_counter() - t0
        check(status.status == "completed" and not status.errors, f"build failed: {status.errors}")
        print(f"(a) default encoder {cfg.d_model} x {cfg.n_layers} layers on CUDA: "
              f"{status.total_chunks} chunks, launches {counts}, topk {launch_counts()}, "
              f"{t_card:.1f} s")
        n_bw = counts["blockwise_attention"]
        check(n_bw > 0 and n_bw % cfg.n_layers == 0 and counts["flash_attention"] == 0,
              f"(a) attention launches {counts}: want blockwise a positive multiple of "
              f"{cfg.n_layers}, no flash")
        main_counts = counts
        t0 = time.perf_counter()
        twin = KnowledgeBase("smoke-enc-cpu", encoder_config("smoke-enc-cpu"), device="cpu")
        serve_with(twin, TorchEmbedder(config=cfg, params=kb.embedder.params, device="cpu"))
        _, ref = asyncio.run(_drive_kb(twin, files))
        print(f"  CPU twin (the kernels' plain versions): {time.perf_counter() - t0:.1f} s")
        for (query, _), hits in zip(QUERIES + [HYBRID_QUERY], got):
            print(f"  {query!r} -> {hits[0].chunk.document_id} ({hits[0].score:.4f})")
        vecs, ref_vecs = stored_vectors(kb), stored_vectors(twin)
        check(vecs.keys() == ref_vecs.keys(), "(a) the CUDA and CPU KBs hold different chunks")
        emb_err = max(float(np.abs(v - ref_vecs[c]).max()) for c, v in vecs.items())
        check(emb_err <= ENC_TOL, f"(a) stored embeddings differ by {emb_err} > {ENC_TOL}")
        errs["a"] = max(emb_err, check_encoder_answers(got, ref, "(a) CUDA vs CPU"))
        print(f"  embeddings within {emb_err:.3g} of the CPU twin's, answers within the rule; "
              f"identifier order {order} (CPU {identifier_order(twin)})")

        # (b) yrt_tiny_lex as its config says, then through the kernels
        yrt = KnowledgeBase("smoke-yrt", encoder_config("smoke-yrt", WEIGHTS), device="cuda")
        check(yrt.embedder.cfg.attention_impl == "xla", "yrt_tiny_lex is not served as 'xla'")
        reset_launches()
        status, got = asyncio.run(_drive_kb(yrt, files))
        order = identifier_order(yrt)
        torch.cuda.synchronize()
        counts = attention_counts()
        check(sum(counts.values()) == 0, f"(b) yrt_tiny_lex as 'xla' launched attention: {counts}")
        check(order == list(IDENTIFIER_DOCS), f"(b) identifier ranking {order}")
        twin = KnowledgeBase("smoke-yrt-cpu", encoder_config("smoke-yrt-cpu", WEIGHTS), device="cpu")
        _, ref = asyncio.run(_drive_kb(twin, files))
        errs["b"] = check_encoder_answers(got, ref, "(b) CUDA vs CPU")
        print(f"(b) yrt_tiny_lex ({yrt.embedder.cfg.attention_impl}): {status.total_chunks} chunks, "
              f"identifier order {order}, same answers as the CPU KB")
        pallas = TorchEmbedder(config=dataclasses.replace(yrt.embedder.cfg, attention_impl="pallas"),
                               params=yrt.embedder.params, device="cuda")
        again = KnowledgeBase("smoke-yrt-pallas", encoder_config("smoke-yrt-pallas", WEIGHTS),
                              device="cuda")
        serve_with(again, pallas)
        before = attention_counts()["blockwise_attention"]
        _, got2 = asyncio.run(_drive_kb(again, files))
        order2 = identifier_order(again)
        torch.cuda.synchronize()
        n_bw = attention_counts()["blockwise_attention"] - before
        check(n_bw > 0, "(b) yrt_tiny_lex with 'pallas' never launched blockwise_attention")
        check([h[0].chunk.document_id for h in got2] == [h[0].chunk.document_id for h in got],
              "(b) 'pallas' and 'xla' serving give other top documents")
        check(order2 == list(IDENTIFIER_DOCS), f"(b) 'pallas' identifier ranking {order2}")
        errs["b"] = max(errs["b"], check_encoder_answers(got2, got, "(b) pallas vs xla"))
        print(f"  served again with 'pallas': {n_bw} blockwise launches, same top documents "
              f"and identifier order")
    return {"embedder": kb.embedder, "launches": main_counts}, errs


# ---------------------------------------------------------------------------
# 4d. main path, small corpus, long documents
# ---------------------------------------------------------------------------

LONG_LEAD = 640  # shared filler words before each document's passage: past token 512
LONG_REPEATS = 50  # the passage's sentence, repeated: the document's own content
LONG_DOCS = ("cooking.md", "astronomy.md", "cycling.md", "gardening.md", "chess.md", "coffee.md")
LONG_QUERIES = QUERIES[1:] + [HYBRID_QUERY, ("how does castling move the king", "chess.md"),
                              ("espresso extraction seconds at nine bar", "coffee.md")]
SMALL_ENC = dict(d_model=128, n_layers=2, n_heads=2, d_ff=512, out_dim=128)  # 2 heads of 64


def write_long_corpus(root: str, seed: int) -> None:
    """One file per LONG_DOCS topic, under 10,000 characters (one chunk at
    ``chunk_size`` 10,000): a title, LONG_LEAD filler words that every
    document shares, then the topic's sentence LONG_REPEATS times, so the
    text that tells the documents apart starts past token 512."""
    rng = np.random.default_rng(seed)
    for name in LONG_DOCS:
        title, sentence = TOPICS[name].split("\n", 1)
        lead = " ".join(rng.choice(FILLER, size=LONG_LEAD))
        with open(os.path.join(root, name), "w") as f:
            f.write(f"{title}\n\n{lead}.\n\n" + " ".join([sentence] * LONG_REPEATS))


def long_config(name: str):
    from youtu_rag_tpu_torch.core.config import ChunkingConfig

    cfg = encoder_config(name)
    cfg.knowledge_builder.chunking = ChunkingConfig(chunk_size=10000)
    return cfg


async def _long_answers(kb):
    return [await kb.retriever.retrieve(q, top_k=3, similarity_threshold=0.0)
            for q, _ in LONG_QUERIES]


def long_kb(name: str, embedder, files, device: str):
    """A KB of the long corpus served by ``embedder``: (status, answers)."""
    from youtu_rag_tpu_torch.retrieval.kb import KnowledgeBase

    kb = KnowledgeBase(name, long_config(name), device=device)
    serve_with(kb, embedder)
    status = asyncio.run(kb.build_files(files))
    check(status.status == "completed" and not status.errors, f"{name}: build {status.errors}")
    check(status.total_chunks == len(LONG_DOCS), f"{name}: {status.total_chunks} chunks, "
          f"want one per document")
    return kb, asyncio.run(_long_answers(kb))


def long_corpus(seed: int, embedder) -> dict:
    """4d: the default full-width encoder with sp_mesh=4 answers from the
    right documents; a small encoder's KB on the card gives the top
    documents of its CPU twin. Returns the full-width embedder and its
    main-path launch counts."""
    from youtu_rag_tpu_torch.models.embedder import TorchEmbedder
    from youtu_rag_tpu_torch.models.encoder import EncoderConfig

    out = {}
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
        write_long_corpus(root, seed)
        files = sorted(os.path.join(root, f) for f in os.listdir(root))
        tok = embedder.tokenizer
        for path in files:
            with open(path) as f:
                ids = tok.tokenize(f.read())
            check(len(ids) + 2 > embedder.cfg.max_len, f"{path}: only {len(ids)} tokens")
        lead_tokens = len(tok.tokenize(f"{TOPICS[LONG_DOCS[0]].split(chr(10))[0]} "
                                       + " ".join(["notes"] * LONG_LEAD) + ".")) + 1
        check(lead_tokens > 512, f"the passages start at token {lead_tokens}")

        # the default encoder, sequence-parallel over 4 shards on the card
        t0 = time.perf_counter()
        cfg = embedder.cfg
        long_emb = TorchEmbedder(config=cfg, params=embedder.params, device="cuda", sp_mesh=4)
        reset_launches()
        kb, got = long_kb("smoke-long", long_emb, files, "cuda")
        torch.cuda.synchronize()
        counts = attention_counts()
        n_stats = counts["flash_attention_stats"]
        lens = sorted(len(tok.tokenize(c.content)) + 2 for c in kb.store.index._chunks if c)
        print(f"long corpus: {len(files)} documents of {lens[0]}-{lens[-1]} tokens, one chunk "
              f"each, passages from token {lead_tokens}; default encoder, sp_mesh=4: launches "
              f"{counts}, {time.perf_counter() - t0:.1f} s")
        check(n_stats > 0 and n_stats % (cfg.n_layers * 4) == 0,
              f"flash_attention_stats launches {n_stats}: want a positive multiple of "
              f"{cfg.n_layers} x 4")
        for (query, want), hits in zip(LONG_QUERIES, got):
            check(len(hits) > 0 and all(np.isfinite(h.score) for h in hits), f"{query!r}: hits")
            print(f"  {query!r} -> {hits[0].chunk.document_id} ({hits[0].score:.4f}; next "
                  f"{hits[1].chunk.document_id} {hits[1].score:.4f})")
            check(hits[0].chunk.document_id == want,
                  f"{query!r}: top document {hits[0].chunk.document_id}, expected {want}")
        out["launches"] = n_stats
        # the same KB cut at max_len, for contrast (no check)
        _, cut = long_kb("smoke-long-cut", TorchEmbedder(config=cfg, params=embedder.params,
                                                         device="cuda"), files, "cuda")
        right = sum(h[0].chunk.document_id == w for (_, w), h in zip(LONG_QUERIES, cut))
        print(f"  cut at max_len {cfg.max_len} (no sp_mesh): {right} of {len(LONG_QUERIES)} "
              "queries answered from the right document")

        # a small encoder (Tl >= 256 still takes the hop kernel): card vs CPU twin
        small_cfg = EncoderConfig(**SMALL_ENC, attention_impl="pallas")
        small = TorchEmbedder(config=small_cfg, device="cuda", sp_mesh=4)
        before = attention_counts()["flash_attention_stats"]
        _, got_s = long_kb("smoke-long-small", small, files, "cuda")
        torch.cuda.synchronize()
        n_small = attention_counts()["flash_attention_stats"] - before
        check(n_small > 0 and n_small % (small_cfg.n_layers * 4) == 0,
              f"small encoder: flash_attention_stats launches {n_small}")
        twin = TorchEmbedder(config=small_cfg, params=small.params, device="cpu", sp_mesh=4)
        _, ref_s = long_kb("smoke-long-small-cpu", twin, files, "cpu")
        tops = [h[0].chunk.document_id for h in got_s]
        check(tops == [h[0].chunk.document_id for h in ref_s],
              f"small encoder: card {tops}, CPU twin {[h[0].chunk.document_id for h in ref_s]}")
        err = max(abs(a.score - b.score) for g, r in zip(got_s, ref_s) for a, b in zip(g, r))
        check(err <= ENC_TOL, f"small encoder: scores differ from the CPU twin's by {err}")
        print(f"  small encoder ({small_cfg.d_model} wide, {small_cfg.n_layers} layers, "
              f"{small_cfg.n_heads} heads of {small_cfg.head_dim}), sp_mesh=4: {n_small} hop "
              f"launches, the CPU twin's top documents {tops}, scores within {err:.3g}")
    out["embedder"] = long_emb
    return out


# ---------------------------------------------------------------------------
# 4e. main path, small corpus, a pretrained BERT-family checkpoint
# ---------------------------------------------------------------------------

# BAAI/bge-base-en-v1.5's config.json (BERT-base: CLS pooling, from its
# 1_Pooling/config.json); the cross-encoder has google-bert/bert-base-uncased's
# widths as a BertForSequenceClassification with one label
BERT_BASE = {"model_type": "bert", "vocab_size": 30522, "hidden_size": 768,
             "num_hidden_layers": 12, "num_attention_heads": 12, "intermediate_size": 3072,
             "max_position_embeddings": 512, "type_vocab_size": 2, "layer_norm_eps": 1e-12,
             "hidden_act": "gelu", "hidden_dropout_prob": 0.1,
             "attention_probs_dropout_prob": 0.1, "initializer_range": 0.02, "pad_token_id": 0}
BERT_SPECIAL = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
BERT_PIECES = ("##s", "##es", "##ed", "##ing", "##ly", "##er")
BERT_WORDS = 430  # filler words per document: one chunk of ~450-500 tokens (the T = 512 bucket)


def write_safetensors(path: str, tensors: dict[str, np.ndarray], dtype: str) -> None:
    """The safetensors layout (an 8-byte little-endian header length, a JSON
    header padded to 8 bytes, the tensors' bytes), F32 or BF16 (rounded to
    nearest even by torch)."""
    import struct

    header, offset, names = {}, 0, sorted(tensors)
    for name in names:
        nbytes = tensors[name].size * (4 if dtype == "F32" else 2)
        header[name] = {"dtype": dtype, "shape": list(tensors[name].shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    h = json.dumps(header, separators=(",", ":")).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h)
        for name in names:
            a = np.ascontiguousarray(tensors[name], np.float32)
            if dtype == "BF16":
                a = torch.from_numpy(a).to(torch.bfloat16).view(torch.int16).numpy()
            f.write(a.tobytes())


def write_bert_checkpoint(d: str, vocab: list[str], seed: int, head: bool, dtype: str) -> None:
    """A BERT-base checkpoint directory in the Hugging Face layout: weights
    and biases N(0, 0.02^2) from ``seed``, LayerNorms 1 and 0; BertModel's
    keys with its pooler and CLS pooling (an embedder), or with ``head``
    under ``bert.`` with a one-label ``classifier`` (a cross-encoder)."""
    rng = np.random.default_rng(seed)
    hd, inter, vsz = BERT_BASE["hidden_size"], BERT_BASE["intermediate_size"], len(vocab)

    def w(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    sd = {"embeddings.word_embeddings.weight": w(vsz, hd),
          "embeddings.position_embeddings.weight": w(BERT_BASE["max_position_embeddings"], hd),
          "embeddings.token_type_embeddings.weight": w(BERT_BASE["type_vocab_size"], hd)}
    lns = ["embeddings.LayerNorm"]
    for i in range(BERT_BASE["num_hidden_layers"]):
        p = f"encoder.layer.{i}."
        for name, (o, n) in (("attention.self.query", (hd, hd)), ("attention.self.key", (hd, hd)),
                             ("attention.self.value", (hd, hd)),
                             ("attention.output.dense", (hd, hd)),
                             ("intermediate.dense", (inter, hd)), ("output.dense", (hd, inter))):
            sd[p + name + ".weight"], sd[p + name + ".bias"] = w(o, n), w(o)
        lns += [p + "attention.output.LayerNorm", p + "output.LayerNorm"]
    for ln in lns:
        sd[ln + ".weight"], sd[ln + ".bias"] = np.ones(hd, np.float32), np.zeros(hd, np.float32)
    sd["pooler.dense.weight"], sd["pooler.dense.bias"] = w(hd, hd), w(hd)
    cfg = dict(BERT_BASE, vocab_size=vsz, architectures=["BertModel"])
    if head:
        sd = {"bert." + k: v for k, v in sd.items()}
        sd["classifier.weight"], sd["classifier.bias"] = w(1, hd), w(1)
        cfg.update(architectures=["BertForSequenceClassification"], id2label={"0": "LABEL_0"},
                   label2id={"LABEL_0": 0})
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1)
    write_safetensors(os.path.join(d, "model.safetensors"), sd, dtype)
    with open(os.path.join(d, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    if not head:
        os.makedirs(os.path.join(d, "1_Pooling"), exist_ok=True)
        with open(os.path.join(d, "1_Pooling", "config.json"), "w") as f:
            json.dump({"word_embedding_dimension": hd, "pooling_mode_cls_token": True,
                       "pooling_mode_mean_tokens": False}, f)


def bert_vocab(texts: list[str]) -> list[str]:
    """A 30,522-entry vocab.txt: the special tokens, the texts' words (as
    BERT's basic tokenizer splits them), their characters bare and as
    ``##`` pieces, a few suffixes, then ``[unusedN]`` filler."""
    from youtu_rag_tpu_torch.models.wordpiece import WordPieceTokenizer

    basic = WordPieceTokenizer({"[UNK]": 0, "[CLS]": 1, "[SEP]": 2}, use_fast=False)
    words = sorted({w for t in texts for w in basic.basic_tokenize(t)})
    chars = sorted({c for w in words for c in w})
    vocab = list(dict.fromkeys([*BERT_SPECIAL, *words, *chars, *("##" + c for c in chars),
                                *BERT_PIECES]))
    return vocab + [f"[unused{i}]" for i in range(BERT_BASE["vocab_size"] - len(vocab))]


def write_bert_corpus(root: str, seed: int) -> None:
    """Phase 4's topics, one chunk each: the topic's text, then BERT_WORDS
    filler words."""
    rng = np.random.default_rng(seed + 11)
    for name, text in TOPICS.items():
        with open(os.path.join(root, name), "w") as f:
            f.write(text + "\n\n" + " ".join(rng.choice(FILLER, size=BERT_WORDS)) + ".")


def bert_config(name: str, pretrained_dir: str | None):
    """One chunk per document; the pretrained embedder (a twin without
    ``pretrained_dir`` is served its embedder by ``serve_with``)."""
    from youtu_rag_tpu_torch.core.config import ChunkingConfig, EmbeddingConfig, RAGConfig

    cfg = RAGConfig(name=name)
    if pretrained_dir:
        cfg.knowledge_builder.embedding = EmbeddingConfig(provider="tpu",
                                                          pretrained_dir=pretrained_dir)
    cfg.knowledge_builder.chunking = ChunkingConfig(chunk_size=10000)
    return cfg


class ForwardSpy:
    """Stands in for ``encode_tokens`` / ``rerank_scores`` in a module and
    records the T of every call."""

    def __init__(self, module, name: str):
        self.module, self.name, self.fn, self.ts = module, name, getattr(module, name), []

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)

    def __call__(self, params, token_ids, *args, **kw):
        self.ts.append(int(token_ids.shape[1]))
        return self.fn(params, token_ids, *args, **kw)


def forward_split(fn) -> dict[str, float]:
    """One call's device time by kernel kind (torch.profiler): the blockwise
    attention kernel, the GEMMs (cuBLAS) and the rest (elementwise, norms,
    copies); ms each."""
    split = {"attention kernel": 0.0, "GEMMs": 0.0, "elementwise and the rest": 0.0}
    for name, (_, us) in device_kernels(fn, 1).items():
        low = name.lower()
        kind = ("attention kernel" if "attention_kernel" in low else
                "GEMMs" if any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass")) else
                "elementwise and the rest")
        split[kind] += us / 1e3
    return split


def check_ranking(got: list[tuple[str, float]], ref: list[tuple[str, float]], tol: float,
                  what: str) -> float:
    """The same items in the same order, but for a swap of two whose
    reference scores lie within ``tol``; scores within ``tol``. Returns the
    max score difference."""
    scores = dict(ref)
    err = 0.0
    for (item, s), (want, ws) in zip(got, ref):
        check(item in scores and np.isfinite(s), f"{what}: {item} is not among {list(scores)}")
        err = max(err, abs(s - scores[item]))
        check(item == want or abs(scores[item] - ws) <= tol,
              f"{what}: {item} ranks where the reference has {want} ({scores[item]} vs {ws})")
    check(err <= tol, f"{what}: scores differ by {err} > {tol}")
    return err


def bert_corpus(seed: int, smi: str) -> dict:
    """4e: a BERT-base embedder and cross-encoder written from a seed,
    served through ``EmbeddingConfig(provider="tpu", pretrained_dir=...)``
    and ``TorchReranker.from_pretrained`` on the card, held against CPU f32
    twins of the same checkpoints; then BERT-base throughput. Returns the
    main path's blockwise launches and the max differences."""
    import dataclasses

    import youtu_rag_tpu_torch.models.embedder as embedder_mod
    import youtu_rag_tpu_torch.models.encoder as encoder_mod
    import youtu_rag_tpu_torch.models.reranker as reranker_mod
    from youtu_rag_tpu_torch.models.embedder import TorchEmbedder
    from youtu_rag_tpu_torch.models.encoder import encode_tokens, rerank_scores
    from youtu_rag_tpu_torch.models.reranker import TorchReranker
    from youtu_rag_tpu_torch.retrieval.kb import KnowledgeBase

    out, errs = {}, {}
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=repo) as root:
        docs = os.path.join(root, "docs")
        os.makedirs(docs)
        write_bert_corpus(docs, seed)
        files = sorted(os.path.join(docs, f) for f in os.listdir(docs))
        texts = [open(p).read() for p in files] + [q for q, _ in QUERIES]
        t0 = time.perf_counter()
        vocab = bert_vocab(texts)
        emb_dir, rr_dir = os.path.join(root, "bge-base"), os.path.join(root, "reranker-base")
        write_bert_checkpoint(emb_dir, vocab, seed + 1, head=False, dtype="F32")
        write_bert_checkpoint(rr_dir, vocab, seed + 2, head=True, dtype="BF16")
        print(f"BERT-base checkpoints written (embedder F32, cross-encoder BF16; vocab.txt "
              f"{len(vocab)} entries): {time.perf_counter() - t0:.1f} s")

        # the CUDA KB through the user's entry points, the cross-encoder in its retriever
        t0 = time.perf_counter()
        kb = KnowledgeBase("smoke-bert", bert_config("smoke-bert", emb_dir), device="cuda")
        rr = TorchReranker.from_pretrained(rr_dir, device="cuda")
        for part in (kb, kb.retriever, kb.hybrid_retriever):
            part.reranker = rr
        cfg = kb.embedder.cfg
        check(isinstance(kb.embedder, TorchEmbedder) and cfg.arch == "bert"
              and cfg.attention_impl == "pallas" and cfg.pooling == "cls"
              and cfg.dtype == torch.bfloat16 and cfg.gelu_approximate is False
              and cfg.ln_eps == 1e-12 and (cfg.d_model, cfg.n_layers, cfg.n_heads) == (768, 12, 12),
              f"the pretrained embedder's config: {cfg}")
        check(rr.cfg.attention_impl == "pallas" and "score_head" in rr.params
              and "pooler_w" in rr.params, "the cross-encoder's config or head")
        reset_launches()
        with ForwardSpy(embedder_mod, "encode_tokens") as fe, \
                ForwardSpy(reranker_mod, "rerank_scores") as fr, \
                LastCallOn(encoder_mod, "blockwise_attention") as attn:
            status = asyncio.run(kb.build_files(files))
            dense = [asyncio.run(kb.retriever.retrieve(q, top_k=len(files),
                                                       similarity_threshold=0.0))
                     for q, _ in QUERIES]
            reranked = [asyncio.run(kb.retriever.retrieve(q, top_k=3, similarity_threshold=0.0,
                                                          enable_reranking=True))
                        for q, _ in QUERIES]
            torch.cuda.synchronize()
        counts = attention_counts()
        t_card = time.perf_counter() - t0
        check(status.status == "completed" and status.total_chunks == len(files),
              f"bert KB build: {status.total_chunks} chunks, errors {status.errors}")
        long_calls = sum(t >= 256 for t in fe.ts + fr.ts)
        check(512 in fe.ts and 512 in fr.ts and min(fe.ts) < 256,
              f"forward T buckets: embedder {fe.ts}, reranker {fr.ts}")
        check(counts["blockwise_attention"] == cfg.n_layers * long_calls
              and counts["flash_attention"] == 0,
              f"attention launches {counts}: want {cfg.n_layers} x {long_calls} forwards at "
              f"T >= 256 (embedder T {fe.ts}, reranker T {fr.ts})")
        out["launches"] = counts["blockwise_attention"]
        print(f"CUDA KB: {status.total_chunks} chunks; forwards: embedder T {fe.ts}, reranker "
              f"T {fr.ts}; blockwise launches {counts['blockwise_attention']} = "
              f"{cfg.n_layers} x {long_calls}; {t_card:.1f} s")

        # G1: the stored embeddings (T = 512) against a CPU f32 twin
        t0 = time.perf_counter()
        twin = KnowledgeBase("smoke-bert-cpu", bert_config("smoke-bert-cpu", None), device="cpu")
        cpu_emb = TorchEmbedder.from_pretrained(emb_dir, dtype=torch.float32, device="cpu")
        serve_with(twin, cpu_emb)
        asyncio.run(twin.build_files(files))
        ref_dense = [asyncio.run(twin.retriever.retrieve(q, top_k=len(files),
                                                         similarity_threshold=0.0))
                     for q, _ in QUERIES]
        vecs, ref_vecs = stored_vectors(kb), stored_vectors(twin)
        check(vecs.keys() == ref_vecs.keys() and len(vecs) >= 16, "the bert KBs' chunks")
        check(all(np.isfinite(v).all() for v in vecs.values()), "non-finite embeddings")
        errs["embeddings"] = max(float(np.abs(v - ref_vecs[c]).max()) for c, v in vecs.items())
        check(errs["embeddings"] <= ENC_TOL,
              f"{len(vecs)} embeddings at T = 512 differ from the CPU f32 forward's by "
              f"{errs['embeddings']} > {ENC_TOL}")
        # G4: the dense ranking of every document, near-ties aside
        for (query, _), got, ref in zip(QUERIES, dense, ref_dense):
            errs["dense"] = max(errs.get("dense", 0.0), check_ranking(
                [(h.chunk.document_id, h.score) for h in got],
                [(h.chunk.document_id, h.score) for h in ref], ENC_TOL, f"dense {query!r}"))
        print(f"  CPU f32 twin: {len(vecs)} stored embeddings within {errs['embeddings']:.3g} "
              f"(ENC_TOL {ENC_TOL}); dense rankings within {errs['dense']:.3g}; "
              f"{time.perf_counter() - t0:.1f} s")

        # G2: the same CUDA forward with plain attention ("xla")
        xla = TorchEmbedder(config=dataclasses.replace(cfg, attention_impl="xla"),
                            params=kb.embedder.params, tokenizer=kb.embedder.tokenizer,
                            device="cuda")
        chunks = {c.id: c.content for c in kb.store.index._chunks if c}
        ids = sorted(chunks)
        plain_vecs = xla.embed_batch([chunks[c] for c in ids])
        errs["xla"] = float(max(np.abs(plain_vecs[i] - vecs[c]).max() for i, c in enumerate(ids)))
        check(np.isfinite(plain_vecs).all() and errs["xla"] <= ENC_TOL,
              f"the forward with plain attention differs by {errs['xla']}")
        q, k, v, bias = attn.args  # the last blockwise call of the path: the last reranker layer
        mask = (bias == 0).float()
        errs["attention"] = compare_attention(
            encoder_mod._attention_core(q, k, v, mask, dataclasses.replace(rr.cfg,
                                                                           attention_impl="pallas")),
            encoder_mod._attention_core(q, k, v, mask, dataclasses.replace(rr.cfg,
                                                                           attention_impl="xla")),
            f"blockwise against plain attention on the path's [{', '.join(map(str, q.shape))}]")
        print(f"  plain-attention ('xla') CUDA forward: embeddings within {errs['xla']:.3g}; the "
              f"kernel's attention output within one bf16 ulp of plain attention "
              f"({errs['attention']:.3g}) on the last layer's strided q, k, v")

        # G3: the cross-encoder's scores on the path's candidates, against a CPU f32 twin
        t0 = time.perf_counter()
        rr_cpu = TorchReranker.from_pretrained(rr_dir, dtype=torch.float32, device="cpu")
        for (query, _), ranked, final in zip(QUERIES, dense, reranked):
            cands = ranked[: 2 * len(final)]  # the retriever's recall before the rerank
            cand = [h.chunk.content for h in cands]
            got, ref = rr.score(query, cand), rr_cpu.score(query, cand)
            order = sorted(range(len(cand)), key=lambda i: -ref[i])
            errs["rerank"] = max(errs.get("rerank", 0.0), check_ranking(
                sorted([(i, got[i]) for i in range(len(cand))], key=lambda t: -t[1]),
                [(i, ref[i]) for i in order], ENC_TOL, f"rerank {query!r}"))
            by_content = {h.chunk.content: i for i, h in enumerate(cands)}
            top = [by_content[h.chunk.content] for h in final]
            check(top == sorted(range(len(cand)), key=lambda i: -got[i])[: len(top)],
                  f"rerank {query!r}: the retriever's order is not its scores'")
            print(f"  {query!r}: dense top {cands[0].chunk.document_id} ({cands[0].score:.5f}), "
                  f"reranked top {final[0].chunk.document_id} ({final[0].score:.4f}; CPU "
                  f"{ref[top[0]]:.4f})")
        print(f"  cross-encoder scores within {errs['rerank']:.3g} of the CPU f32 twin's "
              f"(ENC_TOL), the same order where they are further apart; "
              f"{time.perf_counter() - t0:.1f} s")

        # throughput: B = 128, T = 512 embeddings; B = 64, T = 512 pairs
        rng = np.random.default_rng(seed + 12)
        words = np.array([w for w in vocab[len(BERT_SPECIAL):] if w.isalpha() and len(w) > 1])
        big = [" ".join(rng.choice(words, size=600)) for _ in range(128)]
        emb = kb.embedder
        emb.embed_batch(big[:8])  # warm-up
        t0 = time.perf_counter()
        tok_ids, tok_mask = emb.tokenizer.batch(big)
        t_tok = time.perf_counter() - t0
        reset_launches()
        t0 = time.perf_counter()
        vec = emb.embed_batch(big)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_bw = attention_counts()["blockwise_attention"]
        check(vec.shape == (128, 768) and np.isfinite(vec).all() and n_bw == cfg.n_layers,
              f"B = 128 embed: {vec.shape}, {n_bw} blockwise launches")
        check(tok_ids.shape == (128, 512), f"B = 128 batch: {tok_ids.shape}")
        ids_d, mask_d = torch.from_numpy(tok_ids).cuda(), torch.from_numpy(tok_mask).cuda()
        fwd = lambda: encode_tokens(emb.params, ids_d, mask_d, cfg)  # noqa: E731
        fwd_ms = time_ms(fwd, bursts=3, burst=3, warmup=1)
        split = forward_split(fwd)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        real = encoder_mod.blockwise_attention
        encoder_mod.blockwise_attention = lambda q, k, v, b: sdpa(  # noqa: E731
            q, k, v, attn_mask=torch.clamp_min(b, -1e30).to(q.dtype)[:, None, None, :])
        try:
            sdpa_ms = time_ms(fwd, bursts=3, burst=3, warmup=1)
        finally:
            encoder_mod.blockwise_attention = real
        out["embed"] = {"fwd_ms": fwd_ms, "wall_ms": wall * 1e3, "tok_ms": t_tok * 1e3,
                        "sdpa_ms": sdpa_ms, "split": split}
        path = "pure-Python" if emb.tokenizer._fast is None else "tokenizers"
        print(f"BERT-base embeddings, B = 128, T = 512 [{smi}]: forward {fwd_ms:.4f} ms device "
              f"({128 / fwd_ms * 1e3:.1f} embeddings/s); embed_batch {wall * 1e3:.1f} ms wall "
              f"({128 / wall:.1f} embeddings/s; WordPiece alone, {path} path, "
              f"{t_tok * 1e3:.1f} ms); the forward with SDPA in the kernel's place "
              f"{sdpa_ms:.4f} ms")
        total = sum(split.values())
        print("  forward split (torch.profiler, one call): " + ("; ".join(
            f"{kind} {ms:.4f} ms ({ms / total:.0%})" for kind, ms in split.items())
            + f"; {total:.4f} ms of kernels" if total else "no device events recorded"))
        pairs = [" ".join(rng.choice(words, size=600)) for _ in range(64)]
        rr.score(QUERIES[0][0], pairs[:8])  # warm-up
        reset_launches()
        t0 = time.perf_counter()
        scores = rr.score(QUERIES[0][0], pairs)
        torch.cuda.synchronize()
        r_wall = time.perf_counter() - t0
        n_bw = attention_counts()["blockwise_attention"]
        check(len(scores) == 64 and np.isfinite(scores).all() and n_bw == rr.cfg.n_layers,
              f"B = 64 rerank: {n_bw} blockwise launches")
        p_ids, p_mask, p_types = (torch.from_numpy(a).cuda()
                                  for a in rr._bucket(pairs, QUERIES[0][0]))
        check(tuple(p_ids.shape) == (64, 512), f"B = 64 pairs: {tuple(p_ids.shape)}")
        r_ms = time_ms(lambda: rerank_scores(rr.params, p_ids, p_mask, rr.cfg, type_ids=p_types),
                       bursts=3, burst=3, warmup=1)
        out["rerank"] = {"fwd_ms": r_ms, "wall_ms": r_wall * 1e3}
        print(f"BERT-base cross-encoder, B = 64 pairs, T = 512 [{smi}]: {r_ms:.4f} ms device "
              f"({64 / r_ms * 1e3:.1f} pairs/s); score() {r_wall * 1e3:.1f} ms wall "
              f"({64 / r_wall:.1f} pairs/s, WordPiece included)")
    out["errs"] = errs
    return out


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


def profile_split(fn, calls: int = 10, top: int = 4) -> None:
    """Device time per call of the ``top`` kernels ``fn`` launches, and of
    all of them (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # an operator's row repeats its kernels' time
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and e.count >= calls:
            rows.append((us / calls, e.key))
    print(f"  device time per call: {sum(us for us, _ in rows) / 1e3:.4f} ms in all; " + "; ".join(
        f"{name.replace('(anonymous namespace)::', '').split('(')[0].split('<')[0][:48]} {us / 1e3:.4f} ms"
        for us, name in sorted(rows, reverse=True)[:top]))


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


def full_size(seed: int, part: str) -> tuple[dict[str, dict], dict[str, dict]]:
    """Returns (each tier's results, the bf16 and int8 indexes' device
    tensors and queries, which phase 5d reuses)."""
    from youtu_rag_tpu_torch.core.config import IndexConfig
    from youtu_rag_tpu_torch.core.types import Chunk
    from youtu_rag_tpu_torch.index.device_index import DeviceVectorIndex

    kernels = ops()
    rows, d, qn, top_k, batch = ROWS, 768, 8, 10, 65536
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    # one set of unit vectors for the three tiers, drawn on the card (a
    # host draw took ~19 s) and handed to ``add`` as numpy
    v = torch.randn(rows, d, generator=torch.Generator(device="cuda").manual_seed(seed),
                    device="cuda")
    vecs = (v / v.norm(dim=1, keepdim=True)).cpu().numpy()
    del v
    chunks = [Chunk(f"c{i}", f"doc{i // 64}", "", i % 64) for i in range(rows)]
    queries = rng.standard_normal((qn, d), dtype=np.float32)
    queries[0] = vecs[rows // 2]  # a stored row: top-1 known
    qpad = queries / np.linalg.norm(queries, axis=1, keepdims=True)  # as search() prepares it
    qdev = torch.from_numpy(qpad.astype(np.float32)).cuda()
    print(f"full size: {rows} x {d} unit vectors made in {time.perf_counter() - t0:.1f} s")

    out, keep = {}, {}
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
        earlier = EARLIER_MS.get(KERNEL_NAMES[tier])
        print(f"  plain {res['plain_ms']:.4f} ms; library "
              f"{'null' if call is None else format(res['library_ms'], '.4f') + ' ms'} [{desc}]"
              + ("" if earlier is None else f"; the __dp4a scorer's recorded time {earlier} ms, "
                 f"now {res['ms']:.4f} ms against a bound of {res['bound_ms']:.4f} ms"))
        profile_split(lambda: kernel(qdev, x, *extra, b, k_kernel))
        out[tier] = res
        if tier != "int4":
            keep[tier] = {"q": qdev, "x": x, "extra": extra, "bias": b}
        del index, x, b, extra, hits
        torch.cuda.empty_cache()
    return out, keep


# ---------------------------------------------------------------------------
# 5c. main path at full size, IVF
# ---------------------------------------------------------------------------

IVF_SETTINGS = dict(block_rows=1024, n_lists=1024, n_probe=64, ivf_adaptive_margin=0.15,
                    ivf_recall_target=0.95)  # configs/rag/ivf_int8.yaml's index


def clustered_rows(seed: int, rows: int, d: int, qn: int):
    """scripts/bench_scale.py:83-100's generator on the card: unit rows
    around 1024 unit centers (noise 0.7 / sqrt(d)), queries at half the
    noise around centers 0..qn-1. Returns host arrays (rows, queries)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    centers = torch.randn(1024, d, generator=g, device="cuda")
    centers /= centers.norm(dim=1, keepdim=True)
    noise = 0.7 / np.sqrt(d)
    out = np.empty((rows, d), np.float32)
    for i in range(0, rows, 1 << 18):
        m = min(1 << 18, rows - i)
        cid = torch.randint(0, 1024, (m,), generator=g, device="cuda")
        v = centers[cid] + noise * torch.randn(m, d, generator=g, device="cuda")
        out[i : i + m] = (v / v.norm(dim=1, keepdim=True)).cpu().numpy()
    q = centers[:qn] + 0.5 * noise * torch.randn(qn, d, generator=g, device="cuda")
    return out, (q / q.norm(dim=1, keepdim=True)).cpu().numpy()


HOLD_CYCLES = 4_000_000  # a ~2 ms spin of the card: more than the host takes to enqueue a call


def time_held_ms(fn, calls: int = 20, warmup: int = 3, cold: bool = False) -> float:
    """Device time of one call, the median over ``calls``. Before each call
    a spin kernel (``torch.cuda._sleep``) holds the card while the host
    enqueues the call, so the CUDA events around it see the call's device
    time, not the host's enqueue gaps (which exceed the device time of a
    call this short, and vary with the host). With ``cold`` a 1 GiB write
    first evicts the 50 MB L2 (a probed plan reads tens of MB, which
    back-to-back calls would find cached)."""
    flush = torch.empty(256 << 20, dtype=torch.float32, device="cuda") if cold else None
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(calls):
        if cold:
            flush.zero_()
        torch.cuda._sleep(HOLD_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def device_kernels(fn, calls: int) -> dict[str, tuple[int, float]]:
    """Every device activity of ``calls`` calls of ``fn`` (torch.profiler):
    name → (count, device us in all). The profiler may drop a short
    window's device events, some or all: a window that records none is
    profiled again, every other attempt after a warm-up step of the same
    calls (a schedule whose first step records nothing); {} if none
    records any."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(6):
        warm = attempt % 2 == 1
        ready = []  # the recorded step's events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1) if warm else None,
                     on_trace_ready=(lambda p: ready.append(p.key_averages())) if warm else None
                     ) as prof:
            for _step in range(2 if warm else 1):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                if warm:
                    prof.step()
        out = {}
        for e in (ready[0] if warm and ready else [] if warm else prof.key_averages()):
            # (the schedule's step annotation also shows on the device)
            if e.device_type != torch.autograd.DeviceType.CUDA or e.key.startswith("ProfilerStep"):
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            out[e.key] = (e.count, us)
        if out:
            return out
    return {}


SCAN_KERNELS = ("topk_scan_kernel", "ivf_tma_kernel")


def search_split(fn, calls: int = 5) -> dict[str, float]:
    """Device time per call of ``fn`` (one whole index.search) by part
    (torch.profiler): the scan and merge kernels, the copies, and the rest
    (probe planning: the centroid product, sort, union and argsort), whose
    largest kernels are named. Returns the parts (ms)."""
    parts = dict.fromkeys(("planning and the rest", "scan", "merge", "copies"), 0.0)
    rest = []
    for name, (count, us) in device_kernels(fn, calls).items():
        part = ("scan" if any(k in name for k in SCAN_KERNELS)
                else "merge" if "topk_merge_kernel" in name
                else "copies" if "memcpy" in name.lower() or "memset" in name.lower()
                else "planning and the rest")
        parts[part] += us / calls / 1e3
        if part == "planning and the rest":
            rest.append((us / calls / 1e3, count // calls, name))
    print("  search device time per call: " + "; ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
          + f"; total {sum(parts.values()):.4f} ms")
    print(f"  planning and the rest: {sum(c for _, c, _ in rest)} kernels per call; largest: "
          + "; ".join(f"{n.replace('(anonymous namespace)::', '').split('(')[0][:60]} x{c} "
                      f"{ms:.4f} ms" for ms, c, n in sorted(rest, reverse=True)[:5]))
    return parts


def ivf_bound(tier: str, part: str, n_valid: int, br: int, d: int, qn: int, k: int):
    """The probed rows' bytes (vectors, bias, scales) and the queries and
    results, at the HBM rate; their 2·q·rows·d operations at the peak of
    their type. Returns (ms, "bytes" or "operations")."""
    rows = n_valid * br
    row_bytes = {"bfloat16": 2 * d + 4, "int8": d + 8, "int4": d // 2 + 8}[tier]
    bytes_ms = (rows * row_bytes + qn * d * 4 + qn * k * 8) / HBM_PEAK[part] * 1e3
    peak = BF16_PEAK[part] if tier == "bfloat16" else INT8_PEAK[part]
    ops_ms = 2 * qn * rows * d / peak * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def full_size_ivf(seed: int, part: str) -> tuple[dict[str, dict], dict[str, dict]]:
    """Returns (each tier's results, the bf16 and int8 indexes' device
    tensors, queries and adaptive plans, which phase 5d reuses)."""
    from youtu_rag_tpu_torch.core.config import IndexConfig
    from youtu_rag_tpu_torch.core.types import Chunk
    from youtu_rag_tpu_torch.index.device_index import DeviceVectorIndex
    from youtu_rag_tpu_torch.index.ivf import plan_max_blocks, probe_blocks

    rows, d, qn, top_k, batch = ROWS, 768, 8, 10, 65536
    t0 = time.perf_counter()
    vecs, queries = clustered_rows(seed, rows, d, qn)
    queries[0] = vecs[rows // 3]  # a stored row: top-1 known
    qpad = queries / np.maximum(np.linalg.norm(queries, axis=1, keepdims=True), 1e-12)
    qdev = torch.from_numpy(qpad).cuda()  # as search() prepares them
    chunks = [Chunk(f"c{i}", f"doc{i // 64}", "", i % 64) for i in range(rows)]
    print(f"IVF full size: {rows} x {d} clustered unit vectors made in "
          f"{time.perf_counter() - t0:.1f} s")
    out, keep = {}, {}
    for tier in TIERS:
        kernel, plain, _ = ivf_ops()[tier]
        brute = ops()[tier][0]
        index = DeviceVectorIndex(d, IndexConfig(kind="ivf", storage_dtype=tier, **IVF_SETTINGS),
                                  device="cuda")
        index.reserve(rows)
        for start in range(0, rows, batch):
            index.add(chunks[start : start + batch], vecs[start : start + batch])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index.build_ivf()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        st = index._ivf
        print(f"{tier}: build_ivf {build_s:.2f} s ({rows / build_s:.0f} rows/s), {st.n_lists} lists, "
              f"n_probe {st.n_probe}, at most {st.max_cluster_blocks} blocks per cluster")

        reset_launches()
        hits = index.search(queries, top_k=top_k)
        torch.cuda.synchronize()
        counts, brute_counts = ivf_counts(), launch_counts()
        check(counts[tier] > 0 and sum(counts.values()) == counts[tier],
              f"{tier}: index.search launched IVF kernels {counts}")
        check(sum(brute_counts.values()) == 0, f"{tier}: a brute launch {brute_counts} (no shadow)")
        check(len(hits) == qn and all(len(h) == top_k for h in hits), f"{tier}: wrong shape")
        check(all(np.isfinite(s) for h in hits for _, s in h), f"{tier}: non-finite scores")
        check(hits[0][0][0].id == f"c{rows // 3}", f"{tier}: query 0 top hit {hits[0][0][0].id}")

        # the search's own plan, the same device tensors, through the plain version
        x, b = index._vectors, index._bias
        extra = () if tier == "bfloat16" else (index._scales,)
        total = index.capacity // IVF_SETTINGS["block_rows"]

        def plan(margin):
            kw = {"adaptive_margin": margin, "min_probe": min(index.config.ivf_min_probe,
                                                              st.n_probe)} if margin else {}
            return probe_blocks(qdev, st.centroids, st.cluster_block_start, st.cluster_block_count,
                                n_probe=st.n_probe, max_cluster_blocks=st.max_cluster_blocks,
                                total_blocks=total, frozen_blocks=st.frozen_blocks,
                                max_blocks=plan_max_blocks(st, qn, total), **kw)

        ids, nv = plan(IVF_SETTINGS["ivf_adaptive_margin"])
        if tier != "int4":
            keep[tier] = {"q": qdev, "x": x, "extra": extra, "bias": b, "ids": ids, "nv": nv}
        k_kernel = top_k if tier != "int4" else 64  # int4: 4 x 10 candidates, pow2, re-ranked on the host
        call = lambda: kernel(qdev, x, *extra, b, ids, nv, k_kernel,  # noqa: E731
                              block_rows=IVF_SETTINGS["block_rows"])
        got = call()
        torch.cuda.synchronize()
        want = plain(qdev, x, *extra, b, ids, nv, k_kernel, block_rows=IVF_SETTINGS["block_rows"])
        full = plain_scores(qdev, x, b).cpu() if tier == "bfloat16" else None
        err = compare_ivf(tier, got, want, full, f"IVF {tier} full size")
        # the search's rows are this kernel call's (the kernel is deterministic)
        got_rows = np.asarray([[index._id_to_row[c.id] for c, _ in h] for h in hits])
        if tier == "int4":
            _, rr = index._host_rerank_candidates(qpad, got[0].cpu().numpy(), got[1].cpu().numpy(),
                                                  index._host_q8, index._host_s8, top_k)
            check(np.array_equal(got_rows, rr), "int4 IVF: the search's re-ranked rows differ")
        else:
            check(np.array_equal(got_rows, got[1][:, :top_k].cpu().numpy()),
                  f"{tier} IVF: the search's rows differ from its kernel's")
        brute_rows = brute(qdev, x, *extra, b, top_k)[1].cpu().numpy()
        ivf_rows = got[1][:, :top_k].cpu().numpy()
        recall = float(np.mean([len(set(a) & set(r)) / top_k for a, r in zip(ivf_rows, brute_rows)]))
        n_valid = int(nv)
        res = {"launches": counts[tier], "err": err}
        print(f"  search matches the plain version on its plan; n_valid {n_valid} of {total} "
              f"blocks; recall@10 against {KERNEL_NAMES[tier]} {recall:.3f}")
        # what one call runs on the card: one kernel (the queries' prep and
        # the merge inside it) after a memset
        before = kernel.launches
        call()
        per_call = kernel.launches - before
        check(per_call == 1, f"{tier}: {per_call} launches per call")
        # (the profiler may drop events of so short a window: kinds, not counts)
        ran = device_kernels(call, 5)
        names = [n for n in ran if "memset" not in n.lower()]
        check(len(names) == 1 and "ivf_tma_kernel" in names[0],
              f"{tier}: five calls ran {sorted(ran)}")
        print(f"  one call: {per_call} launch; five calls on the card: " + "; ".join(
            f"{n.split('(')[0][:60]} x{c}" for n, (c, _) in ran.items()))

        for label, margin in (("adaptive", IVF_SETTINGS["ivf_adaptive_margin"]), ("fixed", 0.0)):
            if margin == 0.0:
                ids, nv = plan(0.0)
                n_valid = int(nv)
            ms = time_held_ms(call, cold=True)
            warm = time_ms(call)
            bms, by = ivf_bound(tier, part, n_valid, IVF_SETTINGS["block_rows"], d, qn, k_kernel)
            mb = n_valid * IVF_SETTINGS["block_rows"] * {"bfloat16": 2 * d + 4, "int8": d + 8,
                                                         "int4": d // 2 + 8}[tier] / 1e6
            earlier = (EARLIER_MS if label == "adaptive" else EARLIER_FIXED_MS).get(IVF_NAMES[tier])
            print(f"  {IVF_NAMES[tier]} {label} plan, n_valid {n_valid} ({mb:.1f} MB probed), "
                  f"k = {k_kernel}: {ms:.4f} ms device, L2 cold ({mb / ms:.1f} GB/s), 1 launch "
                  f"per call; {warm:.4f} ms per call back to back; bound {bms:.4f} ms ({by}); "
                  f"earlier design's recorded time {earlier} ms")
            if label == "adaptive":
                res.update(ms=ms, bound_ms=bms, bound_by=by)
                res["plain_ms"] = time_ms(lambda: plain(qdev, x, *extra, b, ids, nv, k_kernel,
                                                        block_rows=IVF_SETTINGS["block_rows"]),
                                          bursts=3, burst=5)
                brute_ms = time_ms(lambda: brute(qdev, x, *extra, b, k_kernel))
                print(f"  plain {res['plain_ms']:.4f} ms; brute {KERNEL_NAMES[tier]} on the same "
                      f"index {brute_ms:.4f} ms; library: none (no one PyTorch call computes a "
                      f"top-k over gathered blocks)")
            else:
                index.config.ivf_adaptive_margin = 0.0
            parts = search_split(lambda: index.search(queries, top_k=top_k))
            check(parts["merge"] == 0.0, f"{tier}: the search launched a merge kernel")
        out[tier] = res
        del index, x, b, extra, hits
        torch.cuda.empty_cache()
    return out, keep


# ---------------------------------------------------------------------------
# 5d. the ops path at full size, per-block
# ---------------------------------------------------------------------------


def blocks_bound(tier: str, part: str, rows: int, d: int, qn: int, n_blocks: int, k: int):
    """The brute per-block kernels' bound: the rows read (vectors, bias
    and, for int8, scales) and the queries, plus the candidates written
    (n_blocks × q × k_pad × 8 bytes), at the HBM rate; their 2·q·rows·d
    operations at the peak of their type (the merged IVF calls take
    ivf_bound: no candidates). Returns (ms, "bytes" or "operations")."""
    k_pad = -(-k // 128) * 128
    row_bytes = {"bfloat16": 2 * d + 4, "int8": d + 8}[tier]
    nbytes = rows * row_bytes + qn * d * 4 + n_blocks * qn * k_pad * 8
    bytes_ms = nbytes / HBM_PEAK[part] * 1e3
    peak = BF16_PEAK[part] if tier == "bfloat16" else INT8_PEAK[part]
    ops_ms = 2 * qn * rows * d / peak * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def ops_full_size(part: str, brute: dict, ivf: dict) -> dict[str, dict]:
    """5d: the per-block kernels through the ops API on phase 5's and 5c's
    device tensors (q = 8, k = 10)."""
    from youtu_rag_tpu_torch.ops.topk import NEG_INF, fused_topk, merge_blocks

    k, d = 10, 768
    kernels = blocks_ops()
    pruned = {tier: ops()[tier][0] for tier in ("bfloat16", "int8")}
    dma = {tier: ivf_ops()[tier][0] for tier in ("bfloat16", "int8")}
    # name → (tensors, block_rows)
    setup = {
        "topk": (brute["bfloat16"], 1024),
        "topk_int8": (brute["int8"], 2048),
        "ivf_topk": (ivf["bfloat16"], IVF_SETTINGS["block_rows"]),
        "ivf_topk_int8": (ivf["int8"], IVF_SETTINGS["block_rows"]),
    }

    def args(name):
        t, _ = setup[name]
        plan = (t["ids"], t["nv"]) if "ids" in t else ()
        return (t["q"], t["x"], *t["extra"], t["bias"], *plan, k)

    reset_launches()
    results = {"topk": fused_topk(*args("topk")[:3], k)}  # backend "auto"
    for name in BLOCKS_NAMES[1:]:
        results[name] = kernels[name][0](*args(name), block_rows=setup[name][1])
    torch.cuda.synchronize()
    counts = blocks_counts()
    print(f"ops path: fused_topk (auto), topk_int8, ivf_topk, ivf_topk_int8 at q = 8, k = {k}; "
          f"launches {counts}")
    check(all(counts[name] == 1 for name in BLOCKS_NAMES), f"ops path launches {counts}")

    out = {}
    for name, (kernel, plain, tier, takes_plan) in kernels.items():
        t, br = setup[name]
        a = args(name)
        x, b, q = t["x"], t["bias"], t["q"]
        rows = x.shape[0]
        full = plain_scores(q, x, b).cpu() if tier == "bfloat16" else None
        cand = kernel(*a, block_rows=br, candidates=True)
        torch.cuda.synchronize()
        err = compare_blocks(tier, cand, plain(*a, block_rows=br, candidates=True), full,
                             f"{name} full size candidates")
        got = results[name]
        err = max(err, compare_blocks(tier, got, plain(*a, block_rows=br), full,
                                      f"{name} full size"))
        # the pruned (brute) or DMA (IVF) kernel on the same tensors: the same live rows
        other = (dma[tier](*a, block_rows=br) if takes_plan else pruned[tier](*a))
        torch.cuda.synchronize()
        live = got[0] > NEG_INF / 2
        what = f"{name}: the live slots against the {'DMA' if takes_plan else 'pruned'} kernel's"
        if takes_plan and tier == "bfloat16":
            # the bf16 DMA kernel sums on the tensor cores, in another order
            compare_topk(got, other, full, what)
        else:
            check(torch.equal(live, other[0] > NEG_INF / 2)
                  and torch.equal(got[1][live], other[1][live])
                  and torch.equal(got[0][live].view(torch.int32), other[0][live].view(torch.int32)),
                  f"{what} differ")
        plain_ms = time_ms(lambda: plain(*a, block_rows=br), bursts=3, burst=5)
        if takes_plan:
            # the merged call is one kernel (csrc/ivf_scan_tma.cuh) after a
            # memset: no candidates, no sort. The host issues no torch.sort ...
            sort = torch.sort
            torch.sort = lambda *_, **__: check(False, f"{name}: the merged call sorts")
            try:
                kernel(*a, block_rows=br)
            finally:
                torch.sort = sort
            # ... and what the card ran (the profiler may drop events of so
            # short a window: kinds, not counts; every kind recorded must be
            # the scan or the memset)
            ran = device_kernels(lambda: kernel(*a, block_rows=br), 5)
            names = [kn for kn in ran if "memset" not in kn.lower()]
            check(len(names) <= 1 and all("ivf_tma_kernel" in kn for kn in names),
                  f"{name}: five merged calls ran {sorted(ran)}")
            n_valid = int(t["nv"])
            ms = time_held_ms(lambda: kernel(*a, block_rows=br), cold=True)
            cand_ms = time_held_ms(lambda: kernel(*a, block_rows=br, candidates=True), cold=True)
            earlier_ms = time_held_ms(
                lambda: merge_blocks(*kernel(*a, block_rows=br, candidates=True), k), cold=True)
            dma_ms = time_held_ms(lambda: dma[tier](*a, block_rows=br), cold=True)
            bms, by = ivf_bound(tier, part, n_valid, br, d, q.shape[0], k)
            print(f"  {name} {rows}x{d} block_rows={br}, n_valid {n_valid} of "
                  f"{t['ids'].numel()} listed blocks, q = {q.shape[0]}, k = {k}: merged call "
                  f"{ms:.4f} ms (one kernel, L2 cold), bound {bms:.4f} ms ({by}); earlier "
                  f"design (csrc/topk_blocks.cu candidates + merge_blocks) {earlier_ms:.4f} ms, "
                  f"its kernel alone {cand_ms:.4f} ms; {IVF_NAMES[tier]} (DMA kernel, same "
                  f"plan) {dma_ms:.4f} ms; plain {plain_ms:.4f} ms; library null [none: no one "
                  f"PyTorch call takes a top-k over gathered blocks]; five calls on the card: "
                  + ("; ".join(f"{kn.split('(')[0][:60]} x{c}" for kn, (c, _) in ran.items())
                     or "no device event recorded") + f"; max_abs_err {err}")
            library_ms = None
        else:
            ms = time_ms(lambda: kernel(*a, block_rows=br, candidates=True))
            other_ms = time_ms(lambda: pruned[tier](*a))
            desc, lib = library_call(tier, q, x, *(t["extra"] or (None,)), b, k)
            # the candidates a call just wrote sit in L2 for its merge
            merge_ms = time_held_ms(lambda: merge_blocks(*cand, k))
            call_ms = time_held_ms(lambda: kernel(*a, block_rows=br))
            library_ms = None if lib is None else time_ms(lib)
            bms, by = blocks_bound(tier, part, rows, d, q.shape[0], rows // br, k)
            print(f"  {name} {rows}x{d} block_rows={br}, q = {q.shape[0]}, k = {k}: "
                  f"kernel {ms:.4f} ms, bound {bms:.4f} ms ({by}); merge {merge_ms:.4f} ms; "
                  f"kernel + merge {call_ms:.4f} ms; plain {plain_ms:.4f} ms; "
                  f"library {'null' if lib is None else format(library_ms, '.4f') + ' ms'} "
                  f"[{desc}]; {KERNEL_NAMES[tier]} {other_ms:.4f} ms; max_abs_err {err}")
        out[name] = {"launches": counts[name], "err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bms, "bound_by": by, "library_ms": library_ms}
    return out


# ---------------------------------------------------------------------------
# 5b. main path at full size, encoder
# ---------------------------------------------------------------------------


class LastCall:
    """Stands in for an attention wrapper in the encoder module and keeps
    the inputs of its last call (the kernel still counts its launches)."""

    def __init__(self, fn):
        self.fn, self.args = fn, None

    def __call__(self, q, k, v, bias):
        self.args = (q, k, v, bias)
        return self.fn(q, k, v, bias)


class LastCallOn(LastCall):
    """``LastCall`` in place of ``module.name`` for a ``with`` block."""

    def __init__(self, module, name: str):
        super().__init__(getattr(module, name))
        self.module, self.name = module, name

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def drive_capturing(embedder, texts: list[str], name: str):
    """``embedder.embed_batch(texts)`` with the launch counts set to 0 just
    before and read just after; returns (embeddings, counts, the last
    ``name`` call's inputs)."""
    import youtu_rag_tpu_torch.models.encoder as encoder

    spy = LastCall(getattr(encoder, name))
    setattr(encoder, name, spy)
    try:
        reset_launches()
        emb = embedder.embed_batch(texts)
        torch.cuda.synchronize()
        counts = attention_counts()
    finally:
        setattr(encoder, name, spy.fn)
    return emb, counts, spy.args


def attention_bound(part: str, b: int, h: int, t: int, hd: int) -> tuple[float, str]:
    """The larger of 4·B·H·T²·hd operations at the bf16 tensor-core peak
    and the bytes moved once (q, k, v read, the output written, bf16; the
    f32 bias read) at the HBM rate. Returns (ms, "bytes" or "operations")."""
    ops_ms = 4 * b * h * t * t * hd / BF16_PEAK[part] * 1e3
    bytes_ms = (4 * b * h * t * hd * 2 + b * t * 4) / HBM_PEAK[part] * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def time_attention(name: str, args, part: str) -> dict:
    """Check the kernel on the main path's tensors, then time it, its plain
    version and scaled_dot_product_attention with the additive mask. The
    kernel and SDPA by both timers: ``time_ms`` (bursts of back-to-back
    calls; the kernels line's ``ms`` and ``library_ms``) and
    ``time_held_ms`` (one call held behind a spin of the card: its device
    time alone)."""
    kernel, plain = attention_ops()[name]
    b, h, t, hd = args[0].shape
    err = compare_attention(kernel(*args), plain(*args), f"{name} on the main path's tensors")
    ms = time_ms(lambda: kernel(*args))
    held_ms = time_held_ms(lambda: kernel(*args))
    plain_ms = time_ms(lambda: plain(*args), bursts=3, burst=3, warmup=1)
    q, k, v, bias = args
    mask = bias.to(q.dtype)[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=mask))
    library_held_ms = time_held_ms(lambda: sdpa(q, k, v, attn_mask=mask))
    bms, by = attention_bound(part, b, h, t, hd)
    tflops = 4 * b * h * t * t * hd / ms / 1e9
    print(f"  {name} [{b}, {h}, {t}, {hd}] {str(q.dtype)[6:]}: time_ms {ms:.4f} ms "
          f"({tflops:.1f} TFLOP/s), time_held_ms {held_ms:.4f} ms, bound {bms:.4f} ms ({by}); "
          f"plain {plain_ms:.4f} ms; library time_ms {library_ms:.4f} ms, time_held_ms "
          f"{library_held_ms:.4f} ms [scaled_dot_product_attention, additive mask]; "
          f"max_abs_err {err}")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bms, "bound_by": by}


def encoder_full_size(seed: int, part: str, embedder) -> dict[str, dict]:
    import dataclasses

    from youtu_rag_tpu_torch.models.embedder import TorchEmbedder
    from youtu_rag_tpu_torch.models.encoder import encode_tokens

    rng = np.random.default_rng(seed)
    words = np.array(FILLER + [w.strip(".,;?!#").lower() for t in TOPICS.values() for w in t.split()])
    cfg = embedder.cfg
    out = {}

    # the default encoder: 128 texts, 300 to 600 words (truncated to 512 tokens)
    texts = [" ".join(rng.choice(words, size=int(n))) for n in rng.integers(300, 600, 128)]
    embedder.embed_batch(texts[:8])  # warm-up
    t0 = time.perf_counter()
    emb, counts, args = drive_capturing(embedder, texts, "blockwise_attention")
    wall = time.perf_counter() - t0
    check(emb.shape == (128, cfg.embed_dim) and np.isfinite(emb).all(), "forward: bad embeddings")
    check(np.allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-3), "forward: not unit vectors")
    check(counts == {"blockwise_attention": cfg.n_layers, "flash_attention": 0,
                     "flash_attention_stats": 0}, f"forward at T = 512: launches {counts}")
    check(tuple(args[0].shape) == (128, cfg.n_heads, 512, cfg.head_dim), f"shape {args[0].shape}")
    ids, mask = embedder.tokenizer.batch(texts)
    ids_d, mask_d = torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()
    fwd_ms = time_ms(lambda: encode_tokens(embedder.params, ids_d, mask_d, cfg),
                     bursts=3, burst=3, warmup=1)
    print(f"encoder forward B = 128, T = {ids.shape[1]}: {fwd_ms:.4f} ms device "
          f"({128 / fwd_ms * 1e3:.1f} embeddings/s); embed_batch wall {wall * 1e3:.1f} ms "
          f"({128 / wall:.1f} embeddings/s, host tokenization included); launches {counts}")
    profile_split(lambda: encode_tokens(embedder.params, ids_d, mask_d, cfg), calls=1, top=8)
    out["blockwise_attention"] = {"launches": counts["blockwise_attention"],
                                  **time_attention("blockwise_attention", args, part)}
    del args

    # the same encoder with max_len 8192: two 8000-word documents → T = 8192, flash
    long_cfg = dataclasses.replace(cfg, max_len=8192, attention_impl="pallas")
    long_emb = TorchEmbedder(config=long_cfg, params=embedder.params, device="cuda")
    docs = [" ".join(rng.choice(words, size=8000)) for _ in range(2)]
    emb, counts, args = drive_capturing(long_emb, docs, "flash_attention")
    check(emb.shape == (2, cfg.embed_dim) and np.isfinite(emb).all(), "long documents: bad embeddings")
    check(counts == {"blockwise_attention": 0, "flash_attention": cfg.n_layers,
                     "flash_attention_stats": 0}, f"forward at T = 8192: launches {counts}")
    check(args[0].shape[2] == 8192, f"flash shape {args[0].shape}")
    print(f"long documents, T = 8192, batch bucket {args[0].shape[0]}: launches {counts}")
    ids, mask = long_emb.tokenizer.batch(docs, max_length=8192, pad_to=8192)
    ids_d, mask_d = torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()
    fwd_ms = time_ms(lambda: encode_tokens(long_emb.params, ids_d, mask_d, long_cfg),
                     bursts=3, burst=2, warmup=1)
    print(f"encoder forward B = 2, T = 8192: {fwd_ms:.4f} ms device "
          f"({2 / fwd_ms * 1e3:.2f} embeddings/s)")
    profile_split(lambda: encode_tokens(long_emb.params, ids_d, mask_d, long_cfg), calls=1, top=8)
    args = tuple(x[:2].contiguous() for x in args)  # the two documents: B = 2
    out["flash_attention"] = {"launches": counts["flash_attention"],
                              **time_attention("flash_attention", args, part)}
    return out


# ---------------------------------------------------------------------------
# 5e. main path at full size, the ring
# ---------------------------------------------------------------------------


class HopSpy:
    """Stands in for the hop kernel in the SP module and keeps the inputs
    of its last call (the kernel still counts its launches)."""

    def __init__(self, fn):
        self.fn, self.args = fn, None

    def __call__(self, q, k, v, bias):
        self.args = (q, k, v, bias)
        return self.fn(q, k, v, bias)


def stats_bound(part: str, b: int, h: int, t: int, t_kv: int, hd: int, elem: int):
    """The larger of 4·B·H·T·T_kv·hd operations at the bf16 tensor-core
    peak and the bytes of q, k, v (read once), the bias, and acc, m and l
    (written once) at the HBM rate. Returns (ms, "bytes" or "operations")."""
    ops_ms = 4 * b * h * t * t_kv * hd / BF16_PEAK[part] * 1e3
    nbytes = (b * h * (t + 2 * t_kv) * hd * elem + b * t_kv * 4
              + b * h * t * hd * 4 + 2 * b * h * t * 4)
    bytes_ms = nbytes / HBM_PEAK[part] * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def paired_docs(rng, words, n: int, size: int) -> list[str]:
    """n documents of ``size`` words in pairs: the second of each pair is
    the first with a tenth of its words redrawn, so each document's nearest
    neighbour is its twin."""
    docs = []
    for _ in range(n // 2):
        a = rng.choice(words, size=size)
        b = a.copy()
        swap = rng.choice(size, size=size // 10, replace=False)
        b[swap] = rng.choice(words, size=len(swap))
        docs += [" ".join(a), " ".join(b)]
    return docs


def nearest(emb: np.ndarray) -> list[int]:
    sim = emb @ emb.T
    np.fill_diagonal(sim, -np.inf)
    return sim.argmax(axis=1).tolist()


def ring_full_size(seed: int, part: str, embedder) -> dict:
    """5e: (i) the default encoder with sp_mesh=4 embeds 8 documents of
    ~3,500 words (T bucket 4096, Tl 1024), held to the unsharded forward at
    T = 4096 (blockwise), and in f32 at T = 2048; (ii) the hop kernel at
    [2, 12, 8192, 64] bf16 against 8192 keys (sp 4 over T = 32,768)."""
    import dataclasses

    import youtu_rag_tpu_torch.parallel.sequence_parallel as sp
    from youtu_rag_tpu_torch.models.embedder import TorchEmbedder
    from youtu_rag_tpu_torch.models.encoder import encode_tokens
    from youtu_rag_tpu_torch.ops.attention import (
        flash_attention_stats,
        flash_attention_stats_reference,
    )

    rng = np.random.default_rng(seed + 5)
    words = np.array(FILLER + [w.strip(".,;?!#").lower() for t in TOPICS.values() for w in t.split()])
    cfg = embedder.cfg
    out = {}

    # (i) bf16, 8 documents → T bucket 4096, Tl 1024
    docs = paired_docs(rng, words, 8, 3500)
    embedder.embed_batch(docs[:2])  # warm-up
    spy = HopSpy(sp.flash_attention_stats)
    sp.flash_attention_stats = spy
    try:
        reset_launches()
        t0 = time.perf_counter()
        emb = embedder.embed_batch(docs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = attention_counts()
    finally:
        sp.flash_attention_stats = spy.fn
    n_hops = counts["flash_attention_stats"]
    check(emb.shape == (8, cfg.embed_dim) and np.isfinite(emb).all(), "ring: bad embeddings")
    check(n_hops == cfg.n_layers * 4 and counts["blockwise_attention"] == 0,
          f"ring forward: launches {counts}, want {cfg.n_layers * 4} hops")
    q, k, v, bias = spy.args
    check(tuple(q.shape) == (32, cfg.n_heads, 1024, cfg.head_dim), f"hop shape {tuple(q.shape)}")
    err = compare_stats(flash_attention_stats(q, k, v, bias),
                        flash_attention_stats_reference(q, k, v, bias),
                        "the hop kernel on the main path's tensors bfloat16")
    seqs = [embedder.tokenizer.encode(d, embedder._long_max) for d in docs]
    ids = np.zeros((8, 4096), np.int64)
    mask = np.zeros((8, 4096), np.float32)
    for j, s in enumerate(seqs):
        ids[j, : len(s)], mask[j, : len(s)] = s, 1.0
    ids_d, mask_d = torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()
    fwd = sp.make_sp_encoder(cfg, 4)
    fwd_ms = time_ms(lambda: fwd(embedder.params, ids_d, mask_d), bursts=3, burst=2, warmup=1)
    print(f"ring forward, 8 documents of {min(map(len, seqs))}-{max(map(len, seqs))} tokens "
          f"(T = 4096, sp 4, Tl 1024): {fwd_ms:.4f} ms device ({8 / fwd_ms * 1e3:.2f} "
          f"embeddings/s); embed_batch wall {wall * 1e3:.1f} ms ({8 / wall:.2f} embeddings/s, "
          f"host tokenization included); launches {counts}")
    profile_split(lambda: fwd(embedder.params, ids_d, mask_d), calls=1, top=8)
    ref, _ = encode_tokens(embedder.params, ids_d, mask_d, cfg)
    ref = ref.cpu().numpy()
    diff = float(np.abs(emb - ref).max())
    near, near_ref = nearest(emb), nearest(ref)
    print(f"  against the unsharded forward at T = 4096 (blockwise): max |diff| {diff:.3g}, "
          f"top-1 neighbours {near} (unsharded {near_ref})")
    check(near == near_ref == [j ^ 1 for j in range(8)], "ring: top-1 neighbours differ")
    check(diff <= ENC_TOL, f"ring: embeddings differ from the unsharded forward by {diff}")
    # f32 at T = 2048 (Tl 512): JAX's own test tolerance
    f32 = TorchEmbedder(config=dataclasses.replace(cfg, dtype=torch.float32),
                        params=embedder.params, device="cuda", sp_mesh=4)
    docs32 = paired_docs(rng, words, 2, 1900)
    seqs = [f32.tokenizer.encode(d, f32._long_max) for d in docs32]
    ids = np.zeros((2, 2048), np.int64)
    mask = np.zeros((2, 2048), np.float32)
    for j, s in enumerate(seqs):
        ids[j, : len(s)], mask[j, : len(s)] = s, 1.0
    before = attention_counts()["flash_attention_stats"]
    got32 = f32.embed_batch(docs32)
    torch.cuda.synchronize()
    n_hops += attention_counts()["flash_attention_stats"] - before
    ref32, _ = encode_tokens(f32.params, torch.from_numpy(ids).cuda(),
                             torch.from_numpy(mask).cuda(), f32.cfg)
    diff32 = float(np.abs(got32 - ref32.cpu().numpy()).max())
    print(f"  f32, 2 documents at T = 2048 (Tl 512): max |diff| {diff32:.3g} from the unsharded "
          "forward (blockwise, f32)")
    check(diff32 <= 2e-5, f"ring f32: embeddings differ by {diff32} > 2e-5")

    # (ii) one hop at [2, 12, 8192, 64] bf16 against 8192 keys
    g = torch.Generator(device="cuda").manual_seed(seed + 6)
    b, h, t, hd = 2, cfg.n_heads, 8192, cfg.head_dim
    q, k, v = (torch.randn(b, h, t, hd, generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    mask = torch.ones(b, t, device="cuda")
    mask[0, t // 2 + 3 :] = 0
    bias = (1.0 - mask) * -1e9
    args = (q, k, v, bias)
    err = max(err, compare_stats(flash_attention_stats(*args),
                                 flash_attention_stats_reference(*args),
                                 "hop [2, 12, 8192, 64] bfloat16"))
    ms = time_held_ms(lambda: flash_attention_stats(*args))
    plain_ms = time_held_ms(lambda: flash_attention_stats_reference(*args), calls=3, warmup=1)
    bms, by = stats_bound(part, b, h, t, t, hd, 2)
    library_ms, lib_desc = None, ""
    try:
        eff = torch.ops.aten._scaled_dot_product_efficient_attention
        lib_bias = bias.to(q.dtype)[:, None, None, :].expand(b, h, t, t)
        eff(q, k, v, lib_bias, True)
        library_ms = time_held_ms(lambda: eff(q, k, v, lib_bias, True))
        lib_desc = ("_scaled_dot_product_efficient_attention(..., compute_log_sumexp=True): "
                    "(out, logsumexp), the hop in normalized form")
    except (RuntimeError, TypeError) as e:
        lib_desc = ("none: the efficient-attention call refused these inputs "
                    f"({str(e).splitlines()[0][:160]})")
    tflops = 4 * b * h * t * t * hd / ms / 1e9
    print(f"  flash_attention_stats [{b}, {h}, {t}, {hd}] bf16 vs {t} keys: {ms:.4f} ms "
          f"({tflops:.1f} TFLOP/s), bound {bms:.4f} ms ({by}); plain {plain_ms:.4f} ms; library "
          f"{'null' if library_ms is None else format(library_ms, '.4f') + ' ms'} [{lib_desc}]; "
          f"the mma.sync kernel's recorded time {EARLIER_MS['flash_attention_stats']} ms; "
          f"max_abs_err {err}")
    out.update(launches=n_hops, err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
               library_ms=library_ms)
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
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {name} ({part}); "
          f"{os.cpu_count()} host cores, {torch.get_num_threads()} torch threads")
    t_start = time.perf_counter()

    phase("2 build")
    build_all()

    phase("3 kernel vs plain, top-k")
    err3 = kernel_cases(args.seed)

    phase("3x kernel vs plain, any query count and k above 1024")
    err3x = query_k_cases(args.seed)

    phase("3b kernel vs plain, attention")
    err3b = attention_cases(args.seed)

    phase("3e kernel vs plain, the ring hop")
    err3e = stats_cases(args.seed)

    phase("3c kernel vs plain, IVF")
    err3c = ivf_kernel_cases(args.seed)

    phase("3f kernel vs plain, IVF: any block_rows and alignment, wide rows")
    err3f = ivf_repair_cases(args.seed)

    phase("3d kernel vs plain, per-block")
    err3d = blocks_kernel_cases(args.seed)

    phase("4 main path, small corpus")
    launches4, err4 = small_corpus(args.seed)

    phase("4b main path, small corpus, encoder")
    enc, err4b = encoder_corpus(args.seed)

    phase("4c main path, small corpus, IVF")
    launches4c, err4c = small_corpus_ivf(args.seed)

    phase("4d main path, small corpus, long documents")
    long4d = long_corpus(args.seed, enc["embedder"])

    phase("4e main path, small corpus, a pretrained BERT-family checkpoint")
    bert4e = bert_corpus(args.seed, smi)

    phase("5 main path, full size")
    full, keep5 = full_size(args.seed, part)

    phase("5c main path, full size, IVF")
    full_ivf, keep5c = full_size_ivf(args.seed, part)

    phase("5d ops path, full size, per-block")
    full_blocks = ops_full_size(part, keep5, keep5c)
    del keep5, keep5c
    torch.cuda.empty_cache()

    phase("5b main path, full size, encoder")
    enc_full = encoder_full_size(args.seed, part, enc["embedder"])

    phase("5e main path, full size, the ring")
    ring = ring_full_size(args.seed, part, long4d["embedder"])

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
            "max_abs_err": max(err3[tier], err3x[kname], err4[tier], f["err"]),
            "ms": f["ms"],
            "plain_ms": f["plain_ms"],
            "bound_ms": f["bound_ms"],
            "bound_by": f["bound_by"],
            "library_ms": f["library_ms"],
        })
    for kname in ATTENTION_NAMES:
        f = enc_full[kname]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "youtu_rag_tpu_torch/csrc/attention.cu",
            "replaces": REPLACES[kname],
            "launches": (enc["launches"][kname] + f["launches"]
                         + (bert4e["launches"] if kname == "blockwise_attention" else 0)),
            "max_abs_err": max(err3b[kname], f["err"],
                               bert4e["errs"]["attention"] if kname == "blockwise_attention"
                               else 0.0),
            "ms": f["ms"],
            "plain_ms": f["plain_ms"],
            "bound_ms": f["bound_ms"],
            "bound_by": f["bound_by"],
            "library_ms": f["library_ms"],
        })
    for tier in TIERS:
        kname, f = IVF_NAMES[tier], full_ivf[tier]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "youtu_rag_tpu_torch/csrc/ivf_scan_tma.cuh",
            "replaces": REPLACES[kname],
            "launches": launches4c[tier] + f["launches"],
            "max_abs_err": max(err3c[tier], err3x[kname], err3f[kname], err4c[tier], f["err"]),
            "ms": f["ms"],
            "plain_ms": f["plain_ms"],
            "bound_ms": f["bound_ms"],
            "bound_by": f["bound_by"],
            "library_ms": None,  # no one PyTorch call computes a top-k over gathered blocks
        })
    for kname in BLOCKS_NAMES:
        f = full_blocks[kname]
        kernels.append({
            "name": kname,
            "route": "cuda",
            # the merged IVF calls: csrc/ivf_topk.cu's ivf_blocks_* entries
            "source": ("youtu_rag_tpu_torch/csrc/ivf_scan_tma.cuh" if kname.startswith("ivf")
                       else "youtu_rag_tpu_torch/csrc/topk_blocks.cu"),
            "replaces": REPLACES[kname],
            "launches": f["launches"],
            "max_abs_err": max(err3d[kname], err3x[kname], err3f.get(kname, 0.0), f["err"]),
            "ms": f["ms"],
            "plain_ms": f["plain_ms"],
            "bound_ms": f["bound_ms"],
            "bound_by": f["bound_by"],
            "library_ms": f["library_ms"],  # null for IVF, as above
        })
    kernels.append({
        "name": "flash_attention_stats",
        "route": "cuda",
        "source": "youtu_rag_tpu_torch/csrc/attention_wgmma.cuh",
        "replaces": REPLACES["flash_attention_stats"],
        "launches": long4d["launches"] + ring["launches"],
        "max_abs_err": max(err3e, ring["err"]),
        "ms": ring["ms"],
        "plain_ms": ring["plain_ms"],
        "bound_ms": ring["bound_ms"],
        "bound_by": ring["bound_by"],
        "library_ms": ring["library_ms"],
    })
    print(f"encoder KB max differences: (a) {err4b['a']}, (b) {err4b['b']}; BERT-base "
          f"(4e): {bert4e['errs']}")
    print(f"phases 2-6: {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
