"""Time the brute top-k and attention wrappers of several checkouts in
turns, on one card, to compare two versions inside one run.

    python -m youtu_rag_tpu_torch.bench.ab_kernels PARENT . . PARENT

Each argument is a directory that holds a checkout of the repo (or of
``youtu_rag_tpu_torch/`` alone); each runs in a process of its own, in
the order given, and builds its own kernels. On tensors drawn on the card
from one seed it times ``topk_pruned`` (bf16, k = 10), ``topk_int8_pruned``
(k = 10) and ``topk_int4_pruned`` (k = 64 and 10) at 1,048,576 × 768, q = 8
(the calls of ``chip_smoke.py`` phase 5); the three IVF scans,
``ivf_topk_dma`` and ``ivf_topk_int8_dma`` at k = 10 and
``ivf_topk_int4_dma`` at k = 64 (each also at the other k), on phase 5c's plans
(``configs/rag/ivf_int8.yaml``'s index settings over 1,048,576 × 768
clustered rows; the search's adaptive plan and the fixed n_probe 64 plan;
L2 cold), and on the same plans the per-block calls ``ivf_topk`` and
``ivf_topk_int8`` (k = 10, block_rows 1024, merged: the ``ops`` path),
each with the kernels one call runs on the card (torch.profiler); ``blockwise_attention`` at
[128, 12, 512, 64] and ``flash_attention`` at [2, 12, 8192, 64], bf16
(phase 5b's shapes), the same operations at hd 128 ([64, 6, 512, 128],
[2, 6, 8192, 128]) and at a whole number of 132-CTA rounds of work items
([132, 12, 512, 64]: 6,336 items; [1, 33, 8192, 64]: 2,112), each beside
``scaled_dot_product_attention`` on the same tensors with the same
additive mask as phase 5b (so that kernel and library come from one
process on one card), and ``flash_attention_stats`` at [2, 12, 8192, 64]
against 8192 keys (phase 5e's hop) and at [32, 12, 1024, 64] against 1024
keys (the ring's own hop at T = 4096, sp 4). Two timers: bursts of 20 back-to-back calls
(``chip_smoke.py``'s ``time_ms``: the host's enqueue can bound it when a
call is short) and one call held behind a spin of the card (its
``time_held_ms``: the device time). Each run builds its tree's sources
with ptxas' report and lists every kernel's registers and spills
(``registers``). Prints one JSON line per run and the card's name and power
limit.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import threading

HOLD_CYCLES = 4_000_000  # chip_smoke.py's spin: longer than the host takes to enqueue a call
# (name, wrapper, shape); the persistent grid's rounds are the shape's
# B * H * T / 128 items over 132 CTAs
ATTENTION_CALLS = (
    ("blockwise_attention", "blockwise_attention", (128, 12, 512, 64)),
    ("flash_attention", "flash_attention", (2, 12, 8192, 64)),
    ("blockwise_attention hd 128", "blockwise_attention", (64, 6, 512, 128)),
    ("flash_attention hd 128", "flash_attention", (2, 6, 8192, 128)),
    ("blockwise_attention 48 rounds", "blockwise_attention", (132, 12, 512, 64)),
    ("flash_attention 16 rounds", "flash_attention", (1, 33, 8192, 64)),
    ("flash_attention_stats", "flash_attention_stats", (2, 12, 8192, 64)),
    ("flash_attention_stats ring hop", "flash_attention_stats", (32, 12, 1024, 64)),
)


def ivf_index_config(tier: str):
    """``configs/rag/ivf_int8.yaml``'s index at storage ``tier``, read
    through the config loader as ``chip_smoke.py`` phase 5f reads it."""
    from youtu_rag_tpu_torch.core.loader import ConfigLoader

    icfg = ConfigLoader().load_rag_config("ivf_int8").vector_store.index
    return icfg.model_copy(update={"storage_dtype": tier})


def short_kernel_name(mangled: str) -> str:
    """A kernel's name from its mangled form: the Hopper attention kernel
    with its head width and entry, the mma.sync attention kernel with its
    type, the scan kernels with their tier or scorer, k class and row source."""
    entries = ("blockwise", "flash", "stats")
    m = re.search(r"attention_wgmma16attention_kernelILi(\d+)EL([ib])(\d)E", mangled)
    if m:
        return f"attention_wgmma::attention_kernel<hd {m.group(1)}, {entries[int(m.group(3))]}>"
    m = re.search(r"attention_kernelI(f|13__nv_bfloat16)Li(\d+)ELb([01])ELb([01])E", mangled)
    if m:
        entry = "stats" if m.group(4) == "1" else entries[int(m.group(3))]
        dtype = "f32" if m.group(1) == "f" else "bf16"
        return f"attention.cu mma.sync attention_kernel<{dtype}, hd {m.group(2)}, {entry}>"
    m = re.search(r"topk_scan_kernelI\w+?(\w{4}Scorer)ELi(\d)ELb([01])E", mangled)
    if m:  # the per-block candidates' scan
        k_class = ("k <= 128", "k <= 1024", "k > 1024")[int(m.group(2))]
        return f"topk_scan_kernel<{m.group(1)}, {k_class}, ivf={m.group(3)}>"
    m = re.search(r"ivf_tma14ivf_tma_kernelINS_(\d)(\w+?)ELi(\d)E(?:Lb([01])E)?(?:Lb([01])E)?",
                  mangled)
    if m:
        k_class = ("k <= 128", "k <= 1024", "device lists", "k <= 32", "k <= 64",
                   "k <= 128")[int(m.group(3))]
        contract = ", per-block" if m.group(4) == "1" else ""
        wide = ", wide" if m.group(5) == "1" else ""
        return f"ivf_tma_kernel<{m.group(2)[: int(m.group(1))]}, {k_class}{contract}{wide}>"
    return mangled


def ptxas_report(log: str) -> list[tuple[str, int, str]]:
    """(kernel, registers, "stores/loads" spill bytes) per entry of an
    ``nvcc -Xptxas -v`` log."""
    out, name, spills = [], None, "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spills = m.group(1), "?"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((short_kernel_name(name), int(m.group(1)), spills))
            name = None
    return out


def burst_ms(fn, bursts: int = 5, burst: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(bursts):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(burst):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / burst)
    return statistics.median(times)


def held_ms(fn, calls: int = 20, warmup: int = 3, cold: bool = False) -> float:
    """One call's device time behind a spin of the card; ``cold`` first
    evicts the 50 MB L2 with a 1 GiB write."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.float32, device="cuda") if cold else None
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(calls):
        if cold:
            flush.zero_()
        torch.cuda._sleep(HOLD_CYCLES)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def ivf_calls(g):
    """The three IVF scans on chip_smoke.py phase 5c's plans: per tier an
    IVF index with ``ivf_index_config``'s settings over one set of 1,048,576 × 768 clustered
    unit rows (1024 centers, spread 0.7), the search's adaptive probe plan
    and the fixed one (margin off) for 8 queries near centers 0..7, k as
    the search asks (10; int4 64), and for bf16 and int8 the per-block
    merged call (``ivf_topk``, ``ivf_topk_int8``) and the DMA call at
    k = 64 on the same plan. Yields
    (name, the call, n_valid, the wrapper, its arguments before
    ``block_rows``)."""
    import numpy as np
    import torch

    from youtu_rag_tpu_torch.core.types import Chunk
    from youtu_rag_tpu_torch.index.device_index import DeviceVectorIndex
    from youtu_rag_tpu_torch.index.ivf import plan_max_blocks, probe_blocks
    from youtu_rag_tpu_torch.ops import ivf

    rows, d, qn, batch = 1 << 20, 768, 8, 1 << 18
    centers = torch.randn(1024, d, generator=g, device="cuda")
    centers /= centers.norm(dim=1, keepdim=True)
    noise = 0.7 / np.sqrt(d)
    vecs = []
    for _ in range(0, rows, batch):
        v = centers[torch.randint(0, 1024, (batch,), generator=g, device="cuda")]
        v = v + noise * torch.randn(batch, d, generator=g, device="cuda")
        vecs.append((v / v.norm(dim=1, keepdim=True)).cpu().numpy())
    q = centers[:qn] + 0.5 * noise * torch.randn(qn, d, generator=g, device="cuda")
    q /= q.norm(dim=1, keepdim=True)
    chunks = [Chunk(f"c{j}", "doc", "", 0) for j in range(rows)]
    for tier, name, k in (("bfloat16", "ivf_topk_dma", 10), ("int8", "ivf_topk_int8_dma", 10),
                          ("int4", "ivf_topk_int4_dma", 64)):
        cfg = ivf_index_config(tier)
        br = cfg.block_rows
        index = DeviceVectorIndex(d, cfg, device="cuda")
        index.reserve(rows)
        for i, v in enumerate(vecs):
            index.add(chunks[i * batch : (i + 1) * batch], v)
        index.build_ivf()
        st, total = index._ivf, index.capacity // br
        x, b = index._vectors, index._bias
        extra = () if tier == "bfloat16" else (index._scales,)
        fn = getattr(ivf, name)
        for label, margin in (("adaptive", cfg.ivf_adaptive_margin), ("fixed", 0.0)):
            kw = ({"adaptive_margin": margin, "min_probe": min(index.config.ivf_min_probe,
                                                               st.n_probe)} if margin else {})
            ids, nv = probe_blocks(q, st.centroids, st.cluster_block_start,
                                   st.cluster_block_count, n_probe=st.n_probe,
                                   max_cluster_blocks=st.max_cluster_blocks, total_blocks=total,
                                   frozen_blocks=st.frozen_blocks,
                                   max_blocks=plan_max_blocks(st, qn, total), **kw)
            args = (q, x, *extra, b, ids, nv, k)
            yield (f"{name} k={k} ({label} plan, L2 cold)",
                   lambda args=args: fn(*args, block_rows=br),
                   int(nv), fn, args)
            if tier != "int4":  # the per-block merged call (ops path) on the same plan
                blocks = ivf.ivf_topk if tier == "bfloat16" else ivf.ivf_topk_int8
                yield (f"{blocks.__name__} merged k={k} ({label} plan, L2 cold)",
                       lambda args=args, blocks=blocks: blocks(
                           *args, block_rows=br),
                       int(nv), blocks, args)
            # and the DMA entry at the other tiers' k (64: the register lists
            # of 33 <= k <= 64; int4 at 10)
            k2 = 10 if k == 64 else 64
            args2 = (*args[:-1], k2)
            yield (f"{name} k={k2} ({label} plan, L2 cold)",
                   lambda args=args2: fn(*args, block_rows=br),
                   int(nv), fn, args2)
        del index, x, b, extra
        torch.cuda.empty_cache()


def device_kernels(fn) -> list[str]:
    """The device activities of one call of ``fn`` (torch.profiler), with
    their counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [f"{e.key.split('(')[0][:70]} x{e.count}" for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def measure(tree: str) -> dict:
    """The timings of ``tree``'s wrappers (run inside the child process)."""
    import torch

    import youtu_rag_tpu_torch
    from youtu_rag_tpu_torch.ops import _build
    from youtu_rag_tpu_torch.ops import attention
    from youtu_rag_tpu_torch.ops.topk import (
        quantize_rows_int4,
        quantize_rows_int8,
        topk_int4_pruned,
        topk_int8_pruned,
        topk_pruned,
    )

    # every source of the tree, whatever it holds
    sources = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    logs = {}
    threads = [threading.Thread(target=lambda n=n: logs.update({n: _build.build(n, verbose=True)}))
               for n in sources]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(1 << 20, 768, generator=g, device="cuda")
    x /= x.norm(dim=1, keepdim=True)
    q = torch.randn(8, 768, generator=g, device="cuda")
    q /= q.norm(dim=1, keepdim=True)
    bias = torch.zeros(1 << 20, device="cuda")
    x16 = x.to(torch.bfloat16)
    x8, s8 = quantize_rows_int8(x)
    x4, s4 = quantize_rows_int4(x)
    del x
    calls = {
        "topk_pruned k=10": lambda: topk_pruned(q, x16, bias, 10),
        "topk_int8_pruned k=10": lambda: topk_int8_pruned(q, x8, s8, bias, 10),
        "topk_int4_pruned k=64": lambda: topk_int4_pruned(q, x4, s4, bias, 64),
        "topk_int4_pruned k=10": lambda: topk_int4_pruned(q, x4, s4, bias, 10),
    }
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, wrapper, shape in ATTENTION_CALLS:
        fn = getattr(attention, wrapper)
        qkv = [torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16) for _ in range(3)]
        b = torch.zeros(shape[0], shape[2], device="cuda")
        calls[name] = lambda fn=fn, qkv=qkv, b=b: fn(*qkv, b)
        if wrapper != "flash_attention_stats":
            mask = b.to(torch.bfloat16)[:, None, None, :]  # chip_smoke.py's time_attention
            calls[f"sdpa {list(shape)}"] = lambda qkv=qkv, mask=mask: sdpa(*qkv, attn_mask=mask)
    out = {"tree": tree, "package": os.path.dirname(youtu_rag_tpu_torch.__file__),
           "registers": {f"{n}: {k}": f"{r} registers, spills {sp}" for n in sources
                         for k, r, sp in ptxas_report(logs[n]["log"])}}
    for name, fn in calls.items():
        out[name] = {"burst_ms": burst_ms(fn), "held_ms": held_ms(fn)}
    del calls
    torch.cuda.empty_cache()
    for name, fn, n_valid, *_ in ivf_calls(g):
        out[name] = {"n_valid": n_valid, "held_ms": held_ms(fn, cold=True),
                     "kernels": device_kernels(fn)}
    return out


def main(argv: list[str]) -> int:
    if argv[:1] == ["--child"]:
        print(json.dumps(measure(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for tree in argv:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
        # this file, run by its path, imports the tree's package
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                               os.path.abspath(tree)],
                              env=env, cwd=os.path.abspath(tree), check=False)
        if done.returncode:
            return done.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
