"""Time the brute top-k and attention wrappers of several checkouts in
turns, on one card, to compare two versions inside one run.

    python -m youtu_rag_tpu_torch.bench.ab_kernels PARENT . . PARENT

Each argument is a directory that holds a checkout of the repo (or of
``youtu_rag_tpu_torch/`` alone); each runs in a process of its own, in
the order given, and builds its own kernels. On tensors drawn on the card
from one seed it times ``topk_pruned`` (bf16, k = 10), ``topk_int8_pruned``
(k = 10) and ``topk_int4_pruned`` (k = 64) at 1,048,576 × 768, q = 8 (the
calls of ``chip_smoke.py`` phase 5), ``blockwise_attention`` at
[128, 12, 512, 64] and ``flash_attention`` at [2, 12, 8192, 64], bf16
(phase 5b's shapes), the same operations at hd 128 ([64, 6, 512, 128],
[2, 6, 8192, 128]) and at a whole number of 132-CTA rounds of work items
([132, 12, 512, 64]: 6,336 items; [1, 33, 8192, 64]: 2,112), each beside
``scaled_dot_product_attention`` on the same tensors with the same
additive mask as phase 5b (so that kernel and library come from one
process on one card), and ``flash_attention_stats`` at [2, 12, 8192, 64]
against 8192 keys (phase 5e's hop). Two timers: bursts of 20 back-to-back calls
(``chip_smoke.py``'s ``time_ms``: the host's enqueue can bound it when a
call is short) and one call held behind a spin of the card (its
``time_held_ms``: the device time). Prints one JSON line per run and the
card's name and power limit.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading

SOURCES = ("topk_pruned", "topk_int8_pruned", "topk_int4_pruned", "attention")
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
)


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


def held_ms(fn, calls: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(calls):
        torch.cuda._sleep(HOLD_CYCLES)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


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

    threads = [threading.Thread(target=_build.build, args=(n,)) for n in SOURCES]
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
    out = {"tree": tree, "package": os.path.dirname(youtu_rag_tpu_torch.__file__)}
    for name, fn in calls.items():
        out[name] = {"burst_ms": burst_ms(fn), "held_ms": held_ms(fn)}
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
