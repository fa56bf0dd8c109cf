"""Where the brute int4 scan's time goes, on one card: the ring's int4 tier
over the identity plan, as it stands and with one part taken out at a time,
and the checkout's own ``topk_int4_pruned`` across k.

    python -m youtu_rag_tpu_torch.bench.ring_variants [TREE ...]

Each TREE is a directory that holds a checkout of the repo (default: this
one); each runs in a process of its own, in the order given. For a tree, the
script copies its ``csrc/ivf_scan_tma.cuh`` (and the headers it includes)
into a temporary directory, changes one thing in each copy by a textual
patch, and builds each copy with one entry, ``IVF_TMA_C_INTERFACE(...,
ivf_tma::Int4, false, true)``: the int4 DMA kernels over the identity plan
(one block of all n rows). The copies are measurements, not kernels of the
port, and give wrong results where they take work out:

- ``as it stands``;
- ``unpack skipped``: the packed words go to the tensor cores as they are
  (the same ``mma.sync`` count, no nibble unpacking);
- ``int8 load``: the packed bytes are scored as int8 rows of d/2 columns
  (half the ``mma.sync``, no unpacking);
- ``no selection``: the rows are scored and no list takes them;
- ``no merge``: the last CTA returns before it merges the CTAs' lists;
- ``merge skipped at run time``: the same, with the merge's code kept in
  the kernel (a branch the compiler cannot drop).

Each copy is timed at k = 10 and 64 on 1,048,576 × 768 seeded unit rows
packed to int4, q = 8 (``chip_smoke.py`` phase 5's shapes), the unchanged
one also at k = 128, 256 and 1024, then the tree's ``topk_int4_pruned``
(its design, whatever the tree holds) at k = 10, 64, 128, 256 and 1024. Two timers, as ``ab_kernels.py``'s: one call held behind
a spin of the card (median of 20; the device time) and bursts of 20 calls.
Prints the card's name and power limit, then one JSON line per tree.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

HOLD_CYCLES = 4_000_000  # chip_smoke.py's spin: longer than the host takes to enqueue a call
ROWS, D, QN = 1 << 20, 768, 8
ENTRY = r'''
#include "ivf_scan_tma.cuh"
IVF_TMA_C_INTERFACE(variant_int4, ivf_tma::Int4, false, true)
extern "C" const char* variant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
'''
VARIANT_KS = (10, 64)
TREE_KS = (10, 64, 128, 256, 1024)


def patch(text: str, variant: str) -> str:
    """``ivf_scan_tma.cuh`` with one change (module docstring)."""
    if variant == "as it stands":
        return text
    if variant == "unpack skipped":
        old = ("const uint32_t a[4] = {ua & 0x0f0f0f0fu, ub & 0x0f0f0f0fu, (ua >> 4) & 0x0f0f0f0fu,\n"
               "                           (ub >> 4) & 0x0f0f0f0fu};")
        return text.replace(old, "const uint32_t a[4] = {wa, wb, wa, wb}; (void)ua; (void)ub;", 1)
    if variant == "int8 load":
        anchor = '    static_assert(!kWide, "int4 has no wide plan");\n'
        i = text.index(anchor, text.index("struct Int4")) + len(anchor)
        return (text[:i] + "    quarter_dots<int, mma_s8>(qt, d + kQPad, rows, d / 2, d / 32, "
                "quarter, lane, acc);\n    return;\n" + text[i:])
    if variant == "no selection":
        loop = text.index("for (int i = 0;; ++i)")
        for key in ("      if constexpr (kList == kListWarp) {\n        // entry i in lane i",
                    "      if constexpr (kRegList > 0) {"):
            i = text.find(key, loop)
            if i >= 0:
                return text[:i] + "      continue;  // no selection\n" + text[i:]
        raise ValueError("no selection: anchor not found")
    if variant == "no merge":
        return text.replace("  if (!last_cta) return;", "  return;", 1)
    if variant == "merge skipped at run time":
        return text.replace("  if (!last_cta) return;", "  if (!last_cta || a.k > 0) return;", 1)
    raise ValueError(variant)


VARIANTS = ("as it stands", "unpack skipped", "int8 load", "no selection", "no merge",
            "merge skipped at run time")


def build(csrc: Path, out: Path, variant: str) -> Path:
    """One variant's library, built from a patched copy of ``csrc``."""
    from youtu_rag_tpu_torch.ops import _build

    src = out / variant.replace(" ", "_")
    src.mkdir(parents=True)
    for f in ("topk_scorers.cuh", "topk_select.cuh"):
        (src / f).write_text((csrc / f).read_text())
    text = (csrc / "ivf_scan_tma.cuh").read_text()
    patched = patch(text, variant)
    if variant != "as it stands" and patched == text:
        raise RuntimeError(f"{variant}: the patch found nothing to change")
    (src / "ivf_scan_tma.cuh").write_text(patched)
    (src / "variant.cu").write_text(ENTRY)
    lib = src / "variant.so"
    done = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(src / "variant.cu")], capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed for {variant}:\n{done.stdout}{done.stderr}")
    return lib


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


def variant_call(lib, q, x, xs, bias, k: int):
    """One launch of a variant's entry over the identity plan (one block of
    all n rows), sized as ``ops/topk.py::_launch_tma`` sizes it."""
    import torch

    from youtu_rag_tpu_torch.ops.topk import _list_ctas

    n, d, qn = x.shape[0], 2 * x.shape[1], q.shape[0]
    dev = x.device
    tiles = -(-qn // 8)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_sm = min(lib.variant_int4_ctas_per_sm(d, k), 2)
    n_cta = _list_ctas(max(1, min(per_sm * sms // tiles, -(-n // 512))), 8 * tiles, k)
    cand = (tiles, n_cta, 8, -(-k // 4) * 4)
    cand_s = torch.empty(cand, dtype=torch.float32, device=dev)
    cand_i = torch.empty(cand, dtype=torch.int32, device=dev)
    counter = torch.empty(18 * tiles, dtype=torch.int32, device=dev)
    out_s = torch.empty((qn, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, k), dtype=torch.int32, device=dev)
    err = lib.variant_int4_launch(q.data_ptr(), 0, x.data_ptr(), xs.data_ptr(), bias.data_ptr(),
                                  None, None, cand_s.data_ptr(), cand_i.data_ptr(),
                                  counter.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), qn, n, d,
                                  k, 1, n, n_cta, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"variant launch failed: CUDA error {err} "
                           f"({lib.variant_error_string(err).decode()})")
    return out_s, out_i


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.variant_int4_launch.argtypes = [p, i] + [p] * 10 + [i] * 7 + [p]
    lib.variant_int4_launch.restype = i
    lib.variant_int4_ctas_per_sm.argtypes = [i, i]
    lib.variant_int4_ctas_per_sm.restype = i
    lib.variant_error_string.argtypes = [i]
    lib.variant_error_string.restype = ctypes.c_char_p
    return lib


def measure(tree: str) -> dict:
    """The timings of ``tree``'s variants and wrapper (in the child process)."""
    import torch

    import youtu_rag_tpu_torch
    from youtu_rag_tpu_torch.ops.topk import NEG_INF, quantize_rows_int4, topk_int4_pruned

    csrc = Path(youtu_rag_tpu_torch.__file__).parent / "csrc"
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(ROWS, D, generator=g, device="cuda")
    x /= x.norm(dim=1, keepdim=True)
    q = torch.randn(QN, D, generator=g, device="cuda")
    q /= q.norm(dim=1, keepdim=True)
    bias = torch.zeros(ROWS, device="cuda")
    x4, s4 = quantize_rows_int4(x)
    del x
    out = {"tree": tree, "package": str(csrc.parent)}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {v: load(build(csrc, Path(tmp), v)) for v in VARIANTS}
        for k in VARIANT_KS:
            # the unchanged copy answers as the tree's wrapper on the live slots
            want = variant_call(libs["as it stands"], q, x4, s4, bias, k)
            got = topk_int4_pruned(q, x4, s4, bias, k)
            live = want[0] > NEG_INF / 2
            if not (torch.equal(want[0], got[0]) and torch.equal(want[1][live], got[1][live])):
                raise RuntimeError(f"k={k}: the unchanged copy and the wrapper disagree")
            for v, lib in libs.items():
                fn = (lambda lib=lib: variant_call(lib, q, x4, s4, bias, k))
                out[f"variant {v} k={k}"] = {"held_ms": held_ms(fn), "burst_ms": burst_ms(fn)}
        for k in TREE_KS[len(VARIANT_KS):]:
            fn = (lambda k=k: variant_call(libs["as it stands"], q, x4, s4, bias, k))
            out[f"variant as it stands k={k}"] = {"held_ms": held_ms(fn), "burst_ms": burst_ms(fn)}
    for k in TREE_KS:
        fn = (lambda k=k: topk_int4_pruned(q, x4, s4, bias, k))
        out[f"topk_int4_pruned k={k}"] = {"held_ms": held_ms(fn), "burst_ms": burst_ms(fn)}
    return out


def main(argv: list[str]) -> int:
    if argv[:1] == ["--child"]:
        print(json.dumps(measure(argv[1])), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for tree in argv or [str(Path(__file__).resolve().parents[2])]:
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
