"""Where the time of one IVF scan call goes, on one card.

    python -m youtu_rag_tpu_torch.bench.ivf_trace [--tiers bfloat16,int8,int4]

On ``chip_smoke.py`` phase 5c's plans (``bench/ab_kernels.py``'s
``ivf_calls``: the adaptive and the fixed plan over 1,048,576 × 768
clustered rows, k = 10, int4 k = 64) it times each call with the held timer
(``ab_kernels.held_ms``) under variants that separate the fixed cost from
the streaming:

- ``cold``: L2 evicted by a 1 GiB write before each call (phase 5c's
  timer); ``cold, read flush``: evicted by a 1 GiB read, so that L2 holds
  no dirty lines to write back; ``warm``: no eviction;
- ``empty plan``: n_valid 0 (launch, query prep, list writes, the merge);
- ``n_cta``: the grid's CTAs per query tile forced to other counts.

Then it builds a copy of the tree's ``csrc/ivf_topk.cu`` whose scan kernel
records ``%globaltimer`` (ns) in thread 0 of each CTA of the first query
tile at nine points (start, queries prepared, first stages issued,
prologue done, first stage arrived, stages done, ticket taken, the merge's
windows loaded, merge done) and, in CTA 0, three per stage (the stage
arrived, scored to the barrier, selected), and prints, for one L2-cold
call, the median and the largest of each point over the CTAs, from the
first CTA's start, and CTA 0's stage parts, beside the CUDA events' time
of the call. The copy is for timing
only: its results are not used. Prints JSON lines and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess

from youtu_rag_tpu_torch.bench.ab_kernels import HOLD_CYCLES, held_ms, ivf_calls

POINTS = ("start", "prepared", "issued", "prologue done", "first stage", "stages done", "ticket",
          "windows loaded", "merge done")
# (old, new) text of the copy's header: a record at each point
TRACE_PATCHES = (
    ("namespace ivf_tma {\n",
     "namespace ivf_tma {\n__device__ unsigned long long g_trace[1024][16];\n"
     "__device__ unsigned long long g_stage[256][4];\n"
     "__device__ __forceinline__ unsigned long long now_() { unsigned long long t_; "
     "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); return t_; }\n"
     "#define TRACE(n) if (threadIdx.x == 0 && blockIdx.y == 0 && blockIdx.x < 1024) "
     "g_trace[blockIdx.x][n] = now_();\n"
     "#define TRACE_STAGE(i, n) if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 "
     "&& (i) < 256) g_stage[i][n] = now_();\n"),
    ("  const int cta = blockIdx.x, n_cta = gridDim.x;\n",
     "  const int cta = blockIdx.x, n_cta = gridDim.x;\n  TRACE(0);\n"),
    ("      for (int i = 0; i < S && more; ++i) issue(i);\n    }\n  };\n",
     "      for (int i = 0; i < S && more; ++i) issue(i);\n      TRACE(2);\n    }\n  };\n"),
    ("q0, q_valid, d, first_fill);\n  }\n", "q0, q_valid, d, first_fill);\n  }\n  TRACE(1);\n"),
    ("  __syncthreads();\n\n  // this warp's list",
     "  __syncthreads();\n  TRACE(3);\n\n  // this warp's list"),
    ("    if (v0 < 0) break;  // the same for every thread: the scan is over\n",
     "    if (v0 < 0) break;  // the same for every thread: the scan is over\n"
     "    if (i == 0) TRACE(4);\n    TRACE_STAGE(i, 0);\n"),
    ("    if (threadIdx.x == 0 && more) issue(i + S);\n",
     "    if (threadIdx.x == 0 && more) issue(i + S);\n    TRACE_STAGE(i, 1);\n"),
    ("          pending &= __ballot_sync(kFull, better(s, row, thr_s, thr_i));\n        }\n"
     "      }\n    }\n  }\n",
     "          pending &= __ballot_sync(kFull, better(s, row, thr_s, thr_i));\n        }\n"
     "      }\n    }\n    TRACE_STAGE(i, 2);\n  }\n"),
    ("  // this CTA's lists as candidates", "  TRACE(5);\n  // this CTA's lists as candidates"),
    ("  if (!last_cta) return;\n", "  TRACE(6);\n  if (!last_cta) return;\n"),
    ("  __syncthreads();\n  if (!selects) return;\n",
     "  __syncthreads();\n  TRACE(7);\n  if (!selects) return;\n"),
    ("  if constexpr (kProbe) {\n    if (n_out < k) {\n",
     "  TRACE(8);\n  if constexpr (kProbe) {\n    if (n_out < k) {\n"),
)
TRACE_C = """
extern "C" int ivf_trace_read(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, ivf_tma::g_trace, sizeof(ivf_tma::g_trace));
}
extern "C" int ivf_trace_stages(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, ivf_tma::g_stage, sizeof(ivf_tma::g_stage));
}
extern "C" int ivf_trace_clear() {
  static unsigned long long zero[1024][16];
  int err = (int)cudaMemcpyToSymbol(ivf_tma::g_trace, zero, sizeof(zero));
  return err ? err : (int)cudaMemcpyToSymbol(ivf_tma::g_stage, zero, sizeof(unsigned long long) * 1024);
}
"""


def trace_library() -> ctypes.CDLL:
    """``csrc/ivf_topk.cu`` built from a copy carrying TRACE_PATCHES."""
    from youtu_rag_tpu_torch.ops import _build

    src = _build.BUILD_DIR / "trace"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, src)
    header = src / "ivf_scan_tma.cuh"
    text = header.read_text()
    for old, new in TRACE_PATCHES:
        if text.count(old) != 1:
            raise RuntimeError(f"trace patch does not apply: {old!r}")
        text = text.replace(old, new)
    header.write_text(text)
    with open(src / "ivf_topk.cu", "a") as f:
        f.write(TRACE_C)
    lib = src / "ivf_topk.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src / "ivf_topk.cu")], check=True)
    return ctypes.CDLL(str(lib))


def traced_call(lib, fn, args, block_rows: int) -> dict:
    """One L2-cold call of ``fn`` through the traced library: the points'
    median and largest offsets over the CTAs (µs from the first start),
    the CUDA events' time of the call (µs) and the CTA count."""
    import numpy as np
    import torch

    flush = torch.empty(256 << 20, dtype=torch.float32, device="cuda")
    fn(*args, block_rows=block_rows)
    torch.cuda.synchronize()
    lib.ivf_trace_clear()
    flush.zero_()
    torch.cuda._sleep(HOLD_CYCLES)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    fn(*args, block_rows=block_rows)
    e1.record()
    e1.synchronize()
    buf = np.zeros((1024, 16), np.uint64)
    err = lib.ivf_trace_read(ctypes.c_void_p(buf.ctypes.data))
    if err:
        raise RuntimeError(f"ivf_trace_read: CUDA error {err}")
    ctas = buf[buf[:, 0] > 0].astype(np.int64)
    t0 = ctas[:, 0].min()
    out = {"n_cta": int(len(ctas)), "events_us": e0.elapsed_time(e1) * 1e3}
    for j, name in enumerate(POINTS):
        col = ctas[:, j][ctas[:, j] > 0] - t0
        if len(col):
            out[name] = {"median_us": float(np.median(col)) / 1e3,
                         "max_us": float(col.max()) / 1e3}
    # CTA 0's stages: waiting for the stage (from the end of the previous
    # selection, or of the prologue), scoring to the barrier, selecting
    st = np.zeros((256, 4), np.uint64)
    lib.ivf_trace_stages(ctypes.c_void_p(st.ctypes.data))
    st = st[(st[:, 0] > 0) & (st[:, 2] > 0)].astype(np.int64)
    if len(st):
        prev = np.concatenate([[buf[0, 3]], st[:-1, 2]]).astype(np.int64)
        parts = {"wait": st[:, 0] - prev, "score and barrier": st[:, 1] - st[:, 0],
                 "select": st[:, 2] - st[:, 1]}
        out["cta 0 stages"] = {"count": int(len(st)), **{
            k: {"median_us": float(np.median(v)) / 1e3, "sum_us": float(v.sum()) / 1e3}
            for k, v in parts.items()}}
    return out


def main() -> int:
    import torch

    from youtu_rag_tpu_torch.ops import _build, ivf

    ap = argparse.ArgumentParser()
    ap.add_argument("--tiers", default="bfloat16,int8,int4")
    tiers = {"bfloat16": "ivf_topk_dma", "int8": "ivf_topk_int8_dma", "int4": "ivf_topk_int4_dma"}
    names = [tiers[t] for t in ap.parse_args().tiers.split(",")]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.build("ivf_topk")
    br = 1024
    g = torch.Generator(device="cuda").manual_seed(0)
    lib_trace = None
    n_cta_of = ivf._n_cta
    for label, call, n_valid, fn, args in ivf_calls(g):
        if fn.__name__ not in names:
            continue
        res = {"call": label, "n_valid": n_valid, "cold": held_ms(call, cold=True),
               "warm": held_ms(call)}
        flush = torch.empty(256 << 20, dtype=torch.float32, device="cuda")
        times = []
        for _ in range(20):
            float(flush.sum())  # evicts L2 with clean lines
            torch.cuda._sleep(HOLD_CYCLES)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            call()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        res["cold, read flush"] = statistics.median(times)
        del flush
        empty = (*args[:-2], torch.zeros_like(args[-2]), args[-1])
        res["empty plan, cold"] = held_ms(lambda: fn(*empty, block_rows=br), cold=True)
        for n_cta in (33, 66, 132, 264):
            ivf._n_cta = lambda *a, n_cta=n_cta, **kw: n_cta  # noqa: E731
            res[f"n_cta {n_cta}, cold"] = held_ms(call, cold=True)
        ivf._n_cta = n_cta_of
        if lib_trace is None:
            lib_trace = trace_library()
        own = _build._loaded["ivf_topk"]
        _build._loaded["ivf_topk"] = lib_trace
        try:
            res["trace"] = traced_call(lib_trace, fn, args, br)
        finally:
            _build._loaded["ivf_topk"] = own
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
