"""Where the brute scans' time goes, on one card: the ring of
``csrc/ivf_scan_tma.cuh`` over the identity plan, as it stands and with one
part taken out at a time, beside each checkout's own brute wrapper and one
PyTorch call, at the shapes the main path gives the brute scans.

    python -m youtu_rag_tpu_torch.bench.ring_variants [--tier T ...] [--shape S ...]
        [--variants all|none] [TREE ...]

Each TREE is a directory that holds a checkout of the repo (default: this
one); each runs in a process of its own, in the order given. For a tree and
a tier (``bf16``, ``int8``, ``int4``), the script copies its
``csrc/ivf_scan_tma.cuh`` (and the headers it includes) into a temporary
directory, changes one thing in each copy by a textual patch, and builds
each copy with one entry, ``IVF_TMA_C_INTERFACE(..., ivf_tma::<tier>,
false, true)``: the tier's DMA kernels over the identity plan (one block of
all n rows, the pruned fill ``(NEG_INF, 0)``). The copies are measurements,
not kernels of the port, and give wrong results where they take work out:

- ``as it stands``;
- ``no query prep``: the prologue issues the first stages at once and
  leaves the query tile unprepared (``T::prepare`` skipped);
- ``no selection``: the rows are scored and no list takes them;
- ``no merge``: the last CTA returns before it merges the CTAs' lists;
- ``no rows``: the plan holds no row (launch, prologue, the lists written,
  the tickets and the merge of empty lists: the fixed cost);
- ``no rows, no merge``: the same without the merge;
- int4 also ``unpack skipped`` (the packed words to the tensor cores as they
  are) and ``int8 load`` (the packed bytes as int8 rows of d/2).

The shapes (``--shape``; rows x width, queries, k; the bias all zeros but
in (b)):

- ``a``: 1,048,576 x 768, q 8, k 10, 64, 256, 1024 (``chip_smoke.py`` phase
  5's index; bf16, int8, int4);
- ``b``: 262,144 x 256, q 1, k 15, the bias NEG_INF but for 52 rows of one
  user's 256 (phase 4g's memory index and user filter; ``search_memories``
  asks for ``top_k * 3``; bf16);
- ``c``: 262,144 x 768, q 8, k 10 (one of phase 5f's four shards; bf16,
  int8);
- ``d``: 2,048 x 512, q 1, k 10 (phase 4k's MCP knowledge base: 2,048
  one-chunk documents at the hash embedder's width; bf16);
- ``e``: (a)'s index at q 64, k 10 (one launch, eight 8-query tiles, each
  of which reads the index; bf16, int8, int4).

At each (tier, shape, k): every copy (at (a) the copies at k 10 and 64, the
unchanged one at every k) on the grid the tree's wrappers would size, the
unchanged copy at other grid sizes (CTAs per 8-query tile: 264, 132, 64,
32, 16, 8 where each CTA has a 32-row stage) at (b)-(d), the tree's own
wrapper (``topk_pruned``, ``topk_int8_pruned``, ``topk_int4_pruned``: its
design, whatever the tree holds), and one PyTorch call that computes the
same function (``chip_smoke.py``'s ``library_call``; none for int4). The unchanged copy must answer as the
plain version on the live slots (bf16 within 1e-4 up to near-ties; int8 and
int4 bit-equal). One timer: one call held behind a spin of the card, the
median of 20 (the device time, ``chip_smoke.py``'s ``time_held_ms``), with
the 50 MB L2 evicted before each call where the index's bytes exceed it
(shapes a-c and e; (d)'s 1 MB stays warm). Prints the card's name and power
limit, a table per tree and one JSON line per tree.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

HOLD_CYCLES = 4_000_000  # chip_smoke.py's spin: longer than the host takes to enqueue a call
L2_BYTES = 50 << 20
TIER_TYPES = {"bf16": "Bf16", "int8": "Int8", "int4": "Int4"}
WRAPPERS = {"bf16": "topk_pruned", "int8": "topk_int8_pruned", "int4": "topk_int4_pruned"}
# shape: (rows, width, queries, ks, tiers, a user filter in the bias)
SHAPES = {
    "a": (1 << 20, 768, 8, (10, 64, 256, 1024), ("bf16", "int8", "int4"), False),
    "b": (1 << 18, 256, 1, (15,), ("bf16",), True),
    "c": (1 << 18, 768, 8, (10,), ("bf16", "int8"), False),
    "d": (2048, 512, 1, (10,), ("bf16",), False),
    "e": (1 << 20, 768, 64, (10,), ("bf16", "int8", "int4"), False),
}
VARIANT_KS = (10, 64)  # shape (a): the copies that take a part out, at these k
GRIDS = (264, 132, 64, 32, 16, 8)  # (b)-(d): the unchanged copy at these CTAs per query tile
FILTER_USER, FILTER_ROWS = 513, 256  # (b): the live rows lie in this user's 256
ENTRY = r'''
#include "ivf_scan_tma.cuh"
IVF_TMA_C_INTERFACE(variant, ivf_tma::TIER, false, true)
extern "C" const char* variant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
'''


def patch(text: str, variant: str) -> str:
    """``ivf_scan_tma.cuh`` with one change (module docstring)."""
    if variant == "as it stands":
        return text
    if variant == "no query prep":
        old = "T::prepare(qt, qscale, a.queries, a.queries_bf16 != 0, q0, q_valid, d, first_fill);"
        return text.replace(old, "first_fill();", 1)
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
    if variant == "no rows":
        return text.replace("const int total = nv * br;", "const int total = 0 * nv * br;", 1)
    if variant == "no rows, no merge":
        return patch(patch(text, "no rows"), "no merge")
    if variant == "unpack skipped":
        old = ("const uint32_t a[4] = {ua & 0x0f0f0f0fu, ub & 0x0f0f0f0fu, (ua >> 4) & 0x0f0f0f0fu,\n"
               "                           (ub >> 4) & 0x0f0f0f0fu};")
        return text.replace(old, "const uint32_t a[4] = {wa, wb, wa, wb}; (void)ua; (void)ub;", 1)
    if variant == "int8 load":
        anchor = '    static_assert(!kWide, "int4 has no wide plan");\n'
        i = text.index(anchor, text.index("struct Int4")) + len(anchor)
        return (text[:i] + "    quarter_dots<int, mma_s8>(qt, d + kQPad, rows, d / 2, d / 32, "
                "quarter, lane, acc);\n    return;\n" + text[i:])
    raise ValueError(variant)


VARIANTS = ("as it stands", "no query prep", "no selection", "no merge", "no rows",
            "no rows, no merge")
INT4_VARIANTS = ("unpack skipped", "int8 load")


def build(csrc: Path, out: Path, tier: str, variant: str) -> Path:
    """One variant's library, built from a patched copy of ``csrc``."""
    from youtu_rag_tpu_torch.ops import _build

    src = out / f"{tier}_{variant.replace(' ', '_').replace(',', '')}"
    src.mkdir(parents=True)
    for f in ("topk_scorers.cuh", "topk_select.cuh"):
        (src / f).write_text((csrc / f).read_text())
    text = (csrc / "ivf_scan_tma.cuh").read_text()
    patched = patch(text, variant)
    if variant != "as it stands" and patched == text:
        raise RuntimeError(f"{variant}: the patch found nothing to change")
    (src / "ivf_scan_tma.cuh").write_text(patched)
    (src / "variant.cu").write_text(ENTRY.replace("TIER", TIER_TYPES[tier]))
    lib = src / "variant.so"
    done = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(src / "variant.cu")], capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed for {tier} {variant}:\n{done.stdout}{done.stderr}")
    return lib


def held_ms(fn, calls: int = 20, warmup: int = 3, cold: bool = False) -> float:
    """One call's device time behind a spin of the card, the median of
    ``calls``; ``cold`` first evicts the 50 MB L2 with a 1 GiB write."""
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


def default_grid(lib, d: int, k: int, rows: int, qn: int) -> int:
    """CTAs per 8-query tile as the tree's wrappers size an identity-plan
    launch: one wave (two an SM at most) split over the tiles, at least the
    tree's rows per CTA each (512 where it names none), fewer where lists
    above k = 1024 would outgrow the candidate buffer."""
    import importlib

    import torch

    # by its path: youtu_rag_tpu_torch.ops.topk is also the name of a function
    T = importlib.import_module("youtu_rag_tpu_torch.ops.topk")
    tiles = -(-qn // 8)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm = min(lib.variant_ctas_per_sm(d, k), 2)
    least = getattr(T, "_IDENTITY_ROWS_PER_CTA", 512)
    return T._list_ctas(max(1, min(per_sm * sms // tiles, -(-rows // least))), 8 * tiles, k)


def variant_call(lib, q, x, xs, bias, k: int, d: int, n_cta: int):
    """One launch of a variant's entry over the identity plan (one block of
    all n rows) on ``n_cta`` CTAs per query tile."""
    import torch

    n, qn, dev = x.shape[0], q.shape[0], x.device
    tiles = -(-qn // 8)
    cand = (tiles, n_cta, 8, -(-k // 4) * 4)
    cand_s = torch.empty(cand, dtype=torch.float32, device=dev)
    cand_i = torch.empty(cand, dtype=torch.int32, device=dev)
    counter = torch.empty(18 * tiles, dtype=torch.int32, device=dev)
    out_s = torch.empty((qn, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, k), dtype=torch.int32, device=dev)
    err = lib.variant_launch(q.data_ptr(), 0, x.data_ptr(), None if xs is None else xs.data_ptr(),
                             bias.data_ptr(), None, None, cand_s.data_ptr(), cand_i.data_ptr(),
                             counter.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), qn, n, d, k,
                             1, n, n_cta, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"variant launch failed: CUDA error {err} "
                           f"({lib.variant_error_string(err).decode()})")
    return out_s, out_i


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.variant_launch.argtypes = [p, i] + [p] * 10 + [i] * 7 + [p]
    lib.variant_launch.restype = i
    lib.variant_ctas_per_sm.argtypes = [i, i]
    lib.variant_ctas_per_sm.restype = i
    lib.variant_error_string.argtypes = [i]
    lib.variant_error_string.restype = ctypes.c_char_p
    return lib


def shape_data(shape: str, seed: int = 0) -> dict:
    """Seeded unit rows and queries on the card for ``shape``, every tier's
    stored form, and its bias."""
    import torch

    from youtu_rag_tpu_torch.ops.topk import NEG_INF, quantize_rows_int4, quantize_rows_int8

    rows, d, qn, _, tiers, filtered = SHAPES[shape]
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(rows, d, generator=g, device="cuda")
    x /= x.norm(dim=1, keepdim=True)
    q = torch.randn(qn, d, generator=g, device="cuda")
    q /= q.norm(dim=1, keepdim=True)
    bias = torch.zeros(rows, device="cuda")
    if filtered:  # one user's rows, one in five of them live
        bias.fill_(NEG_INF)
        bias[FILTER_USER * FILTER_ROWS : (FILTER_USER + 1) * FILTER_ROWS : 5] = 0.0
    out = {"q": q, "bias": bias}
    if "bf16" in tiers:
        out["bf16"] = (x.to(torch.bfloat16), None)
    if "int8" in tiers:
        out["int8"] = quantize_rows_int8(x)
    if "int4" in tiers:
        out["int4"] = quantize_rows_int4(x)
    return out


def check_live(tier: str, got, want, what: str) -> None:
    """The copy's live slots against the plain version's: bf16 scores
    within 1e-4 and rows equal but where a near-tie may swap them; int8 and
    int4 bit-equal."""
    import torch

    from youtu_rag_tpu_torch.ops.topk import NEG_INF

    gs, gi = (t.cpu() for t in got)
    ws, wi = (t.cpu() for t in want)
    live = ws > NEG_INF / 2
    if not torch.equal(live, gs > NEG_INF / 2):
        raise RuntimeError(f"{what}: live slots differ")
    if tier != "bf16":
        if not (torch.equal(gs[live], ws[live]) and torch.equal(gi[live], wi[live])):
            raise RuntimeError(f"{what}: not bit-equal to the plain version")
        return
    err = float((gs[live] - ws[live]).abs().max()) if bool(live.any()) else 0.0
    tied = (ws[:, 1:] - ws[:, :-1]).abs() < 2e-4
    near = torch.zeros_like(live)
    near[:, 1:] |= tied
    near[:, :-1] |= tied
    if err > 1e-4 or not torch.equal(gi[live & ~near], wi[live & ~near]):
        raise RuntimeError(f"{what}: max score difference {err}, or rows differ")


def measure(tree: str, tiers: list[str], shapes: list[str], variants: bool) -> dict:
    """The timings of ``tree``'s variants and wrappers (in the child process)."""
    import importlib

    import torch

    import youtu_rag_tpu_torch

    sys.path.insert(0, str(Path(youtu_rag_tpu_torch.__file__).resolve().parents[1]))
    smoke = importlib.import_module("chip_smoke")
    T = importlib.import_module("youtu_rag_tpu_torch.ops.topk")

    csrc = Path(youtu_rag_tpu_torch.__file__).parent / "csrc"
    out = {"tree": tree, "package": str(csrc.parent)}
    wanted = [(t, s) for s in shapes for t in tiers if t in SHAPES[s][4]]
    names = {t: (VARIANTS + (INT4_VARIANTS if t == "int4" else ())) if variants
             else ("as it stands",) for t, _ in wanted}
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        jobs = {(t, v): pool.submit(build, csrc, Path(tmp), t, v)
                for t in dict.fromkeys(t for t, _ in wanted) for v in names[t]}
        libs = {key: load(job.result()) for key, job in jobs.items()}
    for shape in shapes:
        rows, d, qn, ks, _, _ = SHAPES[shape]
        todo = [t for t in tiers if t in SHAPES[shape][4]]
        if not todo:
            continue
        data = shape_data(shape)
        q, bias = data["q"], data["bias"]
        for tier in todo:
            x, xs = data[tier]
            width = 2 * x.shape[1] if tier == "int4" else x.shape[1]
            cold = x.numel() * x.element_size() > L2_BYTES
            plain = getattr(T, WRAPPERS[tier] + "_reference")
            wrapper = getattr(T, WRAPPERS[tier])
            extra = () if xs is None else (xs,)
            lib_tier = {"bf16": "bfloat16"}.get(tier, tier)
            for k in ks:
                key = f"{tier} {shape} k={k}"
                as_is = libs[(tier, "as it stands")]
                grid = default_grid(as_is, width, k, rows, qn)
                want = plain(q, x, *extra, bias, k)
                check_live(tier, variant_call(as_is, q, x, xs, bias, k, width, grid), want,
                           f"{key}: the unchanged copy")
                check_live(tier, wrapper(q, x, *extra, bias, k), want, f"{key}: the wrapper")
                res = {"grid": grid, "cold": cold}
                for v in names[tier]:
                    if v != "as it stands" and shape == "a" and k not in VARIANT_KS:
                        continue
                    lib = libs[(tier, v)]
                    res[v] = held_ms(lambda lib=lib: variant_call(lib, q, x, xs, bias, k, width,
                                                                  grid), cold=cold)
                if shape in ("b", "c", "d"):
                    for n_cta in GRIDS:
                        if n_cta != grid and n_cta <= -(-rows // 32):
                            res[f"grid {n_cta}"] = held_ms(
                                lambda n_cta=n_cta: variant_call(as_is, q, x, xs, bias, k, width,
                                                                 n_cta), cold=cold)
                res["wrapper"] = held_ms(lambda: wrapper(q, x, *extra, bias, k), cold=cold)
                desc, call = smoke.library_call(lib_tier, q, x, *(extra or (None,)), bias, k)
                res["library"] = None if call is None else held_ms(call, cold=cold)
                res["library_call"] = desc
                res["bound_ms"] = smoke.bound(lib_tier, "sxm", rows, width, qn, k)[0]
                out[key] = res
                print(f"  {key}: " + "; ".join(
                    f"{n} {v:.4f}" if isinstance(v, float) else f"{n} {v}"
                    for n, v in res.items() if n != "library_call"), flush=True)
        del data, q, bias, x, xs
        torch.cuda.empty_cache()
    return out


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tier", action="append", choices=list(TIER_TYPES))
    ap.add_argument("--shape", action="append", choices=list(SHAPES))
    ap.add_argument("--variants", choices=("all", "none"), default="all")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("trees", nargs="*")
    args = ap.parse_args(argv)
    tiers, shapes = args.tier or list(TIER_TYPES), args.shape or list(SHAPES)
    if args.child:
        res = measure(args.child, tiers, shapes, args.variants == "all")
        print(json.dumps(res), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    flags = [f"--tier={t}" for t in tiers] + [f"--shape={s}" for s in shapes]
    for tree in args.trees or [str(Path(__file__).resolve().parents[2])]:
        tree = os.path.abspath(tree)
        print(f"tree {tree}", flush=True)
        env = dict(os.environ, PYTHONPATH=tree)
        # this file, run by its path, imports the tree's package
        done = subprocess.run([sys.executable, os.path.abspath(__file__), *flags,
                               f"--variants={args.variants}", f"--child={tree}"],
                              env=env, cwd=tree, check=False)
        if done.returncode:
            return done.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
