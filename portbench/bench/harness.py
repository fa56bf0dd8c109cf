"""One run of one cell: set-up, warm-up, the measured window, the metrics,
the check, and the result line.

``run`` is device-agnostic so that the tests drive it on the CPU at small
sizes; ``main`` is the command, which runs only on CUDA cards."""

from __future__ import annotations

import asyncio
import gc
import json
import sys
import tempfile
import time
from types import SimpleNamespace

import torch

from . import drive, probe, spec
from .fixture import Fixture

FORBIDDEN = ("jax", "jaxlib", "flax", "youtu_rag_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str,
        t0: float | None = None, control: bool = False) -> dict:
    """One run; returns what the result line is made of (and, with
    ``control``, the control's readings on the same sample under
    ``"control"``)."""
    t0 = time.perf_counter() if t0 is None else t0
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=dev)
    split = {"process_and_cuda_init": time.perf_counter() - t0}
    drv = cell.driver
    tmp = tempfile.mkdtemp(prefix="portbench-")
    build = getattr(drv, "build", None)
    if build is None:
        fx = Fixture(cell.config, cell.traffic, seed, device, tmp).build()
    else:
        fx = build(cell.config, cell.traffic, seed, device, tmp)
    split.update(fx.split)

    rec = probe.Record(lambda i: False)
    rec.traced = trace
    sink = patch = None
    if trace:
        from youtu_rag_tpu_torch.tracing.tracer import get_tracer

        sink = probe.SpanSink(rec)
        get_tracer().add_processor(sink)
        if getattr(fx, "kb", None) is not None:
            patch = probe.install_spies(rec, fx.kb.store.index)
    win = drive.Window(seconds, float(cell.traffic["profile_s"]))
    t_warm = time.perf_counter()
    # the driver warms up, then opens the window; set-up ends there
    raw = asyncio.run(drv.run(fx, win, rec))
    gc.unfreeze()
    split["warmup"] = win.start - t_warm
    if patch is not None:
        patch.restore()
    metrics = drv.metrics(raw, win)
    metrics["setup_s"] = win.start - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    out = {"raw": raw, "split": split, "fx": fx, "rec": rec, "win": win, "peak": peak,
           "e2e": metrics}
    if trace:
        out["layer"] = layer_metrics(cell, fx, rec, raw, win)
    t_check = time.perf_counter()
    nums, ctl = drv.check(cell, fx, rec, raw, seed, control)
    out["checks"] = {k: {"value": v, "limit": cell.limits.get(k)} for k, v in sorted(nums.items())}
    out["control"] = ctl
    out["check_s"] = time.perf_counter() - t_check
    if sink is not None:
        from youtu_rag_tpu_torch.tracing.tracer import get_tracer

        get_tracer().processors.remove(sink)
    return out


def layer_metrics(cell, fx, rec, raw, win) -> dict:
    """The per-layer readings: device ones over the profiled stretch, host
    ones over the requests sent from ``win.host_from`` (``drive``)."""
    trace = {"by_name": {}, "busy_s": 0.0, "window_s": win.profile_s, "idle_gaps": []}
    if win.prof is not None:
        marks = {e.name: e.time_range for e in win.prof.events()
                 if e.name in ("portbench/begin", "portbench/end")}
        if len(marks) == 2:
            trace = probe.read_trace(win.prof, marks["portbench/begin"].start,
                                     marks["portbench/end"].end)
    lo, hi = win.host_from, win.end

    def host(t):
        return lo <= t <= hi

    forwards = []
    for t, b, length, tokens in rec.forwards:
        if host(t):
            n = tokens.double()
            forwards.append((b, length, float(n.sum()), float((n * n).sum())))
    scans, profiled = [], []
    for t, kind, n, row_bytes, block_rows, prof in rec.scans:
        if host(t) or prof:
            rows = n if kind == "brute" else int(n.reshape(-1)[0]) * block_rows
            if host(t):
                scans.append((kind, rows, row_bytes))
            if prof:
                profiled.append((kind, rows, row_bytes))
    m = SimpleNamespace(
        trace=trace, attn=rec.attn, profiled_scans=profiled, window_s=win.host_s,
        config=fx.cfg, forwards=forwards, scans=scans, coalescers=raw.get("coalescers", {}),
        spans={k: [ms for t, ms in v if host(t)] for k, v in rec.spans.items()},
        rerank_s=[s for t, s in rec.rerank_s if host(t)],
        embed_s=sum(max(min(b, hi) - max(a, lo), 0.0) for a, b in rec.embed_calls),
        latencies=[t2 - t for _, t, t2 in raw.get("latencies", []) if t >= lo and t2 <= hi])
    values = {}
    for name, read in cell.readers.items():
        v = read(m)
        if v is not None:
            values[name] = v
    return {"values": values, "trace": trace, "scans": scans, "host_s": win.host_s}


def correct(checks: dict) -> bool:
    return all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())


def result_line(cell, out, trace: bool, device: str) -> dict:
    if trace:
        metrics = {m["name"]: {"value": out["layer"]["values"][m["name"]], "unit": m["unit"]}
                   for m in cell.per_layer if m["name"] in out["layer"]["values"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    if device.startswith("cuda"):
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
               "memory_peak_bytes": int(out["peak"])}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    attempted, failed = cell.driver.counts(out["raw"])
    line = {"correct": correct(out["checks"]), "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dev}
    if trace:
        tr = out["layer"]["trace"]
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        ops = sorted(tr["by_name"].items(), key=lambda kv: -kv[1])[:10]
        line["breakdown"] = {"device_ops": [[n, s] for n, s in ops],
                             "idle_gaps": tr["idle_gaps"][:10]}
    line["setup_split_s"] = out["split"]
    line["checks"] = out["checks"]
    return line


def print_shapes(rec, scans) -> None:
    """The traced window's shapes, to standard error: the forwards by
    (batch, T), the profiled attention calls by shape, the scans by kind
    with their mean rows a call."""
    from collections import Counter

    fw = Counter((b, t) for _, b, t, _ in rec.forwards)
    print(f"forwards (B, T): {dict(sorted(fw.items()))}", file=sys.stderr)
    print(f"attention calls profiled (B, H, T, T_kv, hd, bytes): {dict(Counter(rec.attn))}",
          file=sys.stderr)
    for kind in sorted({k for k, *_ in scans}):
        rows = [r for k, r, *_ in scans if k == kind]
        print(f"scans {kind}: {len(rows)} calls, {sum(rows) / len(rows):.0f} rows a call",
              file=sys.stderr)


def main(argv: list[str], t0: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="one run of one benchmark cell of the port")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        print(f"--seed must be a whole number >= 0, got {args.seed}", file=sys.stderr)
        return 2
    cell = spec.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {', '.join(bad)} (the port's runs load no JAX)",
              file=sys.stderr)
        return 3
    line = result_line(cell, out, bool(args.trace), "cuda")
    if args.trace:
        print_shapes(out["rec"], out["layer"]["scans"])
        by_name = sorted(out["layer"]["trace"]["by_name"].items(), key=lambda kv: -kv[1])
        for name, s in by_name[:30]:
            print(f"kernel {s:.6f} s {name[:160]}", file=sys.stderr)
    else:
        # every end-to-end reading the traffic gives, the cell's or not
        for k, v in out["e2e"].items():
            print(f"e2e {k} {v!r}", file=sys.stderr)
    print(f"check took {out['check_s']:.3f} s", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    sys.stdout.flush()
    return 0
