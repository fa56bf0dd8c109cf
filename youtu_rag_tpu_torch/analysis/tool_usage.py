"""Tool-usage statistics over recorded runs: the port's copy of
``scripts/analysis/tool_usage.py``. Its sources are the rows the port's
agents write: ``TrajectoryRecord`` (the run's messages and a summary of its
tool calls) and ``ToolTraceRecord`` spans (durations). Host-only.

    python -m youtu_rag_tpu_torch.analysis.tool_usage --db /tmp/yrt/yrt.db [--json]

Without ``--db`` it reads ``YRT_DB_URL``.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict

from ..db.models import ToolTraceRecord, TrajectoryRecord
from ..db.service import DBService


def stat_runs(runs: list[TrajectoryRecord]) -> dict:
    per_tool: dict[str, int] = defaultdict(int)
    turns_total = 0
    calls_total = 0
    errors = 0
    for r in runs:
        turns_total += len(r.trajectory or [])
        for call in r.tool_calls or []:
            per_tool[call.get("name", "?")] += 1
            calls_total += 1
        if r.error:
            errors += 1
    n = max(len(runs), 1)
    return {
        "runs": len(runs),
        "errored_runs": errors,
        "avg_turns": round(turns_total / n, 2),
        "tool_calls_total": calls_total,
        "avg_tool_calls": round(calls_total / n, 2),
        "calls_per_tool": dict(sorted(per_tool.items(), key=lambda kv: -kv[1])),
    }


def stat_spans(spans: list[ToolTraceRecord]) -> dict:
    agg: dict[str, list[float]] = defaultdict(list)
    for s in spans:
        agg[s.name].append(s.duration_ms)
    return {
        name: {
            "calls": len(ds),
            "avg_ms": round(sum(ds) / len(ds), 2),
            "max_ms": round(max(ds), 2),
        }
        for name, ds in sorted(agg.items(), key=lambda kv: -len(kv[1]))
    }


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--db", default=None, help="sqlite path/url (default: YRT_DB_URL)")
    p.add_argument("--limit", type=int, default=1000)
    p.add_argument("--json", action="store_true", help="print one JSON object")
    args = p.parse_args(argv)

    db = DBService(args.db)
    if not db.available:
        sys.exit("no trajectory DB (pass --db or set YRT_DB_URL)")
    runs = db.select(TrajectoryRecord, limit=args.limit)
    spans = db.select(ToolTraceRecord, limit=args.limit * 10)
    report = {"trajectories": stat_runs(runs), "tool_latency": stat_spans(spans)}
    if args.json:
        print(json.dumps(report, ensure_ascii=False))
        return
    t = report["trajectories"]
    print(f"runs: {t['runs']} ({t['errored_runs']} errored), avg turns {t['avg_turns']}")
    print(f"tool calls: {t['tool_calls_total']} total, {t['avg_tool_calls']}/run")
    for name, cnt in t["calls_per_tool"].items():
        lat = report["tool_latency"].get(name, {})
        extra = f"  avg {lat['avg_ms']} ms, max {lat['max_ms']} ms" if lat else ""
        print(f"  {name:30s} {cnt:6d}{extra}")


if __name__ == "__main__":
    main()
