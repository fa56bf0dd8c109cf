"""Search the tool and generation spans persisted in the trajectory
database, one JSON object a line: the port's copy of
``scripts/trace_search.py``. Host-only, like ``db_dump``.

    python -m youtu_rag_tpu_torch.trace_search --db sqlite:///data/yrt.db --name kb_embedding_search
    python -m youtu_rag_tpu_torch.trace_search --db sqlite:///data/yrt.db --trace-id tr-abc123

``--name`` filters the tool spans only; ``--trace-id`` filters both kinds.
"""

from __future__ import annotations

import argparse
import json
import sys

from .db.models import GenerationTraceRecord, ToolTraceRecord
from .db.service import DBService


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--db", required=True)
    p.add_argument("--name", default=None, help="tool name filter")
    p.add_argument("--trace-id", default=None)
    p.add_argument("--kind", default="all", choices=["all", "tool", "generation"])
    p.add_argument("--limit", type=int, default=30)
    args = p.parse_args(argv)

    db = DBService(url=args.db)
    if not db.available:
        print("database not available", file=sys.stderr)
        sys.exit(1)

    where: dict = {}
    if args.name:
        where["name"] = args.name
    if args.trace_id:
        where["trace_id"] = args.trace_id

    if args.kind in ("all", "tool"):
        for r in db.select(ToolTraceRecord, where=where or None, limit=args.limit):
            print(json.dumps({
                "kind": "tool",
                "trace_id": r.trace_id,
                "name": r.name,
                "duration_ms": round(r.duration_ms, 1),
                "arguments": r.arguments[:120],
                "output": r.output[:120],
            }, ensure_ascii=False))
    if args.kind in ("all", "generation"):
        gen_where = {k: v for k, v in where.items() if k != "name"}
        for r in db.select(GenerationTraceRecord, where=gen_where or None, limit=args.limit):
            print(json.dumps({
                "kind": "generation",
                "trace_id": r.trace_id,
                "model": r.model,
                "duration_ms": round(r.duration_ms, 1),
                "tokens": [r.input_tokens, r.output_tokens],
                "output": (r.output or "")[:120],
            }, ensure_ascii=False))


if __name__ == "__main__":
    main()
