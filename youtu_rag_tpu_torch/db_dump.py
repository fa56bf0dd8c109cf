"""Dump or clear the trajectory and trace database: the port's copy of
``scripts/db_dump.py``. Host-only: it reads the sqlite file that
``db.service.DBService`` writes and imports no torch.

    python -m youtu_rag_tpu_torch.db_dump --db sqlite:///data/yrt.db [--table trajectories]
    python -m youtu_rag_tpu_torch.db_dump --db sqlite:///data/yrt.db --clear evaluation_samples
"""

from __future__ import annotations

import argparse
import json
import sys

from .db.models import EvaluationSample, GenerationTraceRecord, ToolTraceRecord, TrajectoryRecord
from .db.service import DBService

TABLES = {
    "trajectories": TrajectoryRecord,
    "tool_traces": ToolTraceRecord,
    "generation_traces": GenerationTraceRecord,
    "evaluation_samples": EvaluationSample,
}


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--db", required=True)
    p.add_argument("--table", default=None, choices=[*TABLES, None])
    p.add_argument("--limit", type=int, default=50)
    p.add_argument("--clear", default=None, choices=list(TABLES))
    args = p.parse_args(argv)

    db = DBService(url=args.db)
    if not db.available:
        print("database not available", file=sys.stderr)
        sys.exit(1)

    if args.clear:
        # DBService has no delete; the table name is one of TABLES (argparse's choices)
        with db._lock:
            cur = db._conn.execute(f"DELETE FROM {args.clear}")
            db._conn.commit()
        print(f"cleared {cur.rowcount} rows from {args.clear}")
        return

    for name, cls in TABLES.items():
        if args.table and name != args.table:
            continue
        rows = db.select(cls, limit=args.limit)
        print(f"== {name} ({db.count(cls)} total, showing {len(rows)}) ==")
        for r in rows:
            print(json.dumps(r.__dict__, ensure_ascii=False, default=str)[:500])


if __name__ == "__main__":
    main()
