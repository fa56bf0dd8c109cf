"""DBService: sqlite persistence with graceful degradation. A copy of
``youtu_rag_tpu/db/service.py``.

Parity with ``utu/db/db_service.py:13-124``: ``add``/``select`` over record
types, and the ``@require_db(safe)`` behavior — when no DB is configured
every operation no-ops instead of raising (db_service.py degradation).
Stdlib sqlite3 (no SQLAlchemy dependency); one connection guarded
by a lock (check_same_thread=False mirrors api/database.py:33)."""

from __future__ import annotations

import dataclasses
import json
import os
import sqlite3
import threading
from pathlib import Path
from typing import Any, Type, TypeVar

from ..utils.log import get_logger
from .migrations import column_type, migrate_table
from .models import (
    EvaluationSample,
    GenerationTraceRecord,
    ToolTraceRecord,
    TrajectoryRecord,
    to_json_row,
)

logger = get_logger("db.service")

T = TypeVar("T")

_TABLES: dict[type, str] = {
    TrajectoryRecord: "trajectories",
    ToolTraceRecord: "tool_traces",
    GenerationTraceRecord: "generation_traces",
    EvaluationSample: "evaluation_samples",
}

_JSON_FIELDS = {"trajectory", "tool_calls", "input_messages"}


class DBService:
    """sqlite-backed record store. ``url=None`` → safe no-op mode."""

    def __init__(self, url: str | None = None):
        url = url if url is not None else os.environ.get("YRT_DB_URL") or os.environ.get("UTU_DB_URL")
        self._conn: sqlite3.Connection | None = None
        self._lock = threading.Lock()
        if not url:
            logger.info("no DB url configured; DBService runs in no-op mode")
            return
        path = url.removeprefix("sqlite:///") if url.startswith("sqlite") else url
        if path != ":memory:":
            Path(path).parent.mkdir(parents=True, exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._init_tables()

    @property
    def available(self) -> bool:
        return self._conn is not None

    def _init_tables(self) -> None:
        with self._lock:
            for cls, table in _TABLES.items():
                cols = [
                    f'"{f.name}" {column_type(f)}' for f in dataclasses.fields(cls)
                ]
                self._conn.execute(
                    f"CREATE TABLE IF NOT EXISTS {table} (_rowid INTEGER PRIMARY KEY AUTOINCREMENT, {', '.join(cols)})"
                )
                # DB files written by an older build: add columns the record
                # type has grown since (ref: utu/rag/api/migrations/*)
                migrate_table(self._conn, table, cls)
            self._conn.commit()

    # -- API (safe in no-op mode) ------------------------------------------

    def add(self, record: Any) -> bool:
        if self._conn is None:
            return False
        table = _TABLES.get(type(record))
        if table is None:
            raise TypeError(f"unknown record type {type(record)}")
        row = to_json_row(record)
        keys = ", ".join(f'"{k}"' for k in row)
        ph = ", ".join("?" for _ in row)
        with self._lock:
            self._conn.execute(
                f"INSERT INTO {table} ({keys}) VALUES ({ph})",
                [_encode(v) for v in row.values()],
            )
            self._conn.commit()
        return True

    def select(
        self,
        cls: Type[T],
        where: dict[str, Any] | None = None,
        limit: int = 100,
        order_by: str = "_rowid DESC",
    ) -> list[T]:
        if self._conn is None:
            return []
        table = _TABLES[cls]
        sql = f"SELECT * FROM {table}"
        params: list[Any] = []
        if where:
            sql += " WHERE " + " AND ".join(f'"{k}" = ?' for k in where)
            params = list(where.values())
        sql += f" ORDER BY {order_by} LIMIT {int(limit)}"
        with self._lock:
            rows = self._conn.execute(sql, params).fetchall()
        out: list[T] = []
        field_names = {f.name for f in dataclasses.fields(cls)}
        for r in rows:
            data = {k: r[k] for k in r.keys() if k in field_names}
            for k in list(data):
                if k in _JSON_FIELDS and isinstance(data[k], str):
                    try:
                        data[k] = json.loads(data[k])
                    except json.JSONDecodeError:
                        pass
            if "correct" in data and data["correct"] is not None:
                data["correct"] = bool(data["correct"])
            out.append(cls(**data))
        return out

    def count(self, cls: type, where: dict[str, Any] | None = None) -> int:
        if self._conn is None:
            return 0
        table = _TABLES[cls]
        sql = f"SELECT COUNT(*) FROM {table}"
        params: list[Any] = []
        if where:
            sql += " WHERE " + " AND ".join(f'"{k}" = ?' for k in where)
            params = list(where.values())
        with self._lock:
            return self._conn.execute(sql, params).fetchone()[0]

    def update(self, cls: type, where: dict[str, Any], values: dict[str, Any]) -> int:
        if self._conn is None:
            return 0
        table = _TABLES[cls]
        set_sql = ", ".join(f'"{k}" = ?' for k in values)
        where_sql = " AND ".join(f'"{k}" = ?' for k in where)
        with self._lock:
            cur = self._conn.execute(
                f"UPDATE {table} SET {set_sql} WHERE {where_sql}",
                [_encode(v) for v in values.values()] + list(where.values()),
            )
            self._conn.commit()
            return cur.rowcount

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None


def _encode(v: Any) -> Any:
    if isinstance(v, (list, dict)):
        return json.dumps(v, ensure_ascii=False)
    if isinstance(v, bool):
        return int(v)
    return v
