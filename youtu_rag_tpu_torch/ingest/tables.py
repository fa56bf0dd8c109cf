"""Structured-table storage: Excel/CSV/DB tables → SQLite + registry.

A copy of ``youtu_rag_tpu/ingest/tables.py``. ``pandas`` is imported by
the callers that make a DataFrame, never here: a store of text sources
needs only ``sqlite3``.

Parity with the reference's structured path:
- tables land in SQLite with sanitized names (``processors.py:1097``-style
  ``_store_to_sqlite_enhanced``);
- ``ExcelTableManager`` registry of (kb, source, table) rows
  (``excel_table_manager.py:21-312``, ``kb_excel_tables``);
- schema DDL + per-column top values for schema/value linking
  (``utu/tools/text2sql/sqlite_tools.py:14-273``)."""

from __future__ import annotations

import hashlib
import re
import sqlite3
import threading
from pathlib import Path
from typing import TYPE_CHECKING, Any

from ..utils.log import get_logger

if TYPE_CHECKING:
    import pandas as pd

logger = get_logger("ingest.tables")


def sanitize_table_name(name: str) -> str:
    """File/sheet name → sql-safe table name (ref cleanup_manager sanitize)."""
    base = re.sub(r"\.[A-Za-z0-9]+$", "", name)
    base = re.sub(r"[^\w一-鿿]+", "_", base).strip("_")
    if not base or base[0].isdigit():
        base = f"t_{base}"
    if base == "kb_tables":  # never collide with the registry table
        base = "t_kb_tables"
    return base[:64]


class TableStore:
    """SQLite store for structured tables + registry."""

    def __init__(self, path: str | Path = ":memory:"):
        if path != ":memory:":
            Path(path).parent.mkdir(parents=True, exist_ok=True)
        self._conn = sqlite3.connect(str(path), check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._lock = threading.Lock()
        with self._lock:
            self._conn.execute(
                """CREATE TABLE IF NOT EXISTS kb_tables (
                    kb TEXT, source TEXT, table_name TEXT, n_rows INTEGER,
                    n_cols INTEGER, columns TEXT,
                    PRIMARY KEY (kb, table_name)
                )"""
            )
            self._conn.commit()

    # -- registry (ref: ExcelTableManager) ---------------------------------

    def register(self, kb: str, source: str, table_name: str, df: pd.DataFrame) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO kb_tables VALUES (?, ?, ?, ?, ?, ?)",
                (kb, source, table_name, len(df), len(df.columns), ",".join(map(str, df.columns))),
            )
            self._conn.commit()

    def tables_for_kb(self, kb: str) -> list[dict[str, Any]]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT * FROM kb_tables WHERE kb = ?", (kb,)
            ).fetchall()
        return [dict(r) for r in rows]

    def tables_for_source(self, kb: str, source: str) -> list[str]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT table_name FROM kb_tables WHERE kb = ? AND source = ?", (kb, source)
            ).fetchall()
        return [r["table_name"] for r in rows]

    # -- data --------------------------------------------------------------

    def store_dataframe(self, kb: str, source: str, name: str, df: pd.DataFrame) -> str:
        table = sanitize_table_name(name)
        # sanitized names can collide ACROSS sources (a/sales.xlsx vs
        # b/sales.xlsx, or a-b vs a_b); replacing another source's table
        # would silently re-point its registry row and vectors to this
        # source's data — disambiguate with a stable source-hash suffix
        with self._lock:
            row = self._conn.execute(
                "SELECT source FROM kb_tables WHERE kb = ? AND table_name = ?", (kb, table)
            ).fetchone()
        if row is not None and row["source"] != source:
            suffix = hashlib.md5(source.encode()).hexdigest()[:6]
            table = f"{table}_{suffix}"
            logger.warning(
                "table name collision for %r across sources; using %s", name, table
            )
        with self._lock:
            df.to_sql(table, self._conn, if_exists="replace", index=False)
        self.register(kb, source, table, df)
        logger.info("stored table %s (%d rows) for kb=%s", table, len(df), kb)
        return table

    def drop_table(self, kb: str, table: str) -> bool:
        with self._lock:
            # registration check BEFORE the DROP: table names arrive
            # user-controlled from the API — an unregistered name must be a
            # no-op, or ?table=kb_tables would destroy the registry itself
            row = self._conn.execute(
                "SELECT 1 FROM kb_tables WHERE kb = ? AND table_name = ?", (kb, table)
            ).fetchone()
            if row is None:
                return False
            self._conn.execute(f'DROP TABLE IF EXISTS "{table}"')
            self._conn.execute(
                "DELETE FROM kb_tables WHERE kb = ? AND table_name = ?", (kb, table)
            )
            self._conn.commit()
            return True

    def execute_sql(self, sql: str, limit: int = 200) -> dict[str, Any]:
        """Read-only query execution for text2sql (ref: ex_sql).

        Enforcement is an sqlite authorizer, not just the statement-prefix
        regex — CTE-wrapped writes ('WITH x AS (...) DELETE ...'),
        PRAGMA, and ATTACH all pass a prefix check but are denied here."""
        forbidden = re.match(r"\s*(insert|update|delete|drop|alter|create|replace)\b", sql, re.I)
        if forbidden:
            return {"error": "only SELECT statements are allowed"}

        allowed = {sqlite3.SQLITE_SELECT, sqlite3.SQLITE_READ, sqlite3.SQLITE_FUNCTION}
        recursive = getattr(sqlite3, "SQLITE_RECURSIVE", None)
        if recursive is not None:
            allowed.add(recursive)

        def authorizer(action, *_args):
            return sqlite3.SQLITE_OK if action in allowed else sqlite3.SQLITE_DENY

        try:
            with self._lock:
                self._conn.set_authorizer(authorizer)
                try:
                    cur = self._conn.execute(sql)
                    rows = cur.fetchmany(limit)
                    columns = [d[0] for d in cur.description] if cur.description else []
                finally:
                    self._conn.set_authorizer(None)
            return {"columns": columns, "rows": [list(r) for r in rows], "row_count": len(rows)}
        except sqlite3.Error as e:
            return {"error": str(e)}

    def get_schema(self, table: str) -> str:
        """CREATE TABLE DDL (ref: get_creat_table_details)."""
        with self._lock:
            row = self._conn.execute(
                "SELECT sql FROM sqlite_master WHERE type='table' AND name=?", (table,)
            ).fetchone()
        return row["sql"] if row else ""

    def column_top_values(self, table: str, column: str, n: int = 10) -> list[tuple[Any, int]]:
        """Most frequent values of a column (ref: get_column_top_value)."""
        with self._lock:
            rows = self._conn.execute(
                f'SELECT "{column}" AS v, COUNT(*) AS c FROM "{table}" '
                f'GROUP BY "{column}" ORDER BY c DESC LIMIT ?',
                (n,),
            ).fetchall()
        return [(r["v"], r["c"]) for r in rows]

    def sample_rows(self, table: str, n: int = 3) -> list[dict[str, Any]]:
        with self._lock:
            rows = self._conn.execute(f'SELECT * FROM "{table}" LIMIT ?', (n,)).fetchall()
        return [dict(r) for r in rows]

    def close(self) -> None:
        self._conn.close()
