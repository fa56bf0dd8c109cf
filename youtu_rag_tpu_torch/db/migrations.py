"""Schema reconciliation for sqlite record tables: a copy of
``youtu_rag_tpu/db/migrations.py``.

Parity surface: ``utu/rag/api/migrations/*.py`` — the reference ships ad-hoc
scripts that ALTER TABLE ADD COLUMN when the model grows (source_etag,
metadata_hash, derived_files_hash, unique constraints). Here the same thing
is automatic: on open, each record table's live columns (PRAGMA table_info)
are diffed against the dataclass fields and missing columns are added, so a
DB file written by an older build keeps working after upgrade. Columns that
exist in the file but not in the dataclass are left alone (sqlite can't drop
them cheaply and ``select`` ignores unknown columns)."""

from __future__ import annotations

import dataclasses
import sqlite3

from ..utils.log import get_logger

logger = get_logger("db.migrations")


def column_type(field: dataclasses.Field) -> str:
    """Map a dataclass field annotation to a sqlite column type."""
    if field.type in ("int", int, "int | None"):
        return "INTEGER"
    if field.type in ("float", float, "float | None"):
        return "REAL"
    if field.type in ("bool | None", "bool", bool):
        return "INTEGER"
    return "TEXT"


def existing_columns(conn: sqlite3.Connection, table: str) -> set[str]:
    return {row[1] for row in conn.execute(f"PRAGMA table_info({table})")}


def migrate_table(conn: sqlite3.Connection, table: str, cls: type) -> list[str]:
    """Add any dataclass fields missing from ``table``. Returns added names.

    The table must already exist. New columns get NULL for old rows, which
    the record constructors treat as "absent" (same semantics the reference
    migrations rely on: old rows simply have no etag/hash yet and are
    rebuilt on the next pass)."""
    have = existing_columns(conn, table)
    added: list[str] = []
    for f in dataclasses.fields(cls):
        if f.name in have:
            continue
        conn.execute(f'ALTER TABLE {table} ADD COLUMN "{f.name}" {column_type(f)}')
        added.append(f.name)
    if added:
        logger.info("migrated %s: added columns %s", table, added)
        conn.commit()
    return added
