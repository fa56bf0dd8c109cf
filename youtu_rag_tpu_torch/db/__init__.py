"""Database access: the read-only adapters that text2sql runs over
``database_url`` (``sqlite:///…`` through the standard library, MySQL
through a driver imported at connect time), and the trajectory store:
``DBService`` over sqlite with its record types and migrations."""

from .adapters import DatabaseAdapter, MySQLAdapter, SQLiteAdapter, adapter_from_url, check_readonly
from .models import EvaluationSample, GenerationTraceRecord, ToolTraceRecord, TrajectoryRecord
from .service import DBService

__all__ = [
    "DBService",
    "DatabaseAdapter",
    "EvaluationSample",
    "GenerationTraceRecord",
    "MySQLAdapter",
    "SQLiteAdapter",
    "ToolTraceRecord",
    "TrajectoryRecord",
    "adapter_from_url",
    "check_readonly",
]
