"""Database access: the read-only adapters that text2sql runs over
``database_url`` (``sqlite:///…`` through the standard library, MySQL
through a driver imported at connect time). The trajectory store, its
models and migrations are not ported yet."""

from .adapters import DatabaseAdapter, MySQLAdapter, SQLiteAdapter, adapter_from_url, check_readonly

__all__ = ["DatabaseAdapter", "MySQLAdapter", "SQLiteAdapter", "adapter_from_url", "check_readonly"]
