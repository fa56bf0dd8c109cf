"""Logging setup (ref behavior: utu/utils/log.py — colored per-module loggers,
installed once at package import in the reference; here it is opt-in)."""

from __future__ import annotations

import logging
import os
import sys

_CONFIGURED = False

_COLORS = {
    "DEBUG": "\033[36m",
    "INFO": "\033[32m",
    "WARNING": "\033[33m",
    "ERROR": "\033[31m",
    "CRITICAL": "\033[35m",
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        base = super().format(record)
        if sys.stderr.isatty():
            color = _COLORS.get(record.levelname, "")
            return f"{color}{base}{_RESET}"
        return base


def setup_logging(level: str | None = None) -> None:
    global _CONFIGURED
    if _CONFIGURED:
        return
    # upper(): logging rejects lowercase names, and this runs at import
    # time in every entry point — YRT_LOG_LEVEL=debug must not crash
    level = (level or os.environ.get("YRT_LOG_LEVEL", "INFO")).upper()
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        _ColorFormatter("%(asctime)s | %(levelname)-7s | %(name)s | %(message)s", "%H:%M:%S")
    )
    root = logging.getLogger("youtu_rag_tpu_torch")
    root.setLevel(level)
    root.addHandler(handler)
    root.propagate = False
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    setup_logging()
    if not name.startswith("youtu_rag_tpu_torch"):
        name = f"youtu_rag_tpu_torch.{name}"
    return logging.getLogger(name)
