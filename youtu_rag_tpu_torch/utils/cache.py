"""Disk-backed async result cache: a copy of ``youtu_rag_tpu/utils/cache.py``.

Parity with the reference's ``async_file_cache`` decorator + ToolCacheModel
(``utu/utils``, ``utu/db``): expensive tool/LLM calls memoize to disk keyed
by function name + arguments, with TTL expiry. Used to wrap remote-service
tools so repeated agent runs stay cheap and repeatable."""

from __future__ import annotations

import asyncio
import functools
import hashlib
import json
import os
import time
from pathlib import Path
from typing import Any, Callable

from .log import get_logger

logger = get_logger("utils.cache")


def _default_cache_dir() -> Path:
    return Path(
        os.environ.get(
            "YRT_CACHE_DIR",
            os.path.join(os.path.expanduser("~"), ".cache", "youtu_rag_tpu_torch", "results"),
        )
    )


def _key(fn_name: str, args: tuple, kwargs: dict) -> str:
    try:
        payload = json.dumps([args, kwargs], sort_keys=True, ensure_ascii=False, default=str)
    except TypeError:
        payload = repr((args, kwargs))
    return hashlib.sha256(f"{fn_name}:{payload}".encode()).hexdigest()[:40]


def async_file_cache(
    ttl_seconds: float | None = None,
    cache_dir: str | Path | None = None,
    enabled: bool = True,
):
    """Decorator: cache an async function's JSON-serializable result.

        @async_file_cache(ttl_seconds=3600)
        async def web_search(self, query): ...

    ``self``-bound methods are supported (the bound instance is excluded
    from the key). Disable globally with YRT_NO_RESULT_CACHE=1."""

    def deco(fn: Callable):
        import inspect

        # exclude the bound instance from the key ONLY when the first
        # parameter is literally named self/cls — hasattr(args[0],
        # '__dict__') dropped the first REAL argument of free functions
        # whose first arg is any ordinary object (silent cross-arg hits)
        params = list(inspect.signature(fn).parameters)
        skip_first = bool(params) and params[0] in ("self", "cls")

        @functools.wraps(fn)
        async def wrapper(*args, **kwargs):
            if not enabled or os.environ.get("YRT_NO_RESULT_CACHE"):
                return await fn(*args, **kwargs)
            key_args = args[1:] if skip_first and args else args
            key = _key(fn.__qualname__, key_args, kwargs)
            d = Path(cache_dir) if cache_dir else _default_cache_dir()
            path = d / f"{key}.json"
            try:
                if path.exists():
                    entry = json.loads(path.read_text())
                    if ttl_seconds is None or time.time() - entry["t"] < ttl_seconds:
                        return entry["v"]
            except (OSError, json.JSONDecodeError, KeyError):
                pass
            result = await fn(*args, **kwargs)
            try:
                d.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(".tmp")
                tmp.write_text(json.dumps({"t": time.time(), "v": result}, ensure_ascii=False))
                os.replace(tmp, path)
            except (OSError, TypeError):
                logger.debug("result not cacheable for %s", fn.__qualname__)
            return result

        wrapper.cache_clear = lambda: _clear(cache_dir)
        return wrapper

    return deco


def _clear(cache_dir: str | Path | None) -> int:
    d = Path(cache_dir) if cache_dir else _default_cache_dir()
    n = 0
    if d.exists():
        for f in d.glob("*.json"):
            f.unlink()
            n += 1
    return n
