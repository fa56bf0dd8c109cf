"""Agent toolkits: the registry, the toolkit base and the builtin toolkits.

The port's counterpart of ``youtu_rag_tpu/tools/__init__.py``:
``get_toolkit`` imports ``tools/builtin.py``, which registers every
toolkit the JAX package registers (KB search, RAG, meta-retrieval,
text2sql, vector memory, web, files, code execution, MCP, ...). The
toolkits that make a store or a KB read its device from their config's
``device`` key (``None`` → the CUDA card).
"""

from .base import AsyncBaseToolkit, ToolkitConfig, register_tool
from .schema import function_schema

TOOLKIT_MAP: dict[str, type] = {}


def register_toolkit(name: str):
    """Class decorator adding a toolkit to the registry."""

    def deco(cls):
        TOOLKIT_MAP[name] = cls
        return cls

    return deco


def get_toolkit(name: str, config=None):
    # populate the registry lazily (the toolkit modules import this one)
    from . import builtin  # noqa: F401

    if name not in TOOLKIT_MAP:
        raise KeyError(f"unknown toolkit {name!r}; available: {sorted(TOOLKIT_MAP)}")
    return TOOLKIT_MAP[name](config)


__all__ = [
    "AsyncBaseToolkit",
    "TOOLKIT_MAP",
    "ToolkitConfig",
    "function_schema",
    "get_toolkit",
    "register_tool",
    "register_toolkit",
]
