"""Agent toolkits: the registry, the toolkit base and the KB-search tools.

The port's counterpart of ``youtu_rag_tpu/tools/__init__.py``. The port
has the ``kb_search`` toolkit (``tools/kb_search.py``); the names the JAX
package registers in ``tools/builtin.py`` and its siblings (web, files,
code execution, memory, text2sql, MCP, ...) raise ``NotImplementedError``
until ROADMAP Queue A 6 ports them.
"""

from .base import AsyncBaseToolkit, ToolkitConfig, register_tool
from .schema import function_schema

TOOLKIT_MAP: dict[str, type] = {}

# the JAX package's other toolkits (tools/builtin.py and the modules it imports)
NOT_PORTED = (
    "arxiv", "audio", "bash", "codesnip", "document", "file", "file_edit", "github", "html",
    "image", "mcp", "memory", "memory_simple", "meta_retrieval", "python_executor", "rag",
    "search", "tabular", "text2sql", "user_interaction", "video", "wikipedia",
)


def register_toolkit(name: str):
    """Class decorator adding a toolkit to the registry."""

    def deco(cls):
        TOOLKIT_MAP[name] = cls
        return cls

    return deco


def get_toolkit(name: str, config=None):
    # populate the registry lazily (kb_search imports this module)
    from . import kb_search  # noqa: F401

    if name in NOT_PORTED:
        raise NotImplementedError(
            f"toolkit {name!r} is not ported yet (ROADMAP Queue A 6); the port has "
            f"{sorted(TOOLKIT_MAP)}")
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
