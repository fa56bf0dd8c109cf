"""Toolkit base: ``@register_tool`` methods → callable map → OpenAI/MCP
schemas. A copy of ``youtu_rag_tpu/tools/base.py``: lazy tools map from
decorated methods, ``activated_tools`` filtering, ``get_tools_in_openai()``
(non-strict schemas), ``get_tools_in_mcp()`` (plain dicts),
``call_tool(name, args) -> str``, ``build()``/``cleanup()`` hooks, and the
agents' ``ToolRouter``."""

from __future__ import annotations

import asyncio
import inspect
from typing import Any, Callable

from pydantic import BaseModel, ConfigDict, Field

from ..utils.log import get_logger
from .schema import function_schema

logger = get_logger("tools.base")


class ToolkitConfig(BaseModel):
    """Ref: utu/config/agent_config.py ToolkitConfig semantics."""

    model_config = ConfigDict(extra="allow")

    name: str = ""
    mode: str = "builtin"  # builtin | mcp
    activated_tools: list[str] | None = None
    config: dict[str, Any] = Field(default_factory=dict)


def register_tool(name_or_fn: str | Callable | None = None):
    """Mark an async method as an agent-callable tool.

    Usable bare (``@register_tool``) or named (``@register_tool("x")``)."""

    def mark(fn: Callable, name: str | None = None):
        fn._is_tool = True
        fn._tool_name = name or fn.__name__
        return fn

    if callable(name_or_fn):
        return mark(name_or_fn)
    return lambda fn: mark(fn, name_or_fn)


class AsyncBaseToolkit:
    def __init__(self, config: ToolkitConfig | dict | None = None):
        if not isinstance(config, ToolkitConfig):
            config = ToolkitConfig(config=config or {}, name=type(self).__name__)
        self.config = config
        self._tools_map: dict[str, Callable] | None = None
        self._built = False

    async def build(self) -> None:
        """Acquire resources (stores, sessions). Idempotent."""
        self._built = True

    async def cleanup(self) -> None:
        """Release resources."""
        self._built = False

    @property
    def tools_map(self) -> dict[str, Callable]:
        if self._tools_map is None:
            self._tools_map = {}
            for attr_name in dir(type(self)):
                if attr_name.startswith("__"):
                    continue
                # skip properties: evaluating them during the scan can force
                # lazy resources (KB resolution, DB connects) or raise
                if isinstance(getattr(type(self), attr_name, None), property):
                    continue
                attr = getattr(self, attr_name, None)
                if callable(attr) and getattr(attr, "_is_tool", False):
                    self._tools_map[attr._tool_name] = attr
        return self._tools_map

    def get_tools_map_func(self) -> dict[str, Callable]:
        active = self.config.activated_tools
        if active:
            unknown = [t for t in active if t not in self.tools_map]
            assert not unknown, f"unknown activated tools {unknown}; available: {list(self.tools_map)}"
            return {t: self.tools_map[t] for t in active}
        return dict(self.tools_map)

    def get_tools_in_openai(self) -> list[dict]:
        return [
            function_schema(fn, name) for name, fn in self.get_tools_map_func().items()
        ]

    def get_tools_in_mcp(self) -> list[dict]:
        out = []
        for schema in self.get_tools_in_openai():
            f = schema["function"]
            out.append(
                {"name": f["name"], "description": f["description"], "inputSchema": f["parameters"]}
            )
        return out

    async def call_tool(self, name: str, arguments: dict) -> str:
        tools = self.get_tools_map_func()
        if name not in tools:
            raise ValueError(f"Tool {name} not found in {self.config.name}")
        if not self._built:
            await self.build()
        result = tools[name](**arguments)
        if inspect.isawaitable(result):
            result = await result
        return result if isinstance(result, str) else str(result)


class ToolRouter:
    """Flat name → (toolkit, fn) routing across toolkits, used by agents.

    Detects name collisions at registration (the reference silently
    overwrites)."""

    def __init__(self, toolkits: list[AsyncBaseToolkit]):
        self.toolkits = toolkits
        self._route: dict[str, AsyncBaseToolkit] = {}
        self._rebuild_routes()

    def _rebuild_routes(self) -> None:
        self._route = {}
        for tk in self.toolkits:
            for name in tk.get_tools_map_func():
                if name in self._route:
                    raise ValueError(f"duplicate tool name {name!r} across toolkits")
                self._route[name] = tk

    def schemas(self) -> list[dict]:
        out = []
        for tk in self.toolkits:
            out.extend(tk.get_tools_in_openai())
        return out

    def tool_names(self) -> list[str]:
        return list(self._route)

    async def build(self) -> None:
        await asyncio.gather(*(tk.build() for tk in self.toolkits))
        # MCP toolkits only DISCOVER their remote tools in build(); the
        # routes frozen at __init__ would advertise them in schemas()
        # while call() reports "unknown tool" for every one
        self._rebuild_routes()

    async def cleanup(self) -> None:
        await asyncio.gather(*(tk.cleanup() for tk in self.toolkits))

    async def call(self, name: str, arguments: dict) -> str:
        tk = self._route.get(name)
        if tk is None:
            return f"Error: unknown tool {name!r}; available: {self.tool_names()}"
        try:
            return await tk.call_tool(name, arguments)
        except Exception as e:  # noqa: BLE001 - tool errors surface to the LLM
            logger.exception("tool %s failed", name)
            return f"Error calling {name}: {e}"
