"""Run hooks: lifecycle callbacks around agent turns and tool calls. A
copy of ``youtu_rag_tpu/agents/hooks.py``; hooks never break a run
(exceptions are logged and swallowed)."""

from __future__ import annotations

from typing import Any

from ..utils.log import get_logger

logger = get_logger("agents.hooks")


class BaseRunHooks:
    tool_result_max_length = 5000

    async def on_agent_start(self, agent, task: str) -> None:
        ...

    async def on_agent_end(self, agent, output: str | None) -> None:
        ...

    async def on_llm_start(self, agent, messages) -> None:
        ...

    async def on_llm_end(self, agent, response) -> None:
        ...

    async def on_tool_start(self, agent, name: str, arguments: str) -> None:
        logger.debug("[tool] %s(%s)", name, arguments[:200])

    async def on_tool_end(self, agent, name: str, result: str) -> None:
        if len(result) > self.tool_result_max_length:
            logger.warning(
                "tool %s result too long: %d chars exceeds %d",
                name,
                len(result),
                self.tool_result_max_length,
            )


class HookRunner:
    """Fault-isolated hook dispatch."""

    def __init__(self, hooks: BaseRunHooks | None):
        self.hooks = hooks

    async def fire(self, event: str, *args: Any) -> None:
        if self.hooks is None:
            return
        fn = getattr(self.hooks, event, None)
        if fn is None:
            return
        try:
            await fn(*args)
        except Exception:  # noqa: BLE001 - hooks must not break runs
            logger.exception("hook %s failed", event)


def get_run_hooks(config=None) -> BaseRunHooks:
    """Factory (ref: utu/hooks/__init__.py get_run_hooks)."""
    return BaseRunHooks()
