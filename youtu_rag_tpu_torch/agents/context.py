"""Context managers: per-turn message preprocessing. A copy of
``youtu_rag_tpu/agents/context.py``: ``NoOpContextManager`` (the default)
and ``CompactifyContextManager`` (token-budgeted history compaction, an LLM
summary when an agent is given, head truncation otherwise)."""

from __future__ import annotations

from typing import Any

from ..utils.log import get_logger
from .llm import ChatMessage

logger = get_logger("agents.context")


def rough_token_count(text: str | None) -> int:
    """Fast token estimate (~4 chars/token for EN, 1 char/token for CJK)."""
    if not text:
        return 0
    cjk = sum(1 for ch in text if "一" <= ch <= "鿿")
    return cjk + (len(text) - cjk) // 4


class BaseContextManager:
    async def preprocess(self, messages: list[ChatMessage]) -> list[ChatMessage]:
        return messages


class NoOpContextManager(BaseContextManager):
    pass


SUMMARY_PROMPT = """Summarize this conversation history into a compact brief
that preserves all facts, decisions, tool results and open questions:

{history}

Reply with the summary only."""


class CompactifyContextManager(BaseContextManager):
    def __init__(
        self,
        max_tokens: int = 24000,
        keep_recent: int = 6,
        llm_agent=None,
    ):
        self.max_tokens = max_tokens
        self.keep_recent = keep_recent
        self.llm_agent = llm_agent

    def _budget(self, messages: list[ChatMessage]) -> int:
        return sum(rough_token_count(m.content) for m in messages)

    async def preprocess(self, messages: list[ChatMessage]) -> list[ChatMessage]:
        if self._budget(messages) <= self.max_tokens:
            return messages
        system = [m for m in messages if m.role == "system"]
        rest = [m for m in messages if m.role != "system"]
        if len(rest) <= self.keep_recent:
            return messages
        old, recent = rest[: -self.keep_recent], rest[-self.keep_recent :]
        # never split a tool response from its assistant tool_call turn
        while recent and recent[0].role == "tool":
            old.append(recent.pop(0))

        history = "\n".join(f"{m.role}: {(m.content or '')[:500]}" for m in old)
        summary_text: str
        if self.llm_agent is not None:
            try:
                summary_text = await self.llm_agent.run(SUMMARY_PROMPT.format(history=history))
            except Exception:  # noqa: BLE001
                logger.exception("LLM compaction failed; truncating")
                summary_text = history[:2000]
        else:
            summary_text = history[:2000]
        summary = ChatMessage(
            role="user",
            content=f"[Conversation summary of {len(old)} earlier messages]\n{summary_text}",
        )
        logger.info("compacted %d messages into summary", len(old))
        return system + [summary] + recent


def get_context_manager(config: Any | None = None, llm_agent=None) -> BaseContextManager:
    """Factory keyed by config.name (ref: ContextManagerConfig)."""
    name = getattr(config, "name", None) if config is not None else None
    if not name:
        return NoOpContextManager()
    if name in ("compactify", "compact"):
        kw = dict(getattr(config, "config", {}) or {})
        return CompactifyContextManager(llm_agent=llm_agent, **kw)
    raise ValueError(f"unknown context manager {name!r}")
