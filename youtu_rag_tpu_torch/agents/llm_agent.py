"""LLMAgent: a bare model wrapper without tools, for planners, judges and
summaries. A copy of ``youtu_rag_tpu/agents/llm_agent.py``."""

from __future__ import annotations

from .config import AgentConfig, ModelConfig
from .llm import BaseChatClient, ChatMessage, get_chat_client


class LLMAgent:
    def __init__(
        self,
        config: AgentConfig | None = None,
        *,
        model: ModelConfig | None = None,
        instructions: str | None = None,
        client: BaseChatClient | None = None,
        device=None,
    ):
        self.config = config or AgentConfig(type="llm")
        if instructions is not None:
            self.config.agent.instructions = instructions
        mc = model or self.config.model
        # device: where a local model (provider "local") is placed
        self.client = client or get_chat_client(mc.resolved(), device=device)

    async def run(self, query: str, system: str | None = None) -> str:
        messages = []
        sys_prompt = system or self.config.agent.instructions
        if sys_prompt:
            messages.append(ChatMessage(role="system", content=sys_prompt))
        messages.append(ChatMessage(role="user", content=query))
        resp = await self.client.chat(messages)
        return resp.message.content or ""

    async def run_messages(self, messages: list[ChatMessage]) -> str:
        resp = await self.client.chat(messages)
        return resp.message.content or ""
