"""The agent layer: chat clients (remote, fake and the local decoder), the
ReAct adapter, the single-agent tool loop and ``get_agent``."""

from .config import AgentConfig, ModelConfig
from .factory import get_agent
from .llm import (
    BaseChatClient,
    ChatMessage,
    ChatResponse,
    FakeChatClient,
    OpenAIChatClient,
    ToolCall,
    get_chat_client,
)
from .llm_agent import LLMAgent
from .simple_agent import SimpleAgent

__all__ = [
    "AgentConfig",
    "BaseChatClient",
    "ChatMessage",
    "ChatResponse",
    "FakeChatClient",
    "LLMAgent",
    "ModelConfig",
    "OpenAIChatClient",
    "SimpleAgent",
    "ToolCall",
    "get_agent",
    "get_chat_client",
]
