"""Chat-completions client layer: a copy of ``youtu_rag_tpu/agents/llm.py``.

The message and response types (``ChatMessage``, ``ToolCall``,
``ChatResponse``, ``StreamDelta``, ``Usage``), the ``BaseChatClient``
surface (``chat``, ``stream_chat``), an OpenAI-compatible client on the
port's ``utils/http.py`` (``httpx`` imported inside the functions that use
it: tool calling, SSE streaming deltas, retry on 429/5xx and timeouts), a
deterministic ``FakeChatClient`` for hermetic tests, and
``get_chat_client``, which serves ``provider: local`` with the in-process
decoder (``agents/local_llm.py``) on the device it is given.
"""

from __future__ import annotations

import json
import os
from collections.abc import AsyncIterator, Callable
from dataclasses import dataclass, field
from typing import Any

from ..utils.http import post_json_with_retry
from ..utils.log import get_logger

logger = get_logger("agents.llm")


@dataclass
class ToolCall:
    id: str
    name: str
    arguments: str  # raw JSON string

    def parsed_arguments(self) -> dict:
        try:
            return json.loads(self.arguments) if self.arguments else {}
        except json.JSONDecodeError:
            return {"_raw": self.arguments}


@dataclass
class ChatMessage:
    role: str  # system | user | assistant | tool
    content: str | None = None
    tool_calls: list[ToolCall] = field(default_factory=list)
    tool_call_id: str | None = None
    reasoning: str | None = None

    def to_openai(self) -> dict:
        d: dict[str, Any] = {"role": self.role}
        if self.content is not None:
            d["content"] = self.content
        if self.tool_calls:
            d["tool_calls"] = [
                {
                    "id": tc.id,
                    "type": "function",
                    "function": {"name": tc.name, "arguments": tc.arguments},
                }
                for tc in self.tool_calls
            ]
        if self.tool_call_id:
            d["tool_call_id"] = self.tool_call_id
        return d


@dataclass
class Usage:
    input_tokens: int = 0
    output_tokens: int = 0

    def add(self, other: "Usage") -> None:
        self.input_tokens += other.input_tokens
        self.output_tokens += other.output_tokens


@dataclass
class ChatResponse:
    message: ChatMessage
    finish_reason: str = "stop"
    usage: Usage = field(default_factory=Usage)


@dataclass
class StreamDelta:
    """One streaming event: text/reasoning/tool-call fragments or final."""

    type: str  # text_delta | reasoning_delta | tool_call | done
    text: str = ""
    tool_call: ToolCall | None = None
    response: ChatResponse | None = None


class BaseChatClient:
    async def chat(
        self,
        messages: list[ChatMessage],
        tools: list[dict] | None = None,
        **kwargs,
    ) -> ChatResponse:
        raise NotImplementedError

    async def stream_chat(
        self,
        messages: list[ChatMessage],
        tools: list[dict] | None = None,
        **kwargs,
    ) -> AsyncIterator[StreamDelta]:
        """Default streaming: one non-streamed call re-emitted as deltas."""
        resp = await self.chat(messages, tools, **kwargs)
        if resp.message.reasoning:
            yield StreamDelta("reasoning_delta", text=resp.message.reasoning)
        if resp.message.content:
            yield StreamDelta("text_delta", text=resp.message.content)
        for tc in resp.message.tool_calls:
            yield StreamDelta("tool_call", tool_call=tc)
        yield StreamDelta("done", response=resp)


class OpenAIChatClient(BaseChatClient):
    """OpenAI-compatible ``/chat/completions`` over httpx."""

    def __init__(
        self,
        model: str | None = None,
        base_url: str | None = None,
        api_key: str | None = None,
        temperature: float | None = None,
        max_tokens: int | None = None,
        timeout: float = 120.0,
        max_retries: int = 3,
    ):
        self.model = model or os.environ.get("YRT_LLM_MODEL") or os.environ.get("UTU_LLM_MODEL", "")
        self.base_url = (
            base_url
            or os.environ.get("YRT_LLM_BASE_URL")
            or os.environ.get("UTU_LLM_BASE_URL", "https://api.openai.com/v1")
        ).rstrip("/")
        self.api_key = api_key or os.environ.get("YRT_LLM_API_KEY") or os.environ.get("UTU_LLM_API_KEY", "")
        self.temperature = temperature
        self.max_tokens = max_tokens
        self.timeout = timeout
        self.max_retries = max_retries

    def _payload(self, messages, tools, stream=False, **kwargs) -> dict:
        payload: dict[str, Any] = {
            "model": kwargs.pop("model", self.model),
            "messages": [m.to_openai() for m in messages],
        }
        if tools:
            payload["tools"] = tools
        if stream:
            payload["stream"] = True
        if self.temperature is not None:
            payload.setdefault("temperature", self.temperature)
        if self.max_tokens is not None:
            payload.setdefault("max_tokens", self.max_tokens)
        payload.update(kwargs)
        return payload

    def _headers(self) -> dict:
        h = {"Content-Type": "application/json"}
        if self.api_key:
            h["Authorization"] = f"Bearer {self.api_key}"
        return h

    @staticmethod
    def _parse_message(msg: dict) -> ChatMessage:
        tcs = [
            ToolCall(
                id=tc.get("id", f"call_{i}"),
                name=tc["function"]["name"],
                arguments=tc["function"].get("arguments", "{}"),
            )
            for i, tc in enumerate(msg.get("tool_calls") or [])
        ]
        return ChatMessage(
            role=msg.get("role", "assistant"),
            content=msg.get("content"),
            tool_calls=tcs,
            reasoning=msg.get("reasoning_content") or msg.get("reasoning"),
        )

    def _require_config(self) -> None:
        if not self.model:
            raise RuntimeError(
                "no LLM configured: set YRT_LLM_MODEL / YRT_LLM_BASE_URL / "
                "YRT_LLM_API_KEY (or UTU_LLM_*), or pass a model config"
            )

    async def chat(self, messages, tools=None, **kwargs) -> ChatResponse:
        self._require_config()
        payload = self._payload(messages, tools, **kwargs)
        data = await post_json_with_retry(
            f"{self.base_url}/chat/completions",
            payload,
            headers=self._headers(),
            timeout=self.timeout,
            max_retries=self.max_retries,
            log=logger,
        )
        choice = data["choices"][0]
        usage = data.get("usage") or {}
        return ChatResponse(
            message=self._parse_message(choice["message"]),
            finish_reason=choice.get("finish_reason", "stop"),
            usage=Usage(usage.get("prompt_tokens", 0), usage.get("completion_tokens", 0)),
        )

    async def stream_chat(self, messages, tools=None, **kwargs) -> AsyncIterator[StreamDelta]:
        import httpx

        self._require_config()
        payload = self._payload(messages, tools, stream=True, **kwargs)
        text_parts: list[str] = []
        reasoning_parts: list[str] = []
        tool_acc: dict[int, dict] = {}
        finish = "stop"
        async with httpx.AsyncClient(timeout=self.timeout) as client:
            async with client.stream(
                "POST", f"{self.base_url}/chat/completions", json=payload, headers=self._headers()
            ) as r:
                r.raise_for_status()
                async for line in r.aiter_lines():
                    if not line.startswith("data:"):
                        continue
                    data = line[5:].strip()
                    if data == "[DONE]":
                        break
                    try:
                        obj = json.loads(data)
                    except json.JSONDecodeError:
                        continue
                    choices = obj.get("choices") or []
                    if not choices:
                        continue
                    choice = choices[0]
                    finish = choice.get("finish_reason") or finish
                    delta = choice.get("delta") or {}
                    if delta.get("reasoning_content"):
                        reasoning_parts.append(delta["reasoning_content"])
                        yield StreamDelta("reasoning_delta", text=delta["reasoning_content"])
                    if delta.get("content"):
                        text_parts.append(delta["content"])
                        yield StreamDelta("text_delta", text=delta["content"])
                    for tc in delta.get("tool_calls") or []:
                        idx = tc.get("index", 0)
                        acc = tool_acc.setdefault(
                            idx, {"id": tc.get("id", f"call_{idx}"), "name": "", "arguments": ""}
                        )
                        if tc.get("id"):
                            acc["id"] = tc["id"]
                        f = tc.get("function") or {}
                        if f.get("name"):
                            acc["name"] = f["name"]
                        if f.get("arguments"):
                            acc["arguments"] += f["arguments"]
        tcs = [ToolCall(a["id"], a["name"], a["arguments"]) for a in tool_acc.values()]
        for tc in tcs:
            yield StreamDelta("tool_call", tool_call=tc)
        msg = ChatMessage(
            role="assistant",
            content="".join(text_parts) or None,
            tool_calls=tcs,
            reasoning="".join(reasoning_parts) or None,
        )
        yield StreamDelta("done", response=ChatResponse(message=msg, finish_reason=finish))


class FakeChatClient(BaseChatClient):
    """Deterministic test double.

    Modes:
    - ``scripted``: pops pre-registered ChatResponses in order;
    - ``rule_fn``:  callable(messages, tools) -> ChatResponse;
    - default echo: answers with the last user message.
    """

    def __init__(
        self,
        scripted: list[ChatResponse] | None = None,
        rule_fn: Callable[[list[ChatMessage], list[dict] | None], ChatResponse] | None = None,
    ):
        self.scripted = list(scripted or [])
        self.rule_fn = rule_fn
        self.calls: list[dict] = []  # recorded invocations for assertions

    @staticmethod
    def text_response(text: str) -> ChatResponse:
        return ChatResponse(ChatMessage(role="assistant", content=text))

    @staticmethod
    def tool_response(name: str, arguments: dict, call_id: str = "call_0") -> ChatResponse:
        return ChatResponse(
            ChatMessage(
                role="assistant",
                tool_calls=[ToolCall(call_id, name, json.dumps(arguments))],
            ),
            finish_reason="tool_calls",
        )

    async def chat(self, messages, tools=None, **kwargs) -> ChatResponse:
        self.calls.append({"messages": list(messages), "tools": tools, **kwargs})
        if self.rule_fn is not None:
            return self.rule_fn(messages, tools)
        if self.scripted:
            return self.scripted.pop(0)
        last_user = next((m.content for m in reversed(messages) if m.role == "user"), "")
        return self.text_response(f"echo: {last_user}")


def _local_client(weights_dir, template, max_tokens, temperature, device):
    """provider "local": the in-process decoder (``agents/local_llm.py``) on
    ``device`` (None: the CUDA card), wrapped for tool calling (a local
    checkpoint has no native function-call API: tools go as ReAct text)."""
    from .local_llm import LocalChatClient
    from .react import ReactChatClient

    return ReactChatClient(
        LocalChatClient(
            weights_dir=weights_dir,
            template=template,
            max_new_tokens=int(max_tokens or 256),
            temperature=float(temperature or 0.0),
            device=device,
        )
    )


def get_chat_client(config: Any | None = None, device=None) -> BaseChatClient:
    """Build a client from a ModelConfig, a dict or the environment (read
    lazily, so offline runs never need it). ``device`` places a local
    model (``provider: local`` or a ``weights_dir``): None is the CUDA card,
    which a host without one refuses; "cpu" runs it on the host."""
    if config is None:
        return OpenAIChatClient()
    if isinstance(config, BaseChatClient):
        return config
    if isinstance(config, dict):
        if config.get("provider") == "local" or config.get("weights_dir"):
            return _local_client(
                config.get("weights_dir"),
                config.get("chat_template"),
                config.get("max_tokens"),
                config.get("temperature"),
                device,
            )
        config = {k: v for k, v in config.items() if k not in ("provider",)}
        return OpenAIChatClient(**config)
    if getattr(config, "provider", None) == "local":
        return _local_client(
            getattr(config, "weights_dir", None),
            getattr(config, "chat_template", None),
            getattr(config, "max_tokens", None),
            getattr(config, "temperature", None),
            device,
        )
    return OpenAIChatClient(
        model=getattr(config, "model", None),
        base_url=getattr(config, "base_url", None),
        api_key=getattr(config, "api_key", None),
        temperature=getattr(config, "temperature", None),
        max_tokens=getattr(config, "max_tokens", None),
    )
