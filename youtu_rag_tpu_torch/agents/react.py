"""ReAct adapter: tool calling for models without native function calling.
A copy of ``youtu_rag_tpu/agents/react.py``.

It wraps any ``BaseChatClient``: tool schemas render into the system prompt
with the Thought / Action / Action Input / Final Answer grammar; the
model's text parses back into ``ToolCall``s (a JSON action input) or a
final answer; tool results render as Observation turns. The local chat
model (``agents/local_llm.py``) runs behind it:
``SimpleAgent(config, client=ReactChatClient(LocalChatClient(...)))``."""

from __future__ import annotations

import json
import re

from ..utils.log import get_logger
from .llm import BaseChatClient, ChatMessage, ChatResponse, ToolCall

logger = get_logger("agents.react")

REACT_SYSTEM = """You can use tools by replying in this exact format:

Thought: <your reasoning>
Action: <tool name>
Action Input: <JSON object of arguments>

After each action you will receive:
Observation: <tool result>

When you can answer, reply:
Thought: <your reasoning>
Final Answer: <the answer>

Available tools:
{tools}

Rules: exactly one Action per reply; Action Input must be valid JSON; never
invent Observations."""

_ACTION_RE = re.compile(
    r"Action:\s*(?P<name>[\w.-]+)\s*\n\s*Action\s*Input:\s*(?P<rest>\{.*)",
    re.DOTALL,
)


def _balanced_json(text: str) -> str | None:
    """First balanced {...} object from the start of ``text`` — a lazy
    regex truncated pretty-printed/nested JSON at the first '}' before a
    newline, dropping the tool call entirely."""
    depth = 0
    in_str = False
    esc = False
    for i, ch in enumerate(text):
        if esc:
            esc = False
            continue
        if ch == "\\":
            esc = True
            continue
        if ch == '"':
            in_str = not in_str
            continue
        if in_str:
            continue
        if ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
            if depth == 0:
                return text[: i + 1]
    return None
_FINAL_RE = re.compile(r"Final\s*Answer:\s*(?P<answer>.*)", re.DOTALL)
_THOUGHT_RE = re.compile(r"Thought:\s*(?P<t>.*?)(?=\n(?:Action|Final)|\Z)", re.DOTALL)


def render_tools(tools: list[dict]) -> str:
    lines = []
    for t in tools:
        f = t["function"]
        params = f.get("parameters", {}).get("properties", {})
        args = ", ".join(
            f"{name}: {spec.get('type', 'string')}" for name, spec in params.items()
        )
        lines.append(f"- {f['name']}({args}): {f.get('description', '')}")
    return "\n".join(lines)


def parse_react(text: str) -> tuple[str | None, list[ToolCall], str | None]:
    """→ (thought, tool_calls, final_answer). Final answer wins when both
    appear (model closed the loop)."""
    thought = None
    m = _THOUGHT_RE.search(text or "")
    if m:
        thought = m.group("t").strip()
    m = _FINAL_RE.search(text or "")
    if m:
        return thought, [], m.group("answer").strip()
    m = _ACTION_RE.search(text or "")
    if m:
        raw_args = _balanced_json(m.group("rest"))
        if raw_args is None:
            logger.warning("unterminated Action Input: %r", m.group("rest")[:200])
            return thought, [], text  # degrade to plain answer
        try:
            json.loads(raw_args)
        except json.JSONDecodeError:
            logger.warning("unparseable Action Input: %r", raw_args[:200])
            return thought, [], text  # degrade to plain answer
        return thought, [ToolCall("react_0", m.group("name"), raw_args)], None
    return thought, [], text


class ReactChatClient(BaseChatClient):
    def __init__(self, inner: BaseChatClient):
        self.inner = inner

    @staticmethod
    def _convert_messages(messages: list[ChatMessage], tools: list[dict]) -> list[ChatMessage]:
        """Render the tool-call transcript as ReAct text turns."""
        out: list[ChatMessage] = []
        tool_block = REACT_SYSTEM.format(tools=render_tools(tools))
        sys_done = False
        question = next((m.content for m in messages if m.role == "user"), None)
        last_tool = max(
            (i for i, m in enumerate(messages) if m.role == "tool"), default=-1
        )
        for i, m in enumerate(messages):
            if m.role == "system":
                out.append(ChatMessage("system", f"{m.content}\n\n{tool_block}"))
                sys_done = True
            elif m.role == "assistant" and m.tool_calls:
                acts = "\n".join(
                    f"Thought: (calling tool)\nAction: {tc.name}\nAction Input: {tc.arguments}"
                    for tc in m.tool_calls
                )
                body = f"{m.content}\n{acts}" if m.content else acts
                out.append(ChatMessage("assistant", body))
            elif m.role == "tool":
                body = f"Observation: {m.content}"
                if i == last_tool and question:
                    # restate the task right before the generation point:
                    # the binding tokens (entity, attribute) then sit a few
                    # tokens from the answer slot, turning long-range
                    # associative recall into a short-range induction match
                    # — decisive for the tiny in-repo LM, and a no-op
                    # prompt-craft for remote models
                    body += f"\n\nThe question was: {question}"
                out.append(ChatMessage("user", body))
            else:
                out.append(ChatMessage(m.role, m.content))
        if not sys_done:
            out.insert(0, ChatMessage("system", tool_block))
        return out

    async def chat(self, messages, tools=None, **kwargs) -> ChatResponse:
        if not tools:
            return await self.inner.chat(messages, None, **kwargs)
        converted = self._convert_messages(messages, tools)
        resp = await self.inner.chat(converted, None, **kwargs)
        text = resp.message.content or ""
        thought, tool_calls, final = parse_react(text)
        msg = ChatMessage(
            role="assistant",
            content=final,
            tool_calls=tool_calls,
            reasoning=thought,
        )
        return ChatResponse(
            message=msg,
            finish_reason="tool_calls" if tool_calls else "stop",
            usage=resp.usage,
        )
