"""Streaming event plumbing: ``TaskRecorder`` and typed events. A copy of
``youtu_rag_tpu/agents/events.py``: an asyncio queue with a completion
sentinel behind an async-iterator ``stream_events()``, plus the run record
(input, output, trajectory)."""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Any


@dataclass
class AgentEvent:
    """One streamed event.

    types: reasoning_delta | text_delta | tool_call | tool_output |
           agent_switch | plan | report | error | final"""

    type: str
    text: str = ""
    name: str = ""  # tool or agent name
    arguments: str = ""
    call_id: str = ""
    timestamp: float = field(default_factory=time.time)
    data: dict[str, Any] = field(default_factory=dict)


class _QueueCompleteSentinel:
    pass


_SENTINEL = _QueueCompleteSentinel()


@dataclass
class ToolCallRecord:
    name: str
    arguments: str
    output: str
    duration_ms: float = 0.0


class TaskRecorder:
    """Collects a run's events, trajectory and final output; streams events
    to consumers while the run is in flight."""

    def __init__(self, task: str = "", trace_id: str | None = None):
        self.task = task
        self.trace_id = trace_id or f"run_{int(time.time() * 1000):x}"
        self.created_at = time.time()
        self.final_output: str | None = None
        self.trajectory: list[dict[str, Any]] = []
        self.tool_calls: list[ToolCallRecord] = []
        self.usage_input_tokens = 0
        self.usage_output_tokens = 0
        self.error: str | None = None
        self._queue: asyncio.Queue = asyncio.Queue()
        self._done = asyncio.Event()

    # -- producer side -----------------------------------------------------

    def emit(self, event: AgentEvent) -> None:
        self._queue.put_nowait(event)

    def add_tool_call(self, record: ToolCallRecord) -> None:
        self.tool_calls.append(record)
        self.trajectory.append(
            {
                "role": "tool",
                "name": record.name,
                "arguments": record.arguments,
                "output": record.output[:2000],
            }
        )

    def add_message(self, role: str, content: str | None) -> None:
        if content:
            self.trajectory.append({"role": role, "content": content})

    def set_final_output(self, output: str) -> None:
        self.final_output = output

    def finish(self, error: str | None = None) -> None:
        self.error = error
        self._queue.put_nowait(_SENTINEL)
        self._done.set()

    # -- consumer side -----------------------------------------------------

    async def stream_events(self):
        while True:
            item = await self._queue.get()
            if isinstance(item, _QueueCompleteSentinel):
                break
            yield item

    async def wait(self) -> "TaskRecorder":
        await self._done.wait()
        if self.error:
            raise RuntimeError(self.error)
        return self

    # -- export ------------------------------------------------------------

    def as_record(self) -> dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "input": self.task,
            "output": self.final_output,
            "trajectory": self.trajectory,
            "tool_calls": [
                {"name": t.name, "arguments": t.arguments[:500], "duration_ms": t.duration_ms}
                for t in self.tool_calls
            ],
            "usage": {
                "input_tokens": self.usage_input_tokens,
                "output_tokens": self.usage_output_tokens,
            },
            "created_at": self.created_at,
            "error": self.error,
        }
