"""SimpleAgent: the config-driven single-agent tool loop. A copy of
``youtu_rag_tpu/agents/simple_agent.py`` on the port's tools and clients.

- ``build()``: the toolkits of the config (``tools.get_toolkit``) and those
  given; ``run(task)`` → a ``TaskRecorder`` with the final output and the
  trajectory; ``run_streamed(task)`` → the recorder at once, events flowing
  through it; ``chat()`` keeps the history across calls;
- the tool loop is capped at ``config.max_turns``; each turn's tool calls
  run concurrently (or in order with ``parallel_tool_calls: false``);
- the memory toolkit (given, or the ``VectorMemoryToolkit`` that
  ``memory.enabled`` builds for ``memory.user_id``) is read before the run
  and written after it.

- the config's environment (``env.name``: ``basic``, ``shell_local``,
  ``browser``; ``agents/env.py``) is built with the agent, its tools join
  the router, and ``cleanup()`` releases it.

The device seam: ``SimpleAgent(..., device=)`` is where the stores and the
local model this agent makes live. The chat client it builds from
``config.model`` (a ``provider: local`` model) gets it, and ``build()``
hands it to the memory toolkit it makes and, as the ``device`` key of each
toolkit config that does not name one, to the config's toolkits (those
that make a store or a KB read it: ``rag``, ``memory``); ``None`` means
the CUDA card, as everywhere in the port. A client or toolkits passed in
keep their own.
"""

from __future__ import annotations

import asyncio
import time

from ..tools.base import AsyncBaseToolkit, ToolRouter
from ..tracing.tracer import get_tracer
from ..utils.log import get_logger
from .config import AgentConfig
from .events import AgentEvent, TaskRecorder, ToolCallRecord
from .llm import BaseChatClient, ChatMessage, get_chat_client

logger = get_logger("agents.simple")


class SimpleAgent:
    def __init__(
        self,
        config: AgentConfig | dict | None = None,
        *,
        client: BaseChatClient | None = None,
        toolkits: list[AsyncBaseToolkit] | None = None,
        memory_toolkit=None,
        trajectory_sink=None,
        hooks=None,
        device=None,
    ):
        if isinstance(config, dict):
            config = AgentConfig.from_dict(config)
        self.config = config or AgentConfig()
        self.client = client or get_chat_client(self.config.model.resolved(), device=device)
        self._extra_toolkits = toolkits or []
        self.memory_toolkit = memory_toolkit
        self.trajectory_sink = trajectory_sink
        self.device = device
        from .context import get_context_manager
        from .hooks import HookRunner, get_run_hooks

        # the compactify manager's LLM summarization path needs an agent;
        # share this agent's client so compaction is real summarization
        # rather than the head-truncation fallback
        from .llm_agent import LLMAgent

        self.context_manager = get_context_manager(
            self.config.context_manager,
            llm_agent=LLMAgent(client=self.client),
        )
        self.hooks = HookRunner(hooks if hooks is not None else get_run_hooks(self.config))
        self.router: ToolRouter | None = None
        self._history: list[ChatMessage] = []
        self._built = False

    # -- lifecycle ---------------------------------------------------------

    async def build(self) -> "SimpleAgent":
        if self._built:
            return self
        toolkits = list(self._extra_toolkits)
        self.env = None
        if self.config.env.name:
            from .env import get_env

            self.env = get_env(self.config.env)
            await self.env.build()
            toolkits.extend(self.env.get_tools())
        if self.config.toolkits:
            from ..tools import get_toolkit

            for name, tk_cfg in self.config.toolkits.items():
                tk_cfg.name = tk_cfg.name or name
                if self.device is not None and "device" not in tk_cfg.config:
                    tk_cfg = tk_cfg.model_copy(
                        update={"config": {**tk_cfg.config, "device": self.device}})
                toolkits.append(get_toolkit(tk_cfg.name, tk_cfg))
        if self.config.memory.enabled and self.memory_toolkit is None:
            from ..memory.toolkit import VectorMemoryToolkit

            self.memory_toolkit = VectorMemoryToolkit(
                {"user_id": self.config.memory.user_id, "device": self.device}
            )
        self.router = ToolRouter(toolkits)
        await self.router.build()
        if self.memory_toolkit is not None:
            await self.memory_toolkit.build()
        self._built = True
        return self

    async def cleanup(self) -> None:
        if self.router:
            await self.router.cleanup()
        if getattr(self, "env", None) is not None:
            await self.env.cleanup()
        self._built = False

    async def __aenter__(self):
        return await self.build()

    async def __aexit__(self, *exc):
        await self.cleanup()

    # -- public API --------------------------------------------------------

    async def run(self, task: str, **kwargs) -> TaskRecorder:
        recorder = self.run_streamed(task, **kwargs)
        async for _ in recorder.stream_events():
            pass
        return await recorder.wait()

    def run_streamed(self, task: str, **kwargs) -> TaskRecorder:
        recorder = TaskRecorder(task=task)
        # the task handle rides on the recorder so stream consumers (SSE/
        # WS handlers) can cancel an abandoned run on client disconnect
        recorder.run_task = asyncio.ensure_future(self._run_loop(task, recorder, **kwargs))
        return recorder

    async def chat(self, message: str) -> str:
        """Multi-turn chat keeping conversation history."""
        rec = await self.run(message, keep_history=True)
        return rec.final_output or ""

    def clear_history(self) -> None:
        self._history = []

    # -- the loop ----------------------------------------------------------

    async def _run_loop(self, task: str, recorder: TaskRecorder, keep_history: bool = False) -> None:
        try:
            await self.build()
            await self.hooks.fire("on_agent_start", self, task)
            messages = await self._prepare_messages(task, keep_history, recorder)
            schemas = self.router.schemas() if self.router else []

            tracer = get_tracer()
            final_text: str | None = None
            for turn in range(self.config.max_turns):
                # per-turn context hook (ref: patched runner injecting
                # context_manager.preprocess each turn, patch/runner.py)
                messages = await self.context_manager.preprocess(messages)
                await self.hooks.fire("on_llm_start", self, messages)
                with tracer.span(
                    "generation", self.config.agent.name or "agent", model=self.config.model.model or ""
                ) as gen_span:
                    resp = await self._chat_streaming(messages, schemas, recorder)
                    gen_span.attributes["output"] = resp.message.content
                    gen_span.attributes["input_tokens"] = resp.usage.input_tokens
                    gen_span.attributes["output_tokens"] = resp.usage.output_tokens
                await self.hooks.fire("on_llm_end", self, resp)
                recorder.usage_input_tokens += resp.usage.input_tokens
                recorder.usage_output_tokens += resp.usage.output_tokens
                msg = resp.message
                if msg.content:
                    recorder.add_message("assistant", msg.content)
                messages.append(msg)

                if not msg.tool_calls:
                    final_text = msg.content or ""
                    break

                # run the turn's tool calls concurrently (asyncio fan-out)
                async def run_one(tc):
                    t0 = time.perf_counter()
                    recorder.emit(
                        AgentEvent("tool_call", name=tc.name, arguments=tc.arguments, call_id=tc.id)
                    )
                    await self.hooks.fire("on_tool_start", self, tc.name, tc.arguments)
                    with tracer.span("tool", tc.name, arguments=tc.arguments) as tool_span:
                        out = await self.router.call(tc.name, tc.parsed_arguments())
                        tool_span.attributes["output"] = out[:500]
                    await self.hooks.fire("on_tool_end", self, tc.name, out)
                    dur = (time.perf_counter() - t0) * 1e3
                    recorder.add_tool_call(ToolCallRecord(tc.name, tc.arguments, out, dur))
                    recorder.emit(
                        AgentEvent("tool_output", name=tc.name, text=out[:4000], call_id=tc.id)
                    )
                    return tc, out

                if self.config.model.parallel_tool_calls is False:
                    # sequential execution (ref: parallel_tool_calls model
                    # setting) — tools with ordering side effects
                    results = [await run_one(tc) for tc in msg.tool_calls]
                else:
                    results = await asyncio.gather(*(run_one(tc) for tc in msg.tool_calls))
                for tc, out in results:
                    messages.append(ChatMessage(role="tool", content=out, tool_call_id=tc.id))
            else:
                final_text = "(max turns reached without final answer)"

            recorder.set_final_output(final_text or "")
            recorder.emit(AgentEvent("final", text=final_text or ""))
            await self.hooks.fire("on_agent_end", self, final_text)

            if keep_history:
                self._history = [m for m in messages if m.role != "system"]

            # the max-turns placeholder is a FAILED run for memory: skills
            # must not earn success credit and the placeholder must not
            # pollute episodic memory as an "answer"
            answered = bool(final_text) and not final_text.startswith("(max turns")
            await self._store_memory(task, final_text if answered else "")
            await self._persist_trajectory(recorder)
            recorder.finish()
        except asyncio.CancelledError:
            # client-disconnect cancellation (run_task.cancel()): the
            # recorder must still finish or other consumers of wait()/
            # stream_events() hang forever
            recorder.finish(error="cancelled")
            raise
        except Exception as e:  # noqa: BLE001
            logger.exception("agent run failed")
            await self._store_memory(task, "")  # skills used by a failed run count as failures
            recorder.emit(AgentEvent("error", text=str(e)))
            recorder.finish(error=str(e))

    async def _chat_streaming(self, messages, schemas, recorder: TaskRecorder):
        """One model turn with incremental delta events.

        Token/reasoning deltas stream through the recorder as they arrive
        (ref: the reference forwards RawResponsesStreamEvents,
        chat_service.py:124-485); falls back to one final event pair for
        clients whose stream_chat is the buffered default."""
        response = None
        async for delta in self.client.stream_chat(messages, tools=schemas or None):
            if delta.type == "text_delta" and delta.text:
                recorder.emit(AgentEvent("text_delta", text=delta.text))
            elif delta.type == "reasoning_delta" and delta.text:
                recorder.emit(AgentEvent("reasoning_delta", text=delta.text))
            elif delta.type == "done":
                response = delta.response
        if response is None:  # stream ended without a done marker
            raise RuntimeError("chat stream ended without a final response")
        return response

    async def _prepare_messages(
        self, task: str, keep_history: bool, recorder: TaskRecorder
    ) -> list[ChatMessage]:
        instructions = self.config.agent.instructions or ""
        memory_context = await self._retrieve_memory(task)
        if memory_context:
            instructions = f"{instructions}\n\n## Relevant memory\n{memory_context}"
            recorder.emit(AgentEvent("memory", text=memory_context[:500]))
        messages: list[ChatMessage] = []
        if instructions:
            messages.append(ChatMessage(role="system", content=instructions))
        if keep_history:
            messages.extend(self._history)
        messages.append(ChatMessage(role="user", content=task))
        recorder.add_message("user", task)
        return messages

    # -- memory hooks (ref: simple_agent.py:345-467) -----------------------

    async def _retrieve_memory(self, task: str) -> str:
        if self.memory_toolkit is None:
            return ""
        try:
            return await self.memory_toolkit.retrieve_all_context(
                query=task, max_items=self.config.memory.max_context_items
            )
        except Exception:  # noqa: BLE001
            logger.exception("memory retrieval failed")
            return ""

    async def _store_memory(self, task: str, answer: str) -> None:
        if self.memory_toolkit is None:
            return
        try:
            # close the skill-usage loop: skills surfaced into this run's
            # context get their success stats updated so retrieve_all_
            # context's min_success_rate gate has real data to act on
            await self.memory_toolkit.record_skill_outcomes(success=bool(answer))
            if answer:
                await self.memory_toolkit.store_conversation(task, answer)
        except Exception:  # noqa: BLE001
            logger.exception("memory store failed")

    async def _persist_trajectory(self, recorder: TaskRecorder) -> None:
        if self.trajectory_sink is None:
            return
        try:
            await self.trajectory_sink(recorder.as_record())
        except Exception:  # noqa: BLE001
            logger.exception("trajectory persist failed")
