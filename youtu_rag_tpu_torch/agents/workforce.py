"""WorkforceAgent: planner → assigner → executor group → plan-check loop →
answerer.

Parity with ``utu/agents/workforce_agent.py:17-80`` +
``workforce/{planner,assigner,executor,answerer}.py``: the planner drafts a
task list; per task the assigner picks an executor agent; after each
execution the planner checks/updates the remaining plan; the answerer
extracts the final answer from the accumulated task results.

A copy of ``youtu_rag_tpu/agents/workforce.py`` with the port's device
seam: the agent's ``device`` reaches the planner, assigner and answerer
clients it builds and every executor it builds from
``config.workforce_executor_agents``; ``None`` is the CUDA card."""

from __future__ import annotations

import asyncio
import json
import re
from dataclasses import dataclass

from ..utils.log import get_logger
from .config import AgentConfig
from .events import AgentEvent, TaskRecorder
from .llm import BaseChatClient, ChatMessage, get_chat_client
from .simple_agent import SimpleAgent

logger = get_logger("agents.workforce")

_JSON_LIST_RE = re.compile(r"\[.*\]", re.DOTALL)
_JSON_OBJ_RE = re.compile(r"\{.*\}", re.DOTALL)

PLAN_PROMPT = """You are a project planner. Decompose the request into an \
ordered list of concrete tasks.

Executors available:
{executors_info}

Reply with a JSON list of task strings only: ["task 1", "task 2", ...]"""

ASSIGN_PROMPT = """Pick the best executor for this task.

Executors:
{executors_info}

Task: {task}

Reply JSON only: {{"executor": "<name>", "instruction": "<refined instruction>"}}"""

CHECK_PROMPT = """You are reviewing plan progress.

Original request: {question}
Completed so far:
{completed}
Remaining plan: {remaining}

If the remaining plan is still right, reply {{"action": "continue"}}.
If the request is already fully answered, reply {{"action": "finish"}}.
To replace the remaining plan, reply {{"action": "update", "tasks": ["..."]}}.
Reply JSON only."""

ANSWER_PROMPT = """Extract the final answer to the request from the task \
results.

Request: {question}

Task results:
{results}

Write the final answer."""


@dataclass
class WorkforceTask:
    task: str
    executor: str = ""
    result: str | None = None


class WorkforceAgent:
    def __init__(
        self,
        config: AgentConfig,
        *,
        client: BaseChatClient | None = None,
        executors: dict[str, SimpleAgent] | None = None,
        device=None,
    ):
        self.config = config
        self.device = device
        self.planner_client = client or get_chat_client(
            config.workforce_planner_model.resolved(), device=device)
        self.assigner_client = client or get_chat_client(
            config.workforce_assigner_model.resolved(), device=device)
        self.answerer_client = client or get_chat_client(
            config.workforce_answerer_model.resolved(), device=device)
        self._executors = executors
        self.max_iterations = 20

    async def build(self):
        if self._executors is None:
            self._executors = {
                name: SimpleAgent(cfg, device=self.device)
                for name, cfg in self.config.workforce_executor_agents.items()
            }
        for e in self._executors.values():
            await e.build()
        return self

    async def cleanup(self) -> None:
        """Release worker resources (env workspaces, containers) — the
        same contract SimpleAgent.cleanup provides."""
        for w in (self._executors or {}).values():
            if hasattr(w, "cleanup"):
                try:
                    await w.cleanup()
                except Exception:  # noqa: BLE001 - best-effort teardown
                    logger.exception("worker cleanup failed")

    def _executors_info(self) -> str:
        infos = self.config.workforce_executor_infos or [
            {"name": n, "desc": (e.config.agent.instructions or "")[:150]}
            for n, e in (self._executors or {}).items()
        ]
        return "\n".join(f"- {i.get('name')}: {i.get('desc', '')}" for i in infos)

    @staticmethod
    def _json(text: str, pattern: re.Pattern):
        m = pattern.search(text or "")
        if not m:
            return None
        try:
            return json.loads(m.group(0))
        except json.JSONDecodeError:
            return None

    async def plan_task(self, question: str) -> list[WorkforceTask]:
        resp = await self.planner_client.chat(
            [
                ChatMessage("system", PLAN_PROMPT.format(executors_info=self._executors_info())),
                ChatMessage("user", question),
            ]
        )
        items = self._json(resp.message.content, _JSON_LIST_RE) or [question]
        return [WorkforceTask(str(t)) for t in items if str(t).strip()]

    async def assign_task(self, task: WorkforceTask) -> tuple[SimpleAgent | None, str]:
        resp = await self.assigner_client.chat(
            [
                ChatMessage(
                    "user",
                    ASSIGN_PROMPT.format(executors_info=self._executors_info(), task=task.task),
                )
            ]
        )
        data = self._json(resp.message.content, _JSON_OBJ_RE) or {}
        name = data.get("executor") or next(iter(self._executors), "")
        task.executor = name
        instruction = data.get("instruction") or task.task
        return self._executors.get(name), instruction

    async def run(self, question: str) -> TaskRecorder:
        recorder = self.run_streamed(question)
        async for _ in recorder.stream_events():
            pass
        return await recorder.wait()

    def run_streamed(self, question: str) -> TaskRecorder:
        recorder = TaskRecorder(task=question)

        async def go():
            try:
                await self.build()
                answer = await self._loop(question, recorder)
                recorder.set_final_output(answer)
                recorder.emit(AgentEvent("final", text=answer))
                recorder.finish()
            except Exception as e:  # noqa: BLE001
                logger.exception("workforce run failed")
                recorder.emit(AgentEvent("error", text=str(e)))
                recorder.finish(error=str(e))

        # handle on the recorder: stream consumers cancel abandoned
        # runs (client disconnect) via recorder.run_task
        recorder.run_task = asyncio.ensure_future(go())
        return recorder

    @staticmethod
    def _emit_workflow(recorder, completed, running, pending):
        """Live plan tree (same workflow_update contract as OrchestraAgent;
        ref: workflow visualization events)."""
        nodes = [
            {"id": i, "agent": t.executor or "?", "task": t.task, "status": "done"}
            for i, t in enumerate(completed)
        ]
        base = len(nodes)
        if running is not None:
            nodes.append(
                {"id": base, "agent": running.executor or "?", "task": running.task,
                 "status": "running"}
            )
            base += 1
        nodes += [
            {"id": base + i, "agent": t.executor or "?", "task": t.task, "status": "pending"}
            for i, t in enumerate(pending)
        ]
        recorder.emit(AgentEvent("workflow_update", data={"nodes": nodes}))

    async def _loop(self, question: str, recorder: TaskRecorder) -> str:
        pending = await self.plan_task(question)
        recorder.emit(AgentEvent("plan", data={"tasks": [t.task for t in pending]}))
        completed: list[WorkforceTask] = []
        self._emit_workflow(recorder, completed, None, pending)

        for _ in range(self.max_iterations):
            if not pending:
                break
            task = pending.pop(0)
            executor, instruction = await self.assign_task(task)
            recorder.emit(AgentEvent("agent_switch", name=task.executor, text=task.task))
            self._emit_workflow(recorder, completed, task, pending)
            if executor is None:
                task.result = f"(unknown executor {task.executor})"
            else:
                context = "\n".join(f"- {t.task}: {t.result}" for t in completed)
                full = f"Context of completed tasks:\n{context}\n\nTask: {instruction}" if context else instruction
                rec = await executor.run(full)
                task.result = rec.final_output or ""
            completed.append(task)
            recorder.add_message(task.executor or "executor", task.result or "")
            self._emit_workflow(recorder, completed, None, pending)

            # plan check/update (ref: plan_check/plan_update loop)
            check = await self.planner_client.chat(
                [
                    ChatMessage(
                        "user",
                        CHECK_PROMPT.format(
                            question=question,
                            completed="\n".join(f"- {t.task}: {t.result}" for t in completed),
                            remaining=json.dumps([t.task for t in pending]),
                        ),
                    )
                ]
            )
            data = self._json(check.message.content, _JSON_OBJ_RE) or {"action": "continue"}
            if data.get("action") == "finish":
                break
            if data.get("action") == "update":
                pending = [WorkforceTask(str(t)) for t in data.get("tasks", [])]
                recorder.emit(AgentEvent("plan", data={"tasks": [t.task for t in pending]}))

        results = "\n".join(f"- {t.task} [{t.executor}]: {t.result}" for t in completed)
        resp = await self.answerer_client.chat(
            [ChatMessage("user", ANSWER_PROMPT.format(question=question, results=results))]
        )
        return resp.message.content or ""
