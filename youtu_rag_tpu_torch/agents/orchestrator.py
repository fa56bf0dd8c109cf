"""Chain orchestrator + parallel orchestrator. A copy of
``youtu_rag_tpu/agents/orchestrator.py`` with the port's device seam: the
agent's ``device`` reaches the orchestrator client it builds and every
worker it builds from ``config.orchestrator_workers``; ``None`` is the CUDA
card.

Parity surfaces:
- ``OrchestratorAgent`` (ref: utu/agents/orchestrator_agent.py:25-118 +
  orchestrator/chain.py): an LLM router plans an ordered chain of worker
  tasks as JSON; each task renders the prior results into its context;
  optional replanning after each step; a built-in chitchat worker answers
  directly when no planning is needed (ref add_chitchat_subagent).
- ``ParallelOrchestratorAgent`` (ref: parallel_orchestrator_agent.py:32-100
  + orchestrator/parallel.py): the planner groups independent tasks, groups
  run concurrently under ``max_parallel`` with per-task timeout, and an LLM
  merger synthesizes the results.
"""

from __future__ import annotations

import asyncio
import json
import re
import time
from dataclasses import dataclass

from ..utils.log import get_logger
from .config import AgentConfig
from .events import AgentEvent, TaskRecorder
from .llm import BaseChatClient, ChatMessage, get_chat_client
from .simple_agent import SimpleAgent

logger = get_logger("agents.orchestrator")

_JSON_RE = re.compile(r"\[.*\]", re.DOTALL)


@dataclass
class ChainTask:
    agent_name: str
    task: str
    result: str | None = None
    status: str = "pending"  # pending | running | done | failed | timeout


CHAIN_PLANNER_PROMPT = """You are an orchestrator routing a user request to \
specialist workers.

Workers:
{workers_info}

If the request is simple chitchat that needs no worker, reply with:
[{{"agent_name": "chitchat", "task": "<the request>"}}]

Otherwise produce an ordered JSON list of worker tasks (executed in order,
each sees previous results):
[{{"agent_name": "<worker>", "task": "<task description>"}}, ...]

Reply with the JSON list only."""


PARALLEL_PLANNER_PROMPT = """You are an orchestrator decomposing a request \
into INDEPENDENT subtasks that can run in parallel.

Workers:
{workers_info}

Produce a JSON object of task GROUPS: groups run in order (a later group
sees every earlier group's results); tasks inside one group run in
parallel and must be independent of each other:
{{"groups": [[{{"agent_name": "<worker>", "task": "<task description>"}}, ...], ...]}}

A single flat JSON list is also accepted and treated as one group.
Reply with the JSON only."""


MERGER_PROMPT = """Merge the results of parallel subtasks into one coherent \
answer to the original request.

Request: {question}

Subtask results:
{results}

Write the merged answer."""


def _coerce_tasks(items: object) -> list[ChainTask]:
    out = []
    for it in items if isinstance(items, list) else []:
        if isinstance(it, dict) and it.get("task"):
            out.append(ChainTask(str(it.get("agent_name", "")), str(it["task"])))
    return out


def parse_task_list(text: str) -> list[ChainTask]:
    m = _JSON_RE.search(text or "")
    if not m:
        return []
    try:
        items = json.loads(m.group(0))
    except json.JSONDecodeError:
        return []
    return _coerce_tasks(items)


_GROUPS_RE = re.compile(r"\{.*\}", re.DOTALL)


def parse_parallel_plan(text: str) -> list[list[ChainTask]]:
    """Parse the planner reply into ordered groups of parallel tasks
    (ref ``utu/agents/orchestrator/parallel.py:107-163`` ParallelGroup
    structure). A flat task list becomes a single group."""
    m = _GROUPS_RE.search(text or "")
    if m:
        try:
            doc = json.loads(m.group(0))
        except json.JSONDecodeError:
            doc = None
        if isinstance(doc, dict) and isinstance(doc.get("groups"), list):
            groups = [g for g in (_coerce_tasks(x) for x in doc["groups"]) if g]
            if groups:
                return groups
    flat = parse_task_list(text)
    return [flat] if flat else []


class _BaseOrchestrator:
    def __init__(self, config: AgentConfig, *, client: BaseChatClient | None = None,
                 workers: dict[str, SimpleAgent] | None = None, device=None):
        self.config = config
        self.device = device
        self.client = client or get_chat_client(config.orchestrator_model.resolved(),
                                                device=device)
        self._workers = workers

    async def build(self):
        if self._workers is None:
            self._workers = {
                name: SimpleAgent(cfg, device=self.device)
                for name, cfg in self.config.orchestrator_workers.items()
            }
        for w in self._workers.values():
            await w.build()
        return self

    async def cleanup(self) -> None:
        """Release worker resources (env workspaces, containers) — the
        same contract SimpleAgent.cleanup provides."""
        for w in (self._workers or {}).values():
            if hasattr(w, "cleanup"):
                try:
                    await w.cleanup()
                except Exception:  # noqa: BLE001 - best-effort teardown
                    logger.exception("worker cleanup failed")

    def _workers_info(self) -> str:
        infos = self.config.orchestrator_workers_info or [
            {"name": n, "description": (w.config.agent.instructions or "")[:200]}
            for n, w in (self._workers or {}).items()
        ]
        return "\n".join(f"- {i.get('name')}: {i.get('description', '')}" for i in infos)

    async def run(self, task: str) -> TaskRecorder:
        recorder = self.run_streamed(task)
        async for _ in recorder.stream_events():
            pass
        return await recorder.wait()

    def run_streamed(self, task: str) -> TaskRecorder:
        recorder = TaskRecorder(task=task)

        async def go():
            try:
                await self.build()
                answer = await self._execute(task, recorder)
                recorder.set_final_output(answer)
                recorder.emit(AgentEvent("final", text=answer))
                recorder.finish()
            except Exception as e:  # noqa: BLE001
                logger.exception("orchestrator run failed")
                recorder.emit(AgentEvent("error", text=str(e)))
                recorder.finish(error=str(e))

        # handle on the recorder: stream consumers cancel abandoned
        # runs (client disconnect) via recorder.run_task
        recorder.run_task = asyncio.ensure_future(go())
        return recorder

    async def _execute(self, task: str, recorder: TaskRecorder) -> str:
        raise NotImplementedError


class OrchestratorAgent(_BaseOrchestrator):
    async def _execute(self, task: str, recorder: TaskRecorder) -> str:
        resp = await self.client.chat(
            [
                ChatMessage("system", CHAIN_PLANNER_PROMPT.format(workers_info=self._workers_info())),
                ChatMessage("user", task),
            ]
        )
        chain = parse_task_list(resp.message.content or "")
        recorder.emit(AgentEvent("plan", data={"chain": [vars(t) for t in chain]}))
        if not chain or (len(chain) == 1 and chain[0].agent_name == "chitchat"):
            # chitchat path: answer directly (ref auto-added ChitchatAgent)
            direct = await self.client.chat([ChatMessage("user", task)])
            return direct.message.content or ""

        results: list[str] = []
        for i, step in enumerate(chain):
            worker = self._workers.get(step.agent_name)
            if worker is None:
                step.status = "failed"
                step.result = f"(unknown worker {step.agent_name})"
                results.append(step.result)
                continue
            recorder.emit(AgentEvent("agent_switch", name=step.agent_name, text=step.task))
            context = "\n".join(
                f"Result of step {j+1} ({chain[j].agent_name}): {chain[j].result}"
                for j in range(i)
                if chain[j].result
            )
            prompt = f"{context}\n\nYour task: {step.task}" if context else step.task
            step.status = "running"
            rec = await worker.run(prompt)
            step.result = rec.final_output or ""
            step.status = "done"
            results.append(step.result)
            recorder.add_message(step.agent_name, step.result)
        return results[-1] if results else ""


class ParallelOrchestratorAgent(_BaseOrchestrator):
    """Grouped parallel execution with per-task streaming.

    Event protocol (ref ``utu/agents/parallel_orchestrator_agent.py:140-330``
    ParallelOrchestratorEvent names, carried here in ``AgentEvent.data``):
    ``plan`` → per group ``parallel_group{status:start}`` → per task
    ``parallel_task{status:start|done|failed|timeout}`` with every worker
    sub-event forwarded tagged ``data.parallel_agent`` (the frontend routes
    those into that task's window) → ``parallel_group{status:done}`` →
    ``merge{status:start|done}``. Groups run in order and later groups see
    earlier results (ref ``_build_task_context``)."""

    async def _execute(self, task: str, recorder: TaskRecorder) -> str:
        resp = await self.client.chat(
            [
                ChatMessage(
                    "system", PARALLEL_PLANNER_PROMPT.format(workers_info=self._workers_info())
                ),
                ChatMessage("user", task),
            ]
        )
        groups = parse_parallel_plan(resp.message.content or "")
        if not groups:
            direct = await self.client.chat([ChatMessage("user", task)])
            return direct.message.content or ""
        recorder.emit(
            AgentEvent("plan", data={"parallel_groups": [[vars(t) for t in g] for g in groups]})
        )

        sem = asyncio.Semaphore(self.config.max_parallel)
        done_tasks: list[ChainTask] = []

        async def run_one(t: ChainTask, gi: int, ti: int, context: str) -> None:
            base = {"group": gi, "task_idx": ti, "agent_name": t.agent_name}
            async with sem:
                worker = self._workers.get(t.agent_name)
                if worker is None:
                    t.status, t.result = "failed", f"(unknown worker {t.agent_name})"
                    recorder.emit(
                        AgentEvent(
                            "parallel_task", name=t.agent_name,
                            data={**base, "status": "failed", "error": t.result},
                        )
                    )
                    return
                recorder.emit(
                    AgentEvent(
                        "parallel_task", name=t.agent_name,
                        data={**base, "status": "start", "task": t.task},
                    )
                )
                t.status = "running"
                prompt = f"{context}\n\nYour task: {t.task}" if context else t.task
                sub = worker.run_streamed(prompt)

                async def drain(_sub=sub):
                    async for ev in _sub.stream_events():
                        # forward live worker events tagged for window
                        # routing; the worker's own final/error are
                        # represented by the parallel_task done/failed
                        # card instead of leaking into the main stream
                        if ev.type in ("final", "error", "done"):
                            continue
                        ev.data = {**ev.data, "parallel_agent": t.agent_name, **base}
                        recorder.emit(ev)
                    return await _sub.wait()

                t0 = time.monotonic()
                try:
                    rec = await asyncio.wait_for(drain(), timeout=self.config.task_timeout)
                    t.result = rec.final_output or ""
                    t.status = "done"
                    recorder.emit(
                        AgentEvent(
                            "parallel_task", name=t.agent_name,
                            data={
                                **base, "status": "done", "result": t.result[:4000],
                                "duration_ms": round((time.monotonic() - t0) * 1000, 1),
                            },
                        )
                    )
                except asyncio.TimeoutError:
                    t.status, t.result = "timeout", f"(timed out after {self.config.task_timeout}s)"
                    # cancel the worker's BACKGROUND run, not just our
                    # await — otherwise the zombie keeps burning model
                    # turns (and writing memory) for a task already
                    # reported as timed out
                    run_task = getattr(sub, "run_task", None)
                    if run_task is not None and not run_task.done():
                        run_task.cancel()
                    recorder.emit(
                        AgentEvent(
                            "parallel_task", name=t.agent_name,
                            data={**base, "status": "timeout", "error": t.result},
                        )
                    )
                except Exception as e:  # noqa: BLE001
                    t.status, t.result = "failed", f"(failed: {e})"
                    recorder.emit(
                        AgentEvent(
                            "parallel_task", name=t.agent_name,
                            data={**base, "status": "failed", "error": str(e)},
                        )
                    )
                recorder.add_message(t.agent_name, t.result or "")

        for gi, group in enumerate(groups):
            recorder.emit(
                AgentEvent(
                    "parallel_group",
                    data={
                        "group": gi, "status": "start",
                        "tasks": [{"agent_name": t.agent_name, "task": t.task} for t in group],
                    },
                )
            )
            context = "\n".join(
                f"Result of earlier task ({t.agent_name}: {t.task}): {t.result}"
                for t in done_tasks
                if t.status == "done" and t.result
            )
            await asyncio.gather(*(run_one(t, gi, ti, context) for ti, t in enumerate(group)))
            done_tasks.extend(group)
            recorder.emit(AgentEvent("parallel_group", data={"group": gi, "status": "done"}))

        results_text = "\n\n".join(
            f"[{t.agent_name} | {t.status}] {t.task}\n{t.result}" for t in done_tasks
        )
        recorder.emit(AgentEvent("merge", data={"status": "start"}))
        merged = await self.client.chat(
            [ChatMessage("user", MERGER_PROMPT.format(question=task, results=results_text))]
        )
        recorder.emit(AgentEvent("merge", data={"status": "done"}))
        return merged.message.content or ""
