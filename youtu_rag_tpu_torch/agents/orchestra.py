"""OrchestraAgent: plan → sequential work → report. A copy of
``youtu_rag_tpu/agents/orchestra.py`` with the port's device seam: the
agent's ``device`` reaches the planner and reporter clients it builds and
every worker it builds from ``config.workers`` (``SimpleAgent(...,
device=)``); ``None`` is the CUDA card.

Parity with ``utu/agents/orchestra_agent.py:26-113`` +
``orchestra/{planner,worker,reporter}.py``:
- the planner LLM emits ``<analysis>…</analysis>`` and ``<plan>[{"agent_name":
  …, "task": …, "completed": false}, …]</plan>``; the same regex protocol is
  parsed here so planner prompts/few-shots transfer;
- workers are SimpleAgents selected by ``agent_name`` from config.workers,
  run sequentially, each receiving the accumulated trajectory;
- the reporter LLM synthesizes the final answer from the task trajectory.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field

from ..utils.log import get_logger
from .config import AgentConfig
from .events import AgentEvent, TaskRecorder
from .llm import BaseChatClient, ChatMessage, get_chat_client
from .simple_agent import SimpleAgent

logger = get_logger("agents.orchestra")


@dataclass
class Subtask:
    agent_name: str
    task: str
    completed: bool = False
    result: str | None = None


@dataclass
class PlanResult:
    analysis: str = ""
    todo: list[Subtask] = field(default_factory=list)


_ANALYSIS_RE = re.compile(r"<analysis>(.*?)</analysis>", re.DOTALL)
_PLAN_RE = re.compile(r"<plan>\s*\[(.*?)\]\s*</plan>", re.DOTALL)
_TASK_RE = re.compile(
    r'\{\s*"agent_name"\s*:\s*"([^"]+)"\s*,\s*"task"\s*:\s*"([^"]+)"\s*,\s*"completed"\s*:\s*(true|false)\s*\}',
    re.IGNORECASE,
)


def parse_plan(text: str) -> PlanResult:
    """Parse the planner protocol (ref: orchestra/planner.py:13-44)."""
    analysis = ""
    m = _ANALYSIS_RE.search(text)
    if m:
        analysis = m.group(1).strip()
    todo: list[Subtask] = []
    m = _PLAN_RE.search(text)
    if m:
        for agent_name, task, completed in _TASK_RE.findall(m.group(1)):
            todo.append(Subtask(agent_name, task, completed.lower() == "true"))
    return PlanResult(analysis=analysis, todo=todo)


PLANNER_PROMPT = """You are a task planner coordinating specialist agents.

Available agents:
{agents_info}

Analyze the user's question and produce a step-by-step plan assigning each
subtask to the best-suited agent.
{examples}
Reply EXACTLY in this format:
<analysis>your reasoning about how to decompose the task</analysis>
<plan>[
{{"agent_name": "<name>", "task": "<subtask description>", "completed": false}},
...
]</plan>"""


def load_planner_examples(path: str | None = None) -> str:
    """Few-shot examples rendered into the planner prompt
    (ref: orchestra/data/planner_examples.json + examples_path config)."""
    import os

    path = path or os.path.join(os.path.dirname(__file__), "data", "planner_examples.json")
    try:
        examples = json.loads(open(path, encoding="utf-8").read())
    except (OSError, json.JSONDecodeError):
        logger.warning("could not load planner examples from %s", path)
        return ""
    parts = ["\nExamples:"]
    for ex in examples:
        plan_lines = ",\n".join(json.dumps(t, ensure_ascii=False) for t in ex["plan"])
        parts.append(
            f"Question: {ex['question']}\n"
            f"<analysis>{ex['analysis']}</analysis>\n<plan>[\n{plan_lines}\n]</plan>"
        )
    return "\n\n".join(parts) + "\n"


REPORTER_PROMPT = """You are a reporter. Given the original question and the \
work trajectory of specialist agents, synthesize the final answer.

Question: {question}

Trajectory:
{trajectory}

Write the final answer for the user."""


class OrchestraAgent:
    def __init__(self, config: AgentConfig, *, client: BaseChatClient | None = None,
                 workers: dict[str, SimpleAgent] | None = None, device=None):
        self.config = config
        self.device = device
        # one client may be shared for planner/reporter in tests
        self.planner_client = client or get_chat_client(config.planner_model.resolved(),
                                                        device=device)
        self.reporter_client = client or get_chat_client(config.reporter_model.resolved(),
                                                         device=device)
        self._workers = workers

    async def build(self) -> "OrchestraAgent":
        if self._workers is None:
            self._workers = {
                name: SimpleAgent(w_cfg, device=self.device)
                for name, w_cfg in self.config.workers.items()
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

    def _agents_info(self) -> str:
        infos = self.config.workers_info or [
            {"name": n, "desc": (w.config.agent.instructions or "")[:200]}
            for n, w in (self._workers or {}).items()
        ]
        return "\n".join(
            f"- {i.get('name')}: {i.get('desc', '')} "
            f"(strengths: {i.get('strengths', '-')}; weaknesses: {i.get('weaknesses', '-')})"
            for i in infos
        )

    async def plan(self, task: str, recorder: TaskRecorder) -> PlanResult:
        examples = ""
        if self.config.planner_config.get("use_examples", True):
            examples = load_planner_examples(self.config.planner_config.get("examples_path"))
        prompt = PLANNER_PROMPT.format(agents_info=self._agents_info(), examples=examples)
        resp = await self.planner_client.chat(
            [ChatMessage("system", prompt), ChatMessage("user", task)]
        )
        plan = parse_plan(resp.message.content or "")
        if not plan.todo:
            # degenerate fallback: single task for the first worker
            first = next(iter(self._workers), None)
            if first:
                plan.todo = [Subtask(first, task)]
        recorder.emit(
            AgentEvent("plan", text=plan.analysis, data={"todo": [vars(t) for t in plan.todo]})
        )
        recorder.add_message("planner", plan.analysis)
        return plan

    @staticmethod
    def _workflow_nodes(plan: PlanResult, running: int | None = None) -> list[dict]:
        """Snapshot of the plan as workflow nodes (ref: the chat stream's
        workflow_update visualization events, routes/chat.py docstring +
        the webui workflow tree)."""
        nodes = []
        for i, t in enumerate(plan.todo):
            status = "done" if t.completed else ("running" if i == running else "pending")
            if t.result and not t.completed and i != running:
                status = "failed"
            nodes.append(
                {"id": i, "agent": t.agent_name, "task": t.task, "status": status}
            )
        return nodes

    def _emit_workflow(self, recorder: TaskRecorder, plan: PlanResult, running=None):
        recorder.emit(
            AgentEvent("workflow_update", data={"nodes": self._workflow_nodes(plan, running)})
        )

    async def work(self, plan: PlanResult, recorder: TaskRecorder) -> str:
        trajectory_parts: list[str] = []
        self._emit_workflow(recorder, plan)
        for i, sub in enumerate(plan.todo):
            if sub.completed:
                continue
            worker = self._workers.get(sub.agent_name)
            if worker is None:
                logger.warning("no worker %r; skipping", sub.agent_name)
                sub.result = f"(no agent named {sub.agent_name})"
                self._emit_workflow(recorder, plan)
                continue
            recorder.emit(AgentEvent("agent_switch", name=sub.agent_name, text=sub.task))
            self._emit_workflow(recorder, plan, running=i)
            context = "\n".join(trajectory_parts)
            task_text = (
                f"Overall context so far:\n{context}\n\nYour subtask: {sub.task}"
                if context
                else sub.task
            )
            sub_rec = await worker.run(task_text)
            sub.result = sub_rec.final_output or ""
            sub.completed = True
            trajectory_parts.append(f"[{sub.agent_name}] task: {sub.task}\nresult: {sub.result}")
            recorder.add_message(sub.agent_name, sub.result)
            self._emit_workflow(recorder, plan)
        return "\n\n".join(trajectory_parts)

    async def report(self, task: str, trajectory: str, recorder: TaskRecorder) -> str:
        prompt = REPORTER_PROMPT.format(question=task, trajectory=trajectory)
        resp = await self.reporter_client.chat([ChatMessage("user", prompt)])
        answer = resp.message.content or ""
        recorder.emit(AgentEvent("report", text=answer))
        return answer

    async def run(self, task: str) -> TaskRecorder:
        recorder = self.run_streamed(task)
        async for _ in recorder.stream_events():
            pass
        return await recorder.wait()

    def run_streamed(self, task: str) -> TaskRecorder:
        import asyncio

        recorder = TaskRecorder(task=task)

        async def go():
            try:
                await self.build()
                plan = await self.plan(task, recorder)
                trajectory = await self.work(plan, recorder)
                answer = await self.report(task, trajectory, recorder)
                recorder.set_final_output(answer)
                recorder.emit(AgentEvent("final", text=answer))
                recorder.finish()
            except Exception as e:  # noqa: BLE001
                logger.exception("orchestra run failed")
                recorder.emit(AgentEvent("error", text=str(e)))
                recorder.finish(error=str(e))

        # handle on the recorder: stream consumers cancel abandoned
        # runs (client disconnect) via recorder.run_task
        recorder.run_task = asyncio.ensure_future(go())
        return recorder
