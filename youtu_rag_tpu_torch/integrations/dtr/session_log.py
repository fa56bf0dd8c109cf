"""Structured per-run session trace for the Excel agent.

Parity surface: the reference's DTRLogger
(``integrations/DTR/src/core/dtr_logger.py:15-311``) — typed log entries
per module (ADO extraction, planning, operator execution, rewards, path
completion), JSON session dumps, an execution summary, and per-path
replay for debugging. Redesigned: one event list with module/action tags
instead of four parallel lists (the per-module views are filters at save
time), ids instead of wall-clock ordering, and no global logging-handler
mutation — the agent's module logger already narrates; this records.

The port's copy of ``youtu_rag_tpu/integrations/dtr/session_log.py``.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

__all__ = ["DTRSessionLog"]


@dataclass
class DTRSessionLog:
    """Append-only structured trace of one Excel-agent run."""

    session_id: str = ""
    events: list[dict[str, Any]] = field(default_factory=list)
    _path_counter: int = 0

    def __post_init__(self) -> None:
        if not self.session_id:
            # uuid suffix: second-resolution timestamps collide across quick
            # consecutive runs, and save() would overwrite the earlier trace
            import uuid

            self.session_id = f"{time.strftime('%Y%m%d_%H%M%S')}_{uuid.uuid4().hex[:6]}"

    # ------------------------------------------------------------ recording

    def log(self, module: str, action: str, **fields: Any) -> dict[str, Any]:
        entry = {"seq": len(self.events), "ts": time.time(), "module": module, "action": action}
        entry.update(fields)
        self.events.append(entry)
        return entry

    def new_path_id(self) -> str:
        """One id per plan execution (MCTS rollouts each get their own)."""
        self._path_counter += 1
        return f"path_{self._path_counter}"

    def log_query(self, question: str, file_path: str, planner: str) -> None:
        self.log("agent", "query", question=question, file_path=file_path, planner=planner)

    def log_operator_extraction(self, question: str, operators: list[str]) -> None:
        # ref dtr_logger.log_ado_extraction:83-104
        self.log("ADO", "extract_operators", question=question,
                 operators=list(operators), operators_count=len(operators))

    def log_plan(self, planner: str, steps: list[str], **extra: Any) -> None:
        # ref dtr_logger.log_mcts_planning:105-135 (generalized to all planners)
        self.log("planner", "plan", planner=planner, steps=list(steps), **extra)

    def log_operator_execution(
        self, path_id: str, step: int, description: str, code: str,
        output: str, success: bool, reward: float, attempts: int,
    ) -> None:
        # ref dtr_logger.log_operator_execution:136-171
        self.log(
            "SMG", "execute_operator", path_id=path_id, step=step,
            description=description, code=code[:2000], output=output[:800],
            success=bool(success), reward=float(reward), attempts=int(attempts),
        )

    def log_path_completion(
        self, path_id: str, plan: list[str], cumulative_reward: float,
        stopped: bool = False, stop_reason: str = "",
    ) -> None:
        # ref dtr_logger.log_path_completion:200-225
        self.log(
            "SMG", "path_complete", path_id=path_id, plan=list(plan),
            cumulative_reward=float(cumulative_reward),
            execution_stopped=bool(stopped), stop_reason=stop_reason,
        )

    def log_recovery(self, rung: str, reason: str, replaced: bool) -> None:
        self.log("answer", "recovery", rung=rung, reason=reason, replaced=bool(replaced))

    def log_answer(self, answer: str, llm_calls: int, tokens: int) -> None:
        self.log("agent", "answer", answer=answer[:2000],
                 llm_calls=int(llm_calls), tokens=int(tokens))

    # ----------------------------------------------------------- inspection

    def _ops(self) -> list[dict[str, Any]]:
        return [e for e in self.events if e["action"] == "execute_operator"]

    def summary(self) -> dict[str, Any]:
        """ref dtr_logger.get_execution_summary:254-280."""
        ops = self._ops()
        ok = sum(1 for e in ops if e["success"])
        total_reward = sum(e["reward"] for e in ops)
        paths = [e for e in self.events if e["action"] == "path_complete"]
        return {
            "session_id": self.session_id,
            "total_operators": len(ops),
            "successful_operators": ok,
            "failed_operators": len(ops) - ok,
            "success_rate": ok / len(ops) if ops else 0.0,
            "total_reward": round(total_reward, 4),
            "average_reward": round(total_reward / len(ops), 4) if ops else 0.0,
            "paths_executed": len(paths),
            "recoveries": sum(1 for e in self.events if e["action"] == "recovery"),
        }

    def replay_path(self, path_id: str) -> list[dict[str, Any]]:
        """Ordered operator executions of one path (ref :281-292)."""
        return sorted(
            (e for e in self._ops() if e.get("path_id") == path_id),
            key=lambda e: (e.get("step", 0), e["seq"]),
        )

    # ---------------------------------------------------------- persistence

    def save(self, log_dir: str | Path) -> Path:
        """Write the session JSON (full trace + summary + per-module views,
        one file — ref :227-252 writes four)."""
        out_dir = Path(log_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        out = out_dir / f"session_{self.session_id}.json"
        doc = {
            "summary": self.summary(),
            "events": self.events,
            "views": {
                "operators": self._ops(),
                "paths": [e for e in self.events if e["action"] == "path_complete"],
                "plans": [e for e in self.events if e["action"] == "plan"],
            },
        }
        out.write_text(json.dumps(doc, indent=2, ensure_ascii=False, default=str))
        return out
