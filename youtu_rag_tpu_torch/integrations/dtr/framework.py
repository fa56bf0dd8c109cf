"""DTR framework facade — one entry point over the full pipeline.

Capability counterpart of the reference's ``DTRFramework``
(``integrations/DTR/src/core/dtr_framework.py:26-695``): schema linking →
ADO operator extraction → plan search → SMG execution → answer generation,
wrapped with the quality-control ladder (error-answer detection, retry
with replanning, direct-LLM fallback, extraction from the original table
— ref ``:292-440``) and per-run cost accounting (llm_calls / token stats,
ref ``:469-478``).

The pipeline itself lives in :class:`ExcelAgent` (this module does not
duplicate it); the framework owns the *session*: experience persistence
across queries (ref ``save_session/load_session:686-695``), memory stats,
and the structured result dict the reference's callers consume.

The port's copy of ``youtu_rag_tpu/integrations/dtr/framework.py``; its
``agent_kwargs`` reach the ``ExcelAgent``, ``device=`` among them.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

from ...agents.config import AgentConfig
from ...agents.llm import BaseChatClient
from ...utils.log import get_logger
from .excel_agent import ExcelAgent

logger = get_logger("dtr.framework")


class DTRFramework:
    """End-to-end deep-table-reasoning session.

    ``num_paths > 1`` selects the MCTS planner with that many parallel
    rollouts (ref ``execute_paths`` multi-path form); ``num_paths == 1``
    runs the linear planner (ref "Fast Mode: Single path execution").
    ``enable_multi_stage`` turns on the understand→align→generate code
    stages (ref ``enable_multi_stage``)."""

    def __init__(
        self,
        client: BaseChatClient | None = None,
        config: AgentConfig | None = None,
        *,
        num_paths: int = 1,
        enable_experience: bool = True,
        enable_multi_stage: bool = False,
        session_dir: str | None = None,
        **agent_kwargs: Any,
    ):
        self.session_dir = Path(session_dir) if session_dir else None
        if self.session_dir:
            self.session_dir.mkdir(parents=True, exist_ok=True)
        self._experience_path: Path | None = None
        if enable_experience and self.session_dir:
            self._experience_path = self.session_dir / "experience.json"
        self.agent = ExcelAgent(
            config,
            client=client,
            planner="mcts" if num_paths > 1 else "linear",
            mcts_parallel=max(num_paths, 1),
            code_mode="staged" if enable_multi_stage else "direct",
            experience_path=str(self._experience_path) if self._experience_path else None,
            **agent_kwargs,
        )

    async def process_query(self, user_query: str, file_path: str) -> dict[str, Any]:
        """Run one question end-to-end and return the structured result
        (ref ``process_query`` return contract ``:469-490``)."""
        recorder = await self.agent.run(user_query, file_path)
        # persist the structured run trace (ref dtr_logger session dumps)
        if self.session_dir and self.agent.last_session is not None:
            try:
                self.agent.last_session.save(self.session_dir / "traces")
            except OSError:
                logger.exception("session trace save failed")
        smg = self.agent.last_smg
        nodes = list(smg.nodes) if smg is not None else []
        execution_trace = [
            {
                "operation": n.description,
                "code": n.code,
                "success": n.success,
                "error": None if n.success else (n.output or "")[-300:] or None,
                "reward": n.reward,
            }
            for n in nodes
        ]
        logs = list(recorder.trajectory)
        usage = self.agent.usage
        return {
            "final_answer": recorder.final_output,
            "execution_trace": execution_trace,
            "memory_nodes": nodes,
            "best_path_id": "LINEAR" if self.agent.planner == "linear" else "MCTS_BEST",
            "memory_summary": smg.memory_summary() if smg is not None else {},
            "logs": logs,
            "error": recorder.error,
            "llm_calls": self.agent.llm_calls,
            "input_tokens": usage.input_tokens,
            "output_tokens": usage.output_tokens,
            "total_tokens": usage.input_tokens + usage.output_tokens,
            "session_summary": (
                self.agent.last_session.summary()
                if self.agent.last_session is not None
                else {}
            ),
        }

    # -- session persistence (ref save_session/load_session:686-695) -------

    def _session_path(self, session_id: str) -> Path:
        assert self.session_dir is not None, "DTRFramework needs session_dir for sessions"
        safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in session_id)
        return self.session_dir / f"session_{safe}.json"

    def save_session(self, session_id: str) -> None:
        """Persist the last run's operator experience under a session id."""
        smg = self.agent.last_smg
        if smg is None:
            logger.warning("no run to save for session %s", session_id)
            return
        smg.save_memory(self._session_path(session_id))

    def load_session(self, session_id: str) -> bool:
        """Prime the next runs with a saved session's experience (merges
        into the shared experience file the agent loads per run)."""
        path = self._session_path(session_id)
        if not path.exists():
            return False
        if self._experience_path is None:
            self._experience_path = path
            self.agent.experience_path = str(path)
            return True
        # merge the session into the live experience file via a scratch machine
        from .smg import SheetStateMachine

        scratch = SheetStateMachine("/nonexistent")
        if self._experience_path.exists():
            scratch.load_memory(self._experience_path)
        if not scratch.load_memory(path):
            return False
        scratch.save_memory(self._experience_path)
        return True

    # -- memory stats / reset (ref get_memory_stats/clear_memory:678-684) --

    def get_memory_stats(self) -> dict[str, Any]:
        smg = self.agent.last_smg
        return smg.memory_summary() if smg is not None else {"steps": 0}

    def clear_memory(self) -> None:
        if self._experience_path and self._experience_path.exists():
            self._experience_path.unlink()
        self.agent.last_smg = None
