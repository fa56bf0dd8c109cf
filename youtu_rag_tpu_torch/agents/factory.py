"""Agent factory: a copy of ``youtu_rag_tpu/agents/factory.py``'s
``get_agent``.

``simple``, ``llm``, the orchestrator types (``orchestra``,
``orchestra_react_sql``, ``orchestrator``, ``parallel_orchestrator``,
``workforce``) and ``excel`` (the deep-table-reasoning ``ExcelAgent``,
``integrations/dtr/``) are served. Keyword arguments reach
the agent's constructor (``client=``, ``toolkits=``, ``workers=``, ...);
``device=`` is the port's device seam, which every agent type takes and
hands to the workers, clients and stores it builds (``None``: the CUDA
card)."""

from __future__ import annotations

from .config import AgentConfig
from .llm_agent import LLMAgent
from .simple_agent import SimpleAgent

ORCHESTRATOR_TYPES = ("orchestra", "orchestra_react_sql", "orchestrator", "parallel_orchestrator",
                      "workforce")


def get_agent(config: AgentConfig | dict, **kwargs):
    if isinstance(config, dict):
        config = AgentConfig.from_dict(config)
    t = config.type
    if t == "simple":
        return SimpleAgent(config, **kwargs)
    if t == "llm":
        return LLMAgent(config, **kwargs)
    if t == "orchestra":
        from .orchestra import OrchestraAgent

        return OrchestraAgent(config, **kwargs)
    if t == "orchestra_react_sql":
        # plan → text2sql worker → report (ref: OrchestraReactSqlAgent,
        # utu/rag/rag_agents/orchestra_react_text2sql.py:37-540)
        from .orchestra import OrchestraAgent

        workers = kwargs.pop("workers", None)
        if workers is None:
            from ..tools.base import ToolkitConfig
            from ..tools.text2sql import Text2SQLToolkit, Text2SQLWorkerAgent

            tk_cfg = config.toolkits.get("text2sql") or ToolkitConfig(name="text2sql")
            # the worker drives the full link → generate → execute (with
            # error retry) → answer pipeline — the reference's orchestra
            # workers ARE Text2sqlAgents, not free-form tool loops
            worker = Text2SQLWorkerAgent(
                Text2SQLToolkit(tk_cfg),
                LLMAgent(model=config.model, client=kwargs.get("client"),
                         device=kwargs.get("device")),
            )
            workers = {"text2sql": worker}
        config.workers_info = config.workers_info or [
            {
                "name": "text2sql",
                "desc": "queries structured tables with SQL",
                "strengths": "aggregation, filtering, joins over spreadsheet/DB data",
                "weaknesses": "free-text questions without structured data",
            }
        ]
        return OrchestraAgent(config, workers=workers, **kwargs)
    if t == "orchestrator":
        from .orchestrator import OrchestratorAgent

        return OrchestratorAgent(config, **kwargs)
    if t == "parallel_orchestrator":
        from .orchestrator import ParallelOrchestratorAgent

        return ParallelOrchestratorAgent(config, **kwargs)
    if t == "workforce":
        from .workforce import WorkforceAgent

        return WorkforceAgent(config, **kwargs)
    if t == "excel":
        # deep-table-reasoning agent (ref: _create_agent_instance maps
        # ExcelAgent as a first-class chat agent, api/dependencies.py)
        from ..integrations.dtr.excel_agent import ExcelAgent

        kwargs.pop("trajectory_sink", None)  # recorder-only agent
        return ExcelAgent(config, **kwargs)
    raise ValueError(f"unknown agent type {t!r}")
