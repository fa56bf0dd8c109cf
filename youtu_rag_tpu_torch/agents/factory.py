"""Agent factory: a copy of ``youtu_rag_tpu/agents/factory.py``'s
``get_agent``.

``simple`` and ``llm`` are served. The orchestrator types (``orchestra``,
``orchestra_react_sql``, ``orchestrator``, ``parallel_orchestrator``,
``workforce``) wait for ROADMAP Queue A 6.2 and ``excel`` for the
deep-table-reasoning integration; each raises ``NotImplementedError``.
Keyword arguments reach the agent's constructor (``client=``,
``toolkits=``, ``device=`` for ``SimpleAgent``, ...)."""

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
    if t in ORCHESTRATOR_TYPES:
        raise NotImplementedError(
            f"agent type {t!r}: the orchestrators are not ported yet (ROADMAP Queue A 6.2)")
    if t == "excel":
        raise NotImplementedError(
            "agent type 'excel': the deep-table-reasoning integration (integrations/dtr) "
            "is not ported yet")
    raise ValueError(f"unknown agent type {t!r}")
