"""Agent configuration models: a copy of ``youtu_rag_tpu/agents/config.py``
(type-dispatched ``AgentConfig`` with profile, model, toolkits, env,
memory and the orchestrators' sections; ``ModelConfig`` resolves
YRT_LLM_* / UTU_LLM_* lazily). ``provider: "local"`` serves the causal-LM
checkpoint at ``weights_dir`` (``agents/local_llm.py``). The device is not
a config field: ``get_chat_client`` takes it."""

from __future__ import annotations

import os
from typing import Any, Literal

from pydantic import Field

from ..core.config import ConfigBase
from ..tools.base import ToolkitConfig

DEFAULT_INSTRUCTIONS = "You are a helpful assistant."


class ModelConfig(ConfigBase):
    """Flattened model provider+params (ref splits provider/settings/params)."""

    type: Literal["chat.completions", "responses"] = "chat.completions"
    # "remote" = OpenAI-compatible HTTP (the reference's only mode);
    # "local"  = the in-process decoder (agents/local_llm.py) serving the
    #            causal-LM checkpoint at weights_dir
    provider: Literal["remote", "local"] = "remote"
    model: str | None = None
    base_url: str | None = None
    api_key: str | None = None
    temperature: float | None = None
    top_p: float | None = None
    max_tokens: int | None = None
    parallel_tool_calls: bool | None = None
    # provider "local": directory with config.json + model.safetensors +
    # tokenizer.json (HF export of a gpt2/llama/mistral/qwen2 model)
    weights_dir: str | None = None
    chat_template: str | None = None  # plain | chatml | llama (auto if None)

    def resolved(self) -> "ModelConfig":
        return self.model_copy(
            update={
                "model": self.model or os.environ.get("YRT_LLM_MODEL") or os.environ.get("UTU_LLM_MODEL"),
                "base_url": self.base_url
                or os.environ.get("YRT_LLM_BASE_URL")
                or os.environ.get("UTU_LLM_BASE_URL"),
                "api_key": self.api_key
                or os.environ.get("YRT_LLM_API_KEY")
                or os.environ.get("UTU_LLM_API_KEY"),
            }
        )


class ProfileConfig(ConfigBase):
    name: str | None = "default"
    instructions: str | None = DEFAULT_INSTRUCTIONS


class ContextManagerConfig(ConfigBase):
    name: str | None = None
    config: dict = Field(default_factory=dict)


class EnvConfig(ConfigBase):
    name: str | None = None
    config: dict = Field(default_factory=dict)


class MemoryConfig(ConfigBase):
    """Memory injection knobs for SimpleAgent (ref: simple_agent.py:99-171)."""

    enabled: bool = False
    user_id: str = "default"
    max_context_items: int = 8


class AgentConfig(ConfigBase):
    type: Literal[
        "simple",
        "llm",
        "orchestra",
        "orchestra_react_sql",
        "orchestrator",
        "parallel_orchestrator",
        "workforce",
        "excel",  # DTR deep-table-reasoning agent (integrations/dtr)
    ] = "simple"

    model: ModelConfig = Field(default_factory=ModelConfig)
    agent: ProfileConfig = Field(default_factory=ProfileConfig)
    context_manager: ContextManagerConfig = Field(default_factory=ContextManagerConfig)
    env: EnvConfig = Field(default_factory=EnvConfig)
    toolkits: dict[str, ToolkitConfig] = Field(default_factory=dict)
    memory: MemoryConfig = Field(default_factory=MemoryConfig)
    max_turns: int = 50

    # orchestra (plan -> work -> report)
    planner_model: ModelConfig = Field(default_factory=ModelConfig)
    planner_config: dict = Field(default_factory=dict)
    workers: dict[str, "AgentConfig"] = Field(default_factory=dict)
    workers_info: list[dict] = Field(default_factory=list)
    reporter_model: ModelConfig = Field(default_factory=ModelConfig)
    reporter_config: dict = Field(default_factory=dict)

    # orchestrator (chain planner)
    orchestrator_config: dict = Field(default_factory=dict)
    orchestrator_model: ModelConfig = Field(default_factory=ModelConfig)
    orchestrator_workers: dict[str, "AgentConfig"] = Field(default_factory=dict)
    orchestrator_workers_info: list[dict] = Field(default_factory=list)

    # parallel orchestrator
    max_parallel: int = 4
    task_timeout: float = 300.0

    # workforce
    workforce_planner_model: ModelConfig = Field(default_factory=ModelConfig)
    workforce_assigner_model: ModelConfig = Field(default_factory=ModelConfig)
    workforce_answerer_model: ModelConfig = Field(default_factory=ModelConfig)
    workforce_executor_agents: dict[str, "AgentConfig"] = Field(default_factory=dict)
    workforce_executor_infos: list[dict] = Field(default_factory=list)

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "AgentConfig":
        return cls.model_validate(data)


AgentConfig.model_rebuild()
