"""Eval configuration (parity: utu/config/eval_config.py:24-47).

The port's copy of ``youtu_rag_tpu/eval/config.py``.
"""

from __future__ import annotations

from pydantic import Field

from ..agents.config import AgentConfig, ModelConfig
from ..core.config import ConfigBase


class EvalDataConfig(ConfigBase):
    dataset: str = "demo"
    source: str = ""  # file path (jsonl with question/answer) or builtin name
    type: str = "qa"


class EvalConfig(ConfigBase):
    exp_id: str = "default"
    data: EvalDataConfig = Field(default_factory=EvalDataConfig)
    agent: AgentConfig = Field(default_factory=AgentConfig)
    processor: str = "exact_match"  # exact_match | llm_judge
    judge_model: ModelConfig = Field(default_factory=ModelConfig)
    concurrency: int = 4
    judge_concurrency: int = 8
    pass_k: int = 1
    db_url: str | None = None
