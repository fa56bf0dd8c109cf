"""Persistence record types: a copy of ``youtu_rag_tpu/db/models.py``.

Parity with the reference's SQLModel rows (``utu/db/trajectory_model.py:12-171``,
``utu/db/tracing_model.py``, ``utu/db/eval_datapoint.py``) as plain
dataclasses serialized to sqlite by DBService — no SQLAlchemy
dependency."""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field
from typing import Any


@dataclass
class TrajectoryRecord:
    """One agent run (ref: TrajectoryModel.from_task_recorder)."""

    trace_id: str
    input: str
    output: str | None = None
    trajectory: list[dict] = field(default_factory=list)
    tool_calls: list[dict] = field(default_factory=list)
    usage_input_tokens: int = 0
    usage_output_tokens: int = 0
    error: str | None = None
    agent_type: str = "simple"
    created_at: float = field(default_factory=time.time)

    @classmethod
    def from_recorder_dict(cls, rec: dict[str, Any], agent_type: str = "simple") -> "TrajectoryRecord":
        usage = rec.get("usage") or {}
        return cls(
            trace_id=rec.get("trace_id", ""),
            input=rec.get("input", ""),
            output=rec.get("output"),
            trajectory=rec.get("trajectory", []),
            tool_calls=rec.get("tool_calls", []),
            usage_input_tokens=usage.get("input_tokens", 0),
            usage_output_tokens=usage.get("output_tokens", 0),
            error=rec.get("error"),
            agent_type=agent_type,
            created_at=rec.get("created_at", time.time()),
        )


@dataclass
class ToolTraceRecord:
    """Per-tool-call span row (ref: ToolTracingModel)."""

    trace_id: str
    span_id: str
    name: str
    arguments: str
    output: str
    duration_ms: float
    created_at: float = field(default_factory=time.time)


@dataclass
class GenerationTraceRecord:
    """Per-LLM-call span row (ref: GenerationTracingModel)."""

    trace_id: str
    span_id: str
    model: str
    input_messages: list[dict] = field(default_factory=list)
    output: str | None = None
    input_tokens: int = 0
    output_tokens: int = 0
    duration_ms: float = 0.0
    created_at: float = field(default_factory=time.time)


@dataclass
class EvaluationSample:
    """One benchmark datapoint through its lifecycle
    (ref: EvaluationSample / DatasetSample in eval_datapoint.py)."""

    dataset: str
    index: int
    source: str = ""
    raw_question: str = ""
    augmented_question: str = ""
    correct_answer: str = ""
    response: str | None = None
    time_cost: float = 0.0
    judged_response: str | None = None
    reward: float | None = None
    correct: bool | None = None
    level: str = ""  # difficulty bucket (XBench/BrowseComp level metrics)
    file_name: str = ""  # GAIA-style attachment path (resolved)
    confidence: int | None = None  # self-reported confidence 0-100
    stage: str = "init"  # init | rollout | judged
    exp_id: str = "default"
    created_at: float = field(default_factory=time.time)


def to_json_row(obj: Any) -> dict[str, Any]:
    d = asdict(obj)
    for k, v in d.items():
        if isinstance(v, (list, dict)):
            d[k] = json.dumps(v, ensure_ascii=False)
    return d
