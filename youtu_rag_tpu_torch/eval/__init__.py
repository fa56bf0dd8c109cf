"""Evaluation: the configuration, the benchmark harness, its answer
processors and the retrieval metrics (``retrieval_eval.py``); the port's
copy of ``youtu_rag_tpu/eval/``."""

from .config import EvalConfig, EvalDataConfig
from .benchmark import BaseBenchmark
from .processor import ProcessorFactory, BaseProcessor, ExactMatchProcessor, LLMJudgeProcessor

__all__ = [
    "BaseBenchmark",
    "BaseProcessor",
    "EvalConfig",
    "EvalDataConfig",
    "ExactMatchProcessor",
    "LLMJudgeProcessor",
    "ProcessorFactory",
]
