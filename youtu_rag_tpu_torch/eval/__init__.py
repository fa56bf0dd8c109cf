"""Evaluation configuration (``EvalConfig``), which ``core/loader.py``'s
``load_eval_config`` validates into. The benchmark runners and processors
of the JAX package's ``eval/`` are not ported yet."""

from .config import EvalConfig, EvalDataConfig

__all__ = ["EvalConfig", "EvalDataConfig"]
