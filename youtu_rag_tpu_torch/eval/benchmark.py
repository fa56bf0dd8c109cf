"""Benchmark harness: preprocess → rollout → judge → stat.

Parity with ``utu/eval/benchmarks/base_benchmark.py:16-185``: staged main()
with semaphore-bounded rollout concurrency, per-sample exception isolation,
DB persistence of sample lifecycle, judge concurrency, aggregate stats.

The port's copy of ``youtu_rag_tpu/eval/benchmark.py``. ``device`` reaches
the agent that ``get_agent`` builds from the config and the LLM judge
(a local model, a memory store or a KB on it); ``None`` is the CUDA card.
"""

from __future__ import annotations

import asyncio
import json
import time
from pathlib import Path
from typing import Any

from ..agents.factory import get_agent
from ..agents.llm_agent import LLMAgent
from ..db.models import EvaluationSample
from ..db.service import DBService
from ..utils.log import get_logger
from .config import EvalConfig
from .processor import ProcessorFactory

logger = get_logger("eval.benchmark")


class BaseBenchmark:
    def __init__(self, config: EvalConfig, agent=None, judge_agent=None, db: DBService | None = None,
                 device=None):
        self.config = config
        self._agent = agent
        self.device = device
        self.db = db or DBService(config.db_url)
        judge = judge_agent
        if judge is None and config.processor in ("llm_judge", "xbench", "browsecomp", "webwalker"):
            judge = LLMAgent(model=config.judge_model, device=device)
        self.processor = ProcessorFactory.create(config.processor, judge)

    # -- stages ------------------------------------------------------------

    def load_samples(self) -> list[EvaluationSample]:
        src = self.config.data.source
        samples: list[EvaluationSample] = []
        if src and not Path(src).exists():
            # a typo'd source must not masquerade as a 0%-accuracy run
            raise FileNotFoundError(f"benchmark data source not found: {src}")
        if src and Path(src).exists():
            for i, line in enumerate(Path(src).read_text().strip().split("\n")):
                if not line.strip():
                    continue
                d = json.loads(line)
                s = EvaluationSample(
                    dataset=self.config.data.dataset,
                    index=i,
                    source=src,
                    raw_question=d.get("question") or d.get("query") or "",
                    correct_answer=str(d.get("answer") or d.get("correct_answer") or ""),
                    level=str(d.get("level", "")),
                    exp_id=self.config.exp_id,
                )
                if d.get("file_name"):
                    # GAIA-style attachment (the reference carries it in the
                    # sample dict, utu/eval/processer). Relative paths
                    # resolve against the dataset file's directory.
                    s.file_name = str(Path(src).parent / d["file_name"])
                samples.append(s)
        return samples

    def preprocess(self, samples: list[EvaluationSample]) -> list[EvaluationSample]:
        return [self.processor.preprocess(s) for s in samples]

    async def rollout(self, samples: list[EvaluationSample]) -> list[EvaluationSample]:
        agent = self._agent
        if agent is None:
            agent = get_agent(self.config.agent, device=self.device)
        sem = asyncio.Semaphore(self.config.concurrency)

        async def one(s: EvaluationSample) -> None:
            async with sem:
                t0 = time.perf_counter()
                try:
                    if hasattr(agent, "run"):
                        result = await agent.run(s.augmented_question)
                        # never str(recorder): a run without final_output
                        # must judge as empty, not as the object repr
                        s.response = getattr(result, "final_output", None) or (
                            result if isinstance(result, str) else None
                        )
                    s.stage = "rollout"
                except Exception as e:  # noqa: BLE001 - per-sample isolation
                    logger.exception("rollout failed for sample %d", s.index)
                    s.response = None
                    s.stage = "rollout"
                    s.judged_response = f"rollout error: {e}"
                s.time_cost = time.perf_counter() - t0
                self.db.add(s)

        await asyncio.gather(*(one(s) for s in samples))
        return samples

    async def judge(self, samples: list[EvaluationSample]) -> list[EvaluationSample]:
        sem = asyncio.Semaphore(self.config.judge_concurrency)

        async def one(s: EvaluationSample) -> None:
            async with sem:
                try:
                    await self.processor.judge(s)
                except Exception:  # noqa: BLE001
                    logger.exception("judge failed for sample %d", s.index)
                    s.correct = False
                    s.stage = "judged"
                # UPDATE the rollout row (keyed by exp_id+index) — a second
                # add() duplicated every sample per run, double-counting
                # any DB-side consumer; fall back to add when the rollout
                # stage skipped DB persistence
                n = self.db.update(
                    type(s),
                    {"exp_id": s.exp_id, "index": s.index},
                    {
                        "stage": s.stage,
                        "correct": s.correct,
                        "reward": s.reward,
                        "judged_response": s.judged_response,
                        "confidence": s.confidence,
                    },
                )
                if n == 0:
                    self.db.add(s)

        await asyncio.gather(*(one(s) for s in samples))
        return samples

    def stat(self, samples: list[EvaluationSample]) -> dict[str, Any]:
        stats = self.processor.stat(samples)
        stats["exp_id"] = self.config.exp_id
        stats["dataset"] = self.config.data.dataset
        return stats

    async def main(self, samples: list[EvaluationSample] | None = None) -> dict[str, Any]:
        samples = samples if samples is not None else self.load_samples()
        samples = self.preprocess(samples)
        await self.rollout(samples)
        await self.judge(samples)
        stats = self.stat(samples)
        logger.info("eval %s: %s", self.config.exp_id, stats)
        return stats
