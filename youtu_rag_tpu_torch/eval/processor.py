"""Benchmark processors: preprocess questions, judge answers.

Parity with ``utu/eval/processer/`` (GAIA/WebWalkerQA/XBench/BrowseComp
share a base LLM-judge processor): each processor augments the raw
question and judges a response into (reward, correct). ``exact_match`` is
the hermetic default; ``llm_judge`` uses an LLMAgent with the standard
judge template (ref prompts: utu/prompts/eval/judge_templates.yaml).

The port's copy of ``youtu_rag_tpu/eval/processor.py``.
"""

from __future__ import annotations

import json
import re
import string
from typing import Any

from ..db.models import EvaluationSample
from ..utils.log import get_logger

logger = get_logger("eval.processor")


class BaseProcessor:
    name = "base"

    def preprocess(self, sample: EvaluationSample) -> EvaluationSample:
        if not sample.augmented_question:
            q = sample.raw_question
            if sample.file_name:
                q = f"{q}\n\nAttached file: {sample.file_name}"
            sample.augmented_question = q
        return sample

    async def judge(self, sample: EvaluationSample) -> EvaluationSample:
        raise NotImplementedError

    def stat(self, samples: list[EvaluationSample]) -> dict[str, Any]:
        judged = [s for s in samples if s.correct is not None]
        correct = sum(1 for s in judged if s.correct)
        return {
            "total": len(samples),
            "judged": len(judged),
            "correct": correct,
            "accuracy": correct / len(judged) if judged else 0.0,
            "avg_time_cost": (
                sum(s.time_cost for s in judged) / len(judged) if judged else 0.0
            ),
        }


def _normalize(text: str) -> str:
    text = text.lower().strip()
    text = text.translate(str.maketrans("", "", string.punctuation))
    return re.sub(r"\s+", " ", text)


class ExactMatchProcessor(BaseProcessor):
    """Normalized exact/containment match — deterministic."""

    name = "exact_match"

    async def judge(self, sample: EvaluationSample) -> EvaluationSample:
        resp = _normalize(sample.response or "")
        gold = _normalize(sample.correct_answer)
        # word-boundary containment: a raw substring check scores gold
        # 'no' correct inside "i dont know", inflating accuracy
        contained = bool(gold) and bool(
            re.search(rf"(?<![\w]){re.escape(gold)}(?![\w])", resp)
        )
        sample.correct = bool(gold) and (resp == gold or contained)
        sample.reward = 1.0 if sample.correct else 0.0
        sample.stage = "judged"
        return sample


JUDGE_TEMPLATE = """Judge whether the model response answers the question \
correctly given the reference answer.

Question: {question}
Reference answer: {answer}
Model response: {response}

Reply with JSON only: {{"correct": true|false, "reasoning": "..."}}"""


class LLMJudgeProcessor(BaseProcessor):
    """LLM-as-judge (ref: base_llm_processor judge flow)."""

    name = "llm_judge"

    def __init__(self, judge_agent):
        self.judge_agent = judge_agent

    async def judge(self, sample: EvaluationSample) -> EvaluationSample:
        prompt = JUDGE_TEMPLATE.format(
            question=sample.augmented_question or sample.raw_question,
            answer=sample.correct_answer,
            response=sample.response or "",
        )
        raw = await self.judge_agent.run(prompt)
        sample.judged_response = raw
        try:
            data = json.loads(raw[raw.index("{") : raw.rindex("}") + 1])
            sample.correct = bool(data.get("correct"))
        except (ValueError, json.JSONDecodeError):
            logger.warning("unparseable judge output: %r", raw[:200])
            sample.correct = False
        sample.reward = 1.0 if sample.correct else 0.0
        sample.stage = "judged"
        return sample


class GaiaProcessor(BaseProcessor):
    """GAIA-style: file-attachment question augmentation + the benchmark's
    answer normalization (numbers stripped of units/commas, lists compared
    element-wise) — the scoring rules of the reference's GAIA processer."""

    name = "gaia"

    def preprocess(self, sample: EvaluationSample) -> EvaluationSample:
        q = sample.raw_question
        file_path = sample.file_name or None
        if not file_path and sample.source and not sample.source.endswith((".jsonl", ".json")):
            file_path = sample.source
        try:
            meta = json.loads(sample.augmented_question) if sample.augmented_question else {}
            if isinstance(meta, dict):  # '123'/'[1]' parse fine but aren't metadata
                file_path = meta.get("file_name") or file_path
        except (json.JSONDecodeError, TypeError):
            pass
        if file_path:
            q = f"{q}\n\nAttached file: {file_path}"
        sample.augmented_question = (
            f"{q}\n\nReport your answer as a number or as few words as possible; "
            "do not use articles or abbreviations."
        )
        return sample

    @staticmethod
    def _norm_number(s: str) -> float | None:
        t = re.sub(r"[,$%\s]", "", s)
        try:
            return float(t)
        except ValueError:
            return None

    @classmethod
    def _norm(cls, s: str) -> str:
        return _normalize(s)

    async def judge(self, sample: EvaluationSample) -> EvaluationSample:
        resp = (sample.response or "").strip()
        gold = sample.correct_answer.strip()
        # numeric check FIRST: '1,000' is a thousands-separated number,
        # not a two-element list (the reference GAIA scorer does the same)
        if self._norm_number(gold) is not None:
            ok = self._match_one(resp, gold)
        elif "," in gold:
            golds = [g.strip() for g in gold.split(",")]
            resps = [r.strip() for r in resp.split(",")]
            ok = len(golds) == len(resps) and all(
                self._match_one(r, g) for r, g in zip(resps, golds)
            )
        else:
            ok = self._match_one(resp, gold)
        sample.correct = ok
        sample.reward = 1.0 if ok else 0.0
        sample.stage = "judged"
        return sample

    @classmethod
    def _match_one(cls, resp: str, gold: str) -> bool:
        gn = cls._norm_number(gold)
        if gn is not None:
            for tok in re.findall(r"[-+]?[\d.,]+", resp):
                rn = cls._norm_number(tok)
                if rn is not None and abs(rn - gn) < 1e-6:
                    return True
            return False
        return cls._norm(gold) != "" and cls._norm(gold) in cls._norm(resp)


class WebWalkerProcessor(LLMJudgeProcessor):
    """WebWalkerQA-style: browsing questions judged by an LLM with the
    reference-answer template (judge_templates.yaml pattern)."""

    name = "webwalker"

    def preprocess(self, sample: EvaluationSample) -> EvaluationSample:
        sample.augmented_question = (
            f"{sample.raw_question}\n\nUse web tools to browse for the answer "
            "and respond concisely."
        )
        return sample


def _parse_field(text: str, key: str) -> str:
    """Extract a `key: value` line from field-structured judge output
    (tolerates bold markers and multi-line values up to the next field)."""
    cleaned = text.replace("**", "")
    m = re.search(rf"{key}\s*[:：]\s*(.*?)(?=\n\s*\S+\s*[:：]|\Z)", cleaned, re.DOTALL)
    return m.group(1).strip() if m else ""


def _overall_metrics(samples: list[EvaluationSample]) -> dict[str, Any]:
    total = len(samples)
    invalid = sum(1 for s in samples if s.judged_response == "invalid")
    correct = sum(1 for s in samples if s.correct)
    return {
        "accuracy_pct": round(correct / total * 100, 2) if total else 0.0,
        "details": {
            "correct": correct,
            "wrong": total - correct - invalid,
            "unknown": invalid,
            "total": total,
        },
    }


def _level_metrics(samples: list[EvaluationSample]) -> dict[str, Any]:
    bins: dict[str, dict[str, Any]] = {}
    for s in samples:
        b = bins.setdefault(s.level or "default", {"correct": 0, "wrong": 0, "unknown": 0})
        if s.judged_response == "invalid":
            b["unknown"] += 1
        elif s.correct:
            b["correct"] += 1
        else:
            b["wrong"] += 1
    for b in bins.values():
        n = b["correct"] + b["wrong"]
        b["accuracy"] = round(b["correct"] / n * 100, 4) if n else 0.0
    return {"level_metrics": bins}


def _calibration_error(samples: list[EvaluationSample]) -> float:
    """Expected calibration error over 20-point confidence bins."""
    bins = [{"n": 0, "correct": 0, "conf": 0} for _ in range(5)]
    total = 0
    for s in samples:
        if s.judged_response == "invalid":
            continue
        conf = s.confidence if s.confidence is not None else 0
        b = bins[min(conf // 20, 4)]
        b["n"] += 1
        b["conf"] += conf
        b["correct"] += 1 if s.correct else 0
        total += 1
    err = 0.0
    for b in bins:
        if not b["n"]:
            continue
        acc = b["correct"] / b["n"]
        avg_conf = b["conf"] / b["n"] / 100
        err += (b["n"] / max(total, 1)) * abs(acc - avg_conf)
    return round(err * 100, 2)


BROWSECOMP_AUG = """{question}

Your response should be in the following format:
Explanation: {{your explanation for your final answer}}
Exact Answer: {{your succinct, final answer}}
Confidence: {{your confidence score between 0% and 100% for your answer}}"""

BROWSECOMP_JUDGE = """Judge whether the following [response] to [question] \
is correct or not based on the precise and unambiguous [correct_answer] below.

[question]: {question}

[response]: {response}

[correct_answer]: {answer}

Your judgement must be in the format and criteria specified below:

extracted_final_answer: The final exact answer extracted from the [response], \
or 'None' if there is no exact final answer to extract.

reasoning: Explain, focusing only on whether there are meaningful differences \
between [correct_answer] and the extracted_final_answer. Do not solve the \
problem or argue for a different answer.

correct: Answer 'yes' if extracted_final_answer matches the [correct_answer], \
or is within a small margin of error for numerical problems; 'no' otherwise.

confidence: The confidence score between 0% and 100% extracted from \
[response], or 100 if none is stated."""


class BrowseCompProcessor(LLMJudgeProcessor):
    """BrowseComp: structured Explanation/Exact Answer/Confidence responses
    judged with the simple-evals-style field grader; stats add level
    buckets and calibration error (ref: utu/eval/processer/browse_comp.py,
    judge/augmentation templates in utu/prompts/eval/*.yaml)."""

    name = "browsecomp"

    def preprocess(self, sample: EvaluationSample) -> EvaluationSample:
        sample.augmented_question = BROWSECOMP_AUG.format(question=sample.raw_question)
        return sample

    async def judge(self, sample: EvaluationSample) -> EvaluationSample:
        raw = await self.judge_agent.run(
            BROWSECOMP_JUDGE.format(
                question=sample.raw_question,
                response=sample.response or "",
                answer=sample.correct_answer,
            )
        )
        sample.judged_response = raw
        verdict = _parse_field(raw, "correct").lower()
        # prefix match: judges elaborate ("yes, the answer matches") —
        # exact equality scored every elaborated verdict as invalid/wrong
        if verdict.startswith("yes"):
            sample.correct = True
        elif verdict.startswith("no"):
            sample.correct = False
        else:
            sample.judged_response = f"invalid verdict: {raw[:200]}"
            sample.correct = False
        conf = re.search(r"(\d{1,3})\s*%", _parse_field(raw, "confidence") or (sample.response or ""))
        sample.confidence = min(int(conf.group(1)), 100) if conf else 100
        sample.reward = 1.0 if sample.correct else 0.0
        sample.stage = "judged"
        return sample

    def stat(self, samples: list[EvaluationSample]) -> dict[str, Any]:
        return {
            **super().stat(samples),
            **_overall_metrics(samples),
            **_level_metrics(samples),
            "calibration_error_pct": _calibration_error(samples),
        }


XBENCH_AUG = """你是一个通用人工智能助手。我将向你提出一个学术问题, 请尽可能简洁地给出解题思路, \
并用以下模版作为回答的结尾:

最终答案:[你的答案]

不要在最终答案周围添加任何多余的符号, 在同一行中完成回答; 答案必须是尽可能简洁的数值、短语或数学表达式; \
如果答案有多个, 使用逗号将它们隔开。

[问题]: {question}"""

XBENCH_JUDGE = """你是一个通用人工智能助手。根据下面给出的[正确答案], 判断以下对[原问题]的[回答]是否正确。

[原问题]: {question}

[正确答案]: {answer}

[回答]: {response}

你的判断必须按照以下格式和标准进行:

最终答案: 从[回答]中提取出的最终准确答案, 没有明确答案则填写'无'。

解释: 只关注[最终答案]与[正确答案]之间是否存在实质性差异, 不要重新解题。

结论: 一致(或数值题在微小误差范围内)填写'正确'; 否则填写'错误'。"""


class XBenchProcessor(LLMJudgeProcessor):
    """XBench (Chinese academic QA): 最终答案/解释/结论 structured judging
    with per-level accuracy (ref: utu/eval/processer/xbench.py)."""

    name = "xbench"

    def preprocess(self, sample: EvaluationSample) -> EvaluationSample:
        sample.augmented_question = XBENCH_AUG.format(question=sample.raw_question)
        return sample

    async def judge(self, sample: EvaluationSample) -> EvaluationSample:
        raw = await self.judge_agent.run(
            XBENCH_JUDGE.format(
                question=sample.raw_question,
                answer=sample.correct_answer,
                response=sample.response or "",
            )
        )
        sample.judged_response = raw
        verdict = _parse_field(raw, "结论")
        if verdict.startswith("正确"):
            sample.correct = True
        elif verdict.startswith("错误"):
            sample.correct = False
        else:
            sample.judged_response = "invalid"
            sample.correct = False
        sample.confidence = 100 if sample.correct else 0
        sample.reward = 1.0 if sample.correct else 0.0
        sample.stage = "judged"
        return sample

    def stat(self, samples: list[EvaluationSample]) -> dict[str, Any]:
        return {**super().stat(samples), **_overall_metrics(samples), **_level_metrics(samples)}


class ProcessorFactory:
    """Ref: utu/eval/processer/__init__.py:4-10 (GAIA/WebWalkerQA/XBench/
    BrowseComp)."""

    @staticmethod
    def create(name: str, judge_agent=None) -> BaseProcessor:
        if name == "exact_match":
            return ExactMatchProcessor()
        if name == "gaia":
            return GaiaProcessor()
        if name == "llm_judge":
            assert judge_agent is not None, f"{name} needs a judge agent"
            return LLMJudgeProcessor(judge_agent)
        if name == "xbench":
            assert judge_agent is not None, "xbench needs a judge agent"
            return XBenchProcessor(judge_agent)
        if name == "browsecomp":
            assert judge_agent is not None, "browsecomp needs a judge agent"
            return BrowseCompProcessor(judge_agent)
        if name == "webwalker":
            assert judge_agent is not None, "webwalker needs a judge agent"
            return WebWalkerProcessor(judge_agent)
        raise ValueError(f"unknown processor {name!r}")
