"""Multi-dimension step/plan reward evaluation for the Excel agent.

Parity surface: the reference's reward evaluator module
(``integrations/DTR/src/modules`` reward evaluator, ~450 LoC): a step is
not just pass/fail — its reward grades execution, output quality, state
progress, alignment with the step description, and code efficiency, and a
plan's reward adds a completion bonus when the final step yields a concrete
answer. Graded rewards give the MCTS planner a useful gradient between
"every step crashed" and "perfect" (binary rewards collapse most rollouts
to the same score, starving UCT of signal).

All dimensions are host-side heuristics — deterministic and offline — and
compose with the per-step LLM verdict the agent already collects (the LLM
decides ``success``; this module grades *how good* a successful step is).

The port's copy of ``youtu_rag_tpu/integrations/dtr/reward.py``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any

from .smg import SMGNode, TableState

_NUMBER_RE = re.compile(r"-?\d+(?:\.\d+)?(?:e[+-]?\d+)?", re.IGNORECASE)
_ERROR_MARKERS = ("Traceback", "Error:", "Exception", "KeyError", "ValueError")

#: dimension weights; sum to 1.0
WEIGHTS = {
    "execution": 0.40,
    "output_quality": 0.25,
    "state_progress": 0.15,
    "alignment": 0.10,
    "efficiency": 0.10,
}


@dataclass
class StepReward:
    total: float
    dims: dict[str, float] = field(default_factory=dict)

    def explain(self) -> str:
        parts = ", ".join(f"{k}={v:.2f}" for k, v in self.dims.items())
        return f"reward {self.total:.2f} ({parts})"


def _tokens(text: str) -> set[str]:
    return {t for t in re.findall(r"[a-zA-Z_]\w+", text.lower()) if len(t) > 2}


def score_execution(node: SMGNode) -> float:
    """Ran cleanly = 1; ran with warnings/error markers in output = partial;
    evaluator-rejected = 0 even when no exception surfaced."""
    if not node.success:
        return 0.0
    if any(m in node.output for m in _ERROR_MARKERS):
        return 0.5
    return 1.0


def score_output_quality(node: SMGNode) -> float:
    out = node.output.strip()
    if not out:
        return 0.0
    score = 0.6
    low = out.lower()
    if "empty dataframe" in low or low in ("nan", "none", "[]", "{}"):
        return 0.1
    if _NUMBER_RE.search(out):
        score += 0.2  # concrete values beat bare confirmations
    if "nan" not in low:
        score += 0.2
    return min(score, 1.0)


def score_state_progress(
    node: SMGNode, state_before: dict[str, TableState], state_after: dict[str, TableState]
) -> float:
    """Did the step move the sheet-state machine: new/changed frames, or a
    printed result (terminal steps mutate nothing but still progress)."""
    if node.new_frames or node.changed_frames:
        return 1.0
    if state_after != state_before:
        return 1.0
    return 0.7 if node.output.strip() else 0.0


def score_alignment(node: SMGNode) -> float:
    """Cheap lexical check that the code/output serve the step description
    (ref: the evaluator's relevance dimension)."""
    want = _tokens(node.description)
    if not want:
        return 1.0
    have = _tokens(node.code) | _tokens(node.output)
    hit = len(want & have) / len(want)
    return 0.3 + 0.7 * hit  # floor: paraphrases shouldn't zero the step


def score_efficiency(node: SMGNode, max_code_lines: int = 40) -> float:
    lines = max(len(node.code.strip().splitlines()), 1)
    length_score = 1.0 if lines <= max_code_lines else max(0.2, max_code_lines / lines)
    retry_penalty = 0.15 * max(node.attempts - 1, 0)
    return max(length_score - retry_penalty, 0.0)


def evaluate_step(
    node: SMGNode,
    state_before: dict[str, TableState] | None = None,
    state_after: dict[str, TableState] | None = None,
) -> StepReward:
    sb = state_before if state_before is not None else node.state_before
    sa = state_after if state_after is not None else node.state_after
    dims = {
        "execution": score_execution(node),
        "output_quality": score_output_quality(node),
        "state_progress": score_state_progress(node, sb, sa),
        "alignment": score_alignment(node),
        "efficiency": score_efficiency(node),
    }
    if dims["execution"] == 0.0:
        # a failed step earns at most a sliver (partial credit for an
        # aligned attempt keeps refinement gradients alive)
        total = 0.05 * dims["alignment"]
    else:
        total = sum(WEIGHTS[k] * v for k, v in dims.items())
    return StepReward(total=round(total, 4), dims=dims)


def evaluate_plan(nodes: list[SMGNode], question: str = "") -> float:
    """Plan-level reward for MCTS rollouts: mean step reward plus a bonus
    when the final step produces a concrete (numeric or short factual)
    answer the question can be settled with."""
    if not nodes:
        return 0.0
    base = sum(n.reward for n in nodes) / len(nodes)
    final = nodes[-1]
    bonus = 0.0
    if final.success and final.output.strip():
        if _NUMBER_RE.search(final.output) or len(final.output.strip()) < 400:
            bonus = 0.15
        if question:
            q_tokens = _tokens(question)
            # the description names what the output represents — bare
            # numeric outputs alone can't show question overlap
            answer_tokens = _tokens(final.output) | _tokens(final.description)
            if q_tokens and len(q_tokens & answer_tokens) / len(q_tokens) >= 0.3:
                bonus += 0.05
    return round(min(base + bonus, 1.0), 4)


BATCH_EVAL_PROMPT = """You are reviewing {n} executed data-analysis steps.
For EACH step decide whether it achieved its stated goal.

{ops}

Reply with ONLY a JSON list, one object per step in order:
[{{"id": 1, "success": true, "reason": "..."}}, ...]"""


async def evaluate_batch_llm(
    nodes: list[SMGNode], llm_chat, batch_size: int = 16
) -> list[dict[str, Any]]:
    """One LLM call verdicts a whole batch of executed steps (ref
    ``reward_evaluator.evaluate_batch:49-110`` — the phase-2 batch of
    ``smg_module.execute_paths``): an N-step plan pays one evaluation
    call instead of N. Per-op fallback on parse failure is the execution
    heuristic (no error markers in the output)."""
    import json as _json
    import re as _re

    verdicts: list[dict[str, Any]] = []
    for start in range(0, len(nodes), batch_size):
        batch = nodes[start : start + batch_size]
        ops = "\n\n".join(
            f"## Step {i + 1}: {n.description}\n"
            f"Code:\n{n.code[:400]}\n"
            f"Output (tail):\n{n.output[-400:]}\n"
            f"Raised error: {'yes' if 'Error' in n.output else 'no'}"
            for i, n in enumerate(batch)
        )
        parsed: list | None = None
        try:
            raw = await llm_chat(BATCH_EVAL_PROMPT.format(n=len(batch), ops=ops))
            m = _re.search(r"\[.*\]", raw, _re.DOTALL)
            got = _json.loads(m.group(0)) if m else None
            if isinstance(got, list) and len(got) == len(batch):
                parsed = got
        except Exception:  # noqa: BLE001 - batch eval must degrade, not abort
            parsed = None
        if parsed is None:
            verdicts.extend(
                {"success": "Error" not in n.output, "reason": "heuristic"}
                for n in batch
            )
        else:
            verdicts.extend(
                {
                    "success": bool(v.get("success")),
                    "reason": str(v.get("reason", "")),
                }
                for v in parsed
            )
    return verdicts


def reward_feedback(nodes: list[SMGNode], rewards: list[StepReward] | None = None) -> str:
    """Refinement feedback string for the planner: which steps dragged the
    reward down and why (ref: rollout feedback conditioning)."""
    lines = []
    for i, n in enumerate(nodes):
        tag = "ok" if n.success else "FAILED"
        detail = rewards[i].explain() if rewards and i < len(rewards) else f"reward {n.reward:.2f}"
        lines.append(f"step {i + 1} [{tag}] {n.description[:80]} — {detail}")
        if not n.success and n.output:
            lines.append(f"  output tail: {n.output[-200:]}")
    return "\n".join(lines)
