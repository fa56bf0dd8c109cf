"""ADO — Action-Decomposed Operators for deep table reasoning.

Capability counterpart of the reference's ADO module
(``integrations/DTR/src/modules/ado_module.py``, 476 LoC): BEFORE any
planning, decompose the question into the SET of table operators it
needs (unordered — ordering is the planner's job). The selected set
constrains the plan prompt (the planner composes steps from named
operators instead of free-associating) and scores plan validity for the
MCTS reward (a plan whose steps fall outside the decomposed set is
probably drifting off-question).

Selection here is deterministic — question intent (``answer.analyze_
question_intent``) + operator keyword match + workbook-profile signals
(multiple sheets sharing columns → JOIN_SHEETS, datetime columns →
PARSE_DATES/TREND_OVER_TIME, null-heavy columns → CLEAN_NULLS) — so it
is hermetically testable; the reference gates the same pool through an
LLM vote.

The port's copy of ``youtu_rag_tpu/integrations/dtr/operators.py``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from .answer import analyze_question_intent
from .loader import SheetProfile

_WORD = re.compile(r"[a-z]+")


@dataclass(frozen=True)
class Operator:
    name: str
    category: str  # understand | clean | transform | combine | aggregate | present
    description: str
    cost: float  # rough step-budget weight
    keywords: tuple[str, ...] = ()
    intents: tuple[str, ...] = ()  # question intents that imply this op


OPERATOR_POOL: tuple[Operator, ...] = (
    Operator("DETECT_SCHEMA", "understand", "inspect column names, types and null counts", 0.5),
    Operator(
        "CLEAN_NULLS", "clean", "drop or fill null/placeholder values before computing", 0.5,
        keywords=("null", "missing", "empty", "nan"),
    ),
    Operator(
        "PARSE_DATES", "clean", "parse date/time columns to datetime for temporal work", 0.5,
        keywords=("date", "time", "year", "month", "quarter", "day"),
    ),
    Operator(
        "FILTER_ROWS", "transform", "select the rows matching the question's conditions", 1.0,
        keywords=("where", "only", "in", "during", "above", "below", "between", "negative", "positive"),
    ),
    Operator(
        "COMPUTE_DERIVED", "transform", "add derived columns (ratios, margins, differences)", 1.0,
        keywords=("margin", "ratio", "rate", "per", "percentage", "difference", "growth"),
    ),
    Operator(
        "JOIN_SHEETS", "combine", "merge sheets on their shared key columns", 1.5,
        keywords=("join", "merge", "combine", "across", "both", "together"),
    ),
    Operator(
        "GROUP_AGGREGATE", "aggregate", "group rows and aggregate (sum/mean/count/min/max)", 1.0,
        keywords=("total", "sum", "average", "mean", "median", "count", "per", "each", "by"),
        intents=("aggregation",),
    ),
    Operator(
        "SORT_RANK", "aggregate", "sort/rank rows to find extremes", 0.5,
        keywords=("top", "bottom", "highest", "lowest", "largest", "smallest", "best", "worst", "rank", "most", "least"),
    ),
    Operator(
        "PIVOT", "aggregate", "pivot/crosstab two dimensions against a measure", 1.5,
        keywords=("pivot", "crosstab", "matrix", "breakdown"),
    ),
    Operator(
        "COMPARE_GROUPS", "aggregate", "compute per-group values and their difference", 1.0,
        keywords=("compare", "versus", "vs", "difference", "gap"),
        intents=("comparison",),
    ),
    Operator(
        "TREND_OVER_TIME", "aggregate", "aggregate a measure over time buckets", 1.5,
        keywords=("trend", "over", "monthly", "yearly", "weekly", "growth", "change"),
        intents=("trend",),
    ),
    Operator(
        "LOOKUP_VALUE", "present", "locate the specific cell/row the question asks about", 0.5,
        keywords=("what", "which", "who", "when"),
        intents=("lookup",),
    ),
    Operator(
        "DESCRIBE_STATS", "present", "summary statistics of the relevant columns", 0.5,
        keywords=("describe", "distribution", "statistics", "spread"),
        intents=("why", "other"),
    ),
    Operator(
        "FORMAT_RESULT", "present", "print the final result (value or small table)", 0.3,
    ),
)

_BY_NAME = {op.name: op for op in OPERATOR_POOL}


@dataclass
class ADOResult:
    operators: list[Operator]
    rationale: dict[str, str] = field(default_factory=dict)

    @property
    def names(self) -> list[str]:
        return [op.name for op in self.operators]

    def budget(self) -> int:
        """Suggested step budget: operator costs rounded up, floor 2."""
        return max(2, round(sum(op.cost for op in self.operators)))

    def prompt_block(self) -> str:
        lines = ["Relevant operators (compose your plan steps from these):"]
        for op in self.operators:
            why = self.rationale.get(op.name)
            lines.append(f"- {op.name}: {op.description}" + (f"  [{why}]" if why else ""))
        return "\n".join(lines)

    def plan_coverage(self, plan: list[str]) -> float:
        """Fraction of plan steps that map into the decomposed operator
        set (content-word overlap with any selected op). The MCTS reward
        adds this as a small validity bonus — off-set steps suggest
        drift."""
        if not plan:
            return 0.0
        hits = 0
        for step in plan:
            toks = set(_WORD.findall(step.lower())) - _STOPWORDS
            for op in self.operators:
                if toks & _op_tokens(op):
                    hits += 1
                    break
        return hits / len(plan)


def decompose(question: str, profiles: list[SheetProfile] | None = None) -> ADOResult:
    """Select the operator set for a question + workbook (see module doc)."""
    q_tokens = set(_WORD.findall(question.lower()))
    intent = analyze_question_intent(question)
    selected: dict[str, str] = {}  # name -> rationale

    def pick(name: str, why: str) -> None:
        selected.setdefault(name, why)

    # baseline understanding + presentation always apply
    pick("DETECT_SCHEMA", "baseline understanding")
    pick("FORMAT_RESULT", "final presentation")

    for op in OPERATOR_POOL:
        if intent in op.intents:
            pick(op.name, f"intent: {intent}")
        kw_hits = q_tokens & set(op.keywords)
        if kw_hits:
            pick(op.name, f"keywords: {', '.join(sorted(kw_hits))}")

    # workbook-profile signals
    if profiles:
        if len(profiles) > 1:
            shared = _shared_columns(profiles)
            if shared:
                pick("JOIN_SHEETS", f"sheets share columns: {', '.join(shared[:3])}")
        if any(c.semantic == "datetime" for p in profiles for c in p.columns):
            if intent == "trend" or q_tokens & set(_BY_NAME["PARSE_DATES"].keywords):
                pick("PARSE_DATES", "datetime columns present")
        null_heavy = [
            c.name for p in profiles for c in p.columns if c.null_frac >= 0.1
        ]
        if null_heavy:
            pick("CLEAN_NULLS", f"null-heavy: {', '.join(null_heavy[:3])}")
        # question naming a categorical value implies row filtering
        cat_values = {
            str(v).lower()
            for p in profiles
            for c in p.columns
            if c.semantic == "categorical"
            for v in c.top_values
        }
        if q_tokens & cat_values:
            pick("FILTER_ROWS", "question names a categorical value")

    ops = [op for op in OPERATOR_POOL if op.name in selected]  # pool order
    return ADOResult(operators=ops, rationale=selected)


_STOPWORDS = frozenset(
    "the a an of to for and or in on with by from as is are be before "
    "into out its their this that any all".split()
)


def _op_tokens(op: Operator) -> frozenset[str]:
    """Content tokens an operator answers to (cached per op)."""
    got = _OP_TOKEN_CACHE.get(op.name)
    if got is None:
        got = frozenset(
            (set(_WORD.findall(op.description.lower())) | set(op.keywords)
             | set(_WORD.findall(op.name.replace("_", " ").lower())))
            - _STOPWORDS
        )
        _OP_TOKEN_CACHE[op.name] = got
    return got


_OP_TOKEN_CACHE: dict[str, frozenset[str]] = {}


def _shared_columns(profiles: list[SheetProfile]) -> list[str]:
    """Column names present in 2+ sheets — join-key candidates."""
    seen: dict[str, int] = {}
    for p in profiles:
        for c in {c.name.lower() for c in p.columns}:
            seen[c] = seen.get(c, 0) + 1
    return sorted(c for c, n in seen.items() if n >= 2)
