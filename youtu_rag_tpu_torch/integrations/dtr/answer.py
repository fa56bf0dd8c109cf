"""Answer generation for DTR runs.

Capability counterpart of the reference's answer generator
(``integrations/DTR/src/modules/answer_generator.py``, 1,440 LoC): the
final synthesis stage that turns the SMG's executed steps into an answer
with evidence. Beyond the evidence block + citations, this carries the
reference's behavioral surface deterministically (hermetically testable,
which the reference is not):

- question-intent analysis (lookup / aggregation / comparison / trend /
  list / why) driving short-vs-detailed answer style
  (ref ``_analyze_question_intent`` :1019, ``_is_short_answer_type`` :1410);
- float-artifact cleaning — ``3.9999999998`` → ``4``, trailing zero
  strings (ref ``_clean_number_format`` :1380);
- format-error detection on LLM output with one strict retry before the
  deterministic fallback (ref ``_has_format_errors`` :1325);
- final-frame rendering: the last derived frame re-renders as a
  row-sampled markdown table through the state machine, so tabular
  answers show the actual result rows (ref ``_format_dataframe`` :798,
  ``_generate_fallback`` :969).

An LLM writes the prose when one is configured; the deterministic path
composes the answer from the last successful step's output.

The port's copy of ``youtu_rag_tpu/integrations/dtr/answer.py``.
"""

from __future__ import annotations

import re
from typing import Any

from .smg import SMGNode

ANSWER_PROMPT = """Answer the question from the analysis results.

Question: {question}

Analysis evidence (cite steps as [step N] where used):
{evidence}

Frames produced: {frames}

Write the final answer:
- lead with the direct answer and its concrete numbers,
- cite the supporting steps like [step 2],
- include a small markdown table when the result is tabular,
- note any step that failed and how it limits confidence."""

SHORT_ANSWER_PROMPT = """Answer the question from the analysis results.

Question: {question}

Analysis evidence:
{evidence}
{guidance}
This is a {intent} question — reply with ONLY the direct answer (the
value, name, or number asked for, with its unit), one short sentence at
most. No preamble, no markdown, no restating the question."""

# ref answer_generator.py:313-330 — Ranking/Comparison get explicit
# extract-all-then-order instructions; without them LLMs routinely rank a
# partial item list or compare against a value from the wrong row
RANKING_GUIDANCE = """
Ranking/comparison instructions:
1. EXTRACT every relevant item with its numeric value from the evidence.
2. Order them by that value yourself — do not trust any ordering already
   present in prose.
3. Answer with the item name(s) in the asked-for position(s); include the
   deciding values.
"""

STRICT_RETRY_PROMPT = """Your previous answer had formatting problems.
Answer again, plain text/markdown only: no code fences, no role markers,
no template placeholders.

Question: {question}

Evidence:
{evidence}

Answer:"""


# ---------------------------------------------------------------------------
# question intent (ref answer_generator._analyze_question_intent:1019-1054)
# ---------------------------------------------------------------------------

_INTENT_PATTERNS: list[tuple[str, re.Pattern]] = [
    ("why", re.compile(r"\b(why|explain|reason|cause)\b|为什么|原因")),
    (
        "ranking",
        # "sort"/"order" only count with a "by" nearby — bare "what sort
        # of"/"in order of the committee" are lookups, not rankings
        re.compile(
            r"\b(rank(ing|ed)?|order(ed)? by|sort(ed)?(\s+\w+){0,3} by"
            r"|top\s+\d+|bottom\s+\d+"
            r"|(first|second|third|last) (largest|smallest|highest|lowest|biggest))\b"
            r"|排名|排序|前\d|后\d|第[一二三]"
        ),
    ),
    (
        "comparison",
        re.compile(r"\b(compare|versus|vs\.?|difference|more than|less than|higher|lower)\b|相比|对比|差异"),
    ),
    ("trend", re.compile(r"\b(trend|over time|growth|change|increase|decrease|evolution)\b|趋势|变化|增长")),
    ("list", re.compile(r"\b(list|enumerate|which ones|what are (all|the))\b|列出|哪些")),
    (
        "aggregation",
        re.compile(
            r"\b(total|sum|average|mean|median|count|how many|how much|max(imum)?|min(imum)?|highest|lowest|top\s*\d*)\b"
            r"|总|平均|合计|多少|最高|最低|最大|最小"
        ),
    ),
    ("lookup", re.compile(r"\b(what is|who is|when|where|which)\b|是什么|是谁|何时|哪个")),
]


def analyze_question_intent(question: str) -> str:
    q = question.lower()
    for intent, pat in _INTENT_PATTERNS:
        if pat.search(q):
            return intent
    return "other"


def is_short_answer(intent: str) -> bool:
    """Lookup/aggregation/ranking/comparison questions want the value(s),
    not an essay (ref ``_is_short_answer_type`` :1410 — Fact Checking,
    Ranking and Comparison all take the concise mode)."""
    return intent in ("lookup", "aggregation", "ranking", "comparison")


# ---------------------------------------------------------------------------
# number cleaning (ref answer_generator._clean_number_format:1380-1408)
# ---------------------------------------------------------------------------

_FLOAT_RE = re.compile(r"\d+\.\d{4,}")


def clean_number_format(text: str) -> str:
    """Collapse float representation artifacts in prose: long runs of
    0s/9s from binary rounding (``3.9999999998`` → ``4``,
    ``12.50000000001`` → ``12.5``); other long decimals round to 4
    places. Values inside markdown table cells get the same treatment."""

    def fix(m: re.Match) -> str:
        s = m.group(0)
        intpart, frac = s.split(".")
        if re.match(r"^(9{4,})\d{0,3}$", frac) or re.match(r"^\d{0,3}?(9{4,})\d{0,2}$", frac):
            return f"{float(s):.4f}".rstrip("0").rstrip(".")
        if re.match(r"^\d{0,3}?(0{4,})\d{0,2}$", frac):
            return f"{float(s):.4f}".rstrip("0").rstrip(".")
        return f"{float(s):.4f}"

    return _FLOAT_RE.sub(fix, text)


# ---------------------------------------------------------------------------
# answer-level error detection (ref dtr_framework._is_error_message:492-517)
# ---------------------------------------------------------------------------

_ERROR_INDICATORS = (
    "no operators extracted",
    "no execution paths generated",
    "execution failed",
    "no answer generated",
    "no data available",
    "analysis did not produce a result",
    "error:",
    "failed:",
    "exception:",
)


def is_error_answer(answer: str | None) -> bool:
    """True when the synthesized answer is an error/empty message rather
    than an actual answer — the trigger for the framework's recovery
    ladder (replan → direct LLM → extract-from-original)."""
    if not answer or not answer.strip():
        return True
    low = answer.lower()
    return any(ind in low for ind in _ERROR_INDICATORS)


_POINT_ZERO = re.compile(r"(?<![\d.])([1-9]\d*)\.0(?![\d.])")


def strip_point_zero(text: str) -> str:
    """``158772.0`` → ``158772`` in prose/tables (ref
    ``_clean_number_format``:1380-1408 — the reference strips the
    float-cast artifact pandas leaves on integer answers; ``0.0`` and
    real decimals like ``5.8`` are kept)."""
    return _POINT_ZERO.sub(r"\1", text)


# ---------------------------------------------------------------------------
# format-error detection (ref answer_generator._has_format_errors:1325-1334)
# ---------------------------------------------------------------------------

_FORMAT_ERRORS = (
    re.compile(r"^\s*```"),  # the whole reply is a fenced blob, not an answer
    re.compile(r"\{(question|evidence|frames|intent)\}"),  # unfilled template
    re.compile(r"^(system|assistant|user)\s*:", re.IGNORECASE),  # role markers
    re.compile(r"as an ai\b", re.IGNORECASE),
)


def has_format_errors(answer: str) -> bool:
    a = answer.strip()
    if not a:
        return True
    if a.count("```") % 2 == 1:  # unbalanced fence
        return True
    return any(p.search(a) for p in _FORMAT_ERRORS)


# ---------------------------------------------------------------------------
# evidence + frame rendering
# ---------------------------------------------------------------------------


def build_evidence(nodes: list[SMGNode]) -> str:
    """Per-step evidence block: description, outcome, trimmed output, and
    the frame-state delta (what each step created/changed)."""
    parts = []
    for i, n in enumerate(nodes, start=1):
        delta = ""
        if n.new_frames:
            delta += f" | new frames: {', '.join(n.new_frames)}"
        if n.changed_frames:
            delta += f" | changed: {', '.join(n.changed_frames)}"
        parts.append(
            f"[step {i}] {n.description} ({'ok' if n.success else 'FAILED'}{delta})\n"
            f"{(n.output or '').strip()[:600]}"
        )
    return "\n\n".join(parts) or "(no steps executed)"


async def render_frame(machine, name: str, max_rows: int = 10) -> str | None:
    """Re-render one live frame as a row-sampled markdown table via the
    state machine (head/tail with an ellipsis row past ``max_rows`` —
    ref ``_format_dataframe``). Returns None when rendering fails."""
    # state keys are already valid expressions: bare frame names or
    # dfs['Sheet'] with repr quoting from the snapshot epilogue
    expr = name
    h, t = (max_rows + 1) // 2, max_rows // 2
    code = (
        f"_f = {expr}\n"
        f"if len(_f) > {max_rows}:\n"
        f"    _top = _f.head({h}).astype(str)\n"
        f"    _bot = _f.tail({t}).astype(str)\n"
        "    _gap = _top.iloc[:1].map(lambda _x: '…')\n"
        "    _f = pd.concat([_top, _gap, _bot])\n"
        "try:\n"
        "    print(_f.to_markdown(index=False))\n"
        "except ImportError:\n"
        "    print(_f.to_string(index=False))\n"
    )
    try:
        out, _ = await machine.execute_step(code)
    except Exception:  # noqa: BLE001 - rendering is best-effort
        return None
    if not out or out.startswith("Error") or "\nError" in out:
        return None
    return out.strip()[:2400]


async def render_tables(machine, max_rows: int = 60) -> str | None:
    """Row-sampled markdown of every source sheet (head/tail with an
    ellipsis row), via the state machine. The direct-LLM fallback's view
    of the data (ref ``_format_dataframe(original_df, max_rows=200)``,
    capped lower here — the fallback reads the table, it doesn't scan it)."""
    h, t = (max_rows + 1) // 2, max_rows // 2
    code = (
        "for _name in dfs:\n"
        "    _f = dfs[_name]\n"
        "    print(f'## {_name} ({len(_f)} rows)')\n"
        f"    if len(_f) > {max_rows}:\n"
        f"        _top = _f.head({h}).astype(str)\n"
        f"        _bot = _f.tail({t}).astype(str)\n"
        "        _gap = _top.iloc[:1].map(lambda _x: '…')\n"
        "        _f = pd.concat([_top, _gap, _bot])\n"
        "    try:\n"
        "        print(_f.to_markdown(index=False))\n"
        "    except ImportError:\n"
        "        print(_f.to_string(index=False))\n"
        "    print()\n"
    )
    try:
        out, _ = await machine.execute_step(code)
    except Exception:  # noqa: BLE001 - rendering is best-effort
        return None
    if not out or out.startswith("Error") or "\nError" in out:
        return None
    return out.strip()[:8000]


# ---------------------------------------------------------------------------
# recovery ladder: direct LLM answer + extraction from the original table
# (ref answer_generator._generate_direct_llm_answer:1055-1325,
#  _try_extract_from_original:1336-1378)
# ---------------------------------------------------------------------------

DIRECT_ANSWER_PROMPT = """Answer the question directly from the table data
below — read the tables, do not describe a procedure.

# Tables
{tables}

# Question
{question}

{style}
Output format: [Final Answer]: <your answer>"""

_SHORT_STYLE = (
    "This needs a SHORT answer: output ONLY the value/name/number asked "
    "for (with its unit). No steps, no 'from the table', no explanation."
)
_LONG_STYLE = (
    "Lead with the direct answer and its concrete numbers; keep it brief."
)

EXTRACT_PROMPT = """You must extract the best possible answer from the
original table, even if the data seems incomplete.

# Question
{question}

# Original tables
{tables}

- Match question keywords against column names and cell values.
- For numerical questions find the relevant numbers.
- For yes/no questions analyze the data and answer Yes or No.
- Only reply "[Final Answer]: No data available" if truly nothing relates.

Output format: [Final Answer]: <your answer>"""

_FINAL_TAG = re.compile(r"\[\s*Final Answer\s*\]\s*:?", re.IGNORECASE)


def _after_final_tag(raw: str) -> str:
    m = _FINAL_TAG.search(raw)
    return (raw[m.end():] if m else raw).strip()


async def direct_llm_answer(
    question: str, machine, llm_chat, max_rows: int = 60
) -> str | None:
    """Answer straight from the rendered source tables, bypassing code
    execution — the framework's fallback when executed paths produced an
    error answer (ref ``_generate_direct_llm_answer``). Short-answer
    questions (lookup/aggregation) get the value-only style. Returns
    None when no LLM, rendering fails, or the reply is still broken."""
    if llm_chat is None:
        return None
    tables = await render_tables(machine, max_rows=max_rows)
    if tables is None:
        return None
    style = _SHORT_STYLE if is_short_answer(analyze_question_intent(question)) else _LONG_STYLE
    try:
        raw = await llm_chat(
            DIRECT_ANSWER_PROMPT.format(tables=tables, question=question, style=style)
        )
    except Exception:  # noqa: BLE001 - fallback of a fallback must not raise
        return None
    ans = clean_number_format(strip_point_zero(_after_final_tag(raw or "")))
    if not ans or has_format_errors(ans) or is_error_answer(ans):
        return None
    return ans


async def extract_from_original(question: str, machine, llm_chat) -> str | None:
    """Last rung: permissive extraction from the original table (ref
    ``_try_extract_from_original`` — 'even if the data seems incomplete').
    Returns None when the model still reports no data."""
    if llm_chat is None:
        return None
    tables = await render_tables(machine, max_rows=50)
    if tables is None:
        return None
    try:
        raw = await llm_chat(EXTRACT_PROMPT.format(question=question, tables=tables))
    except Exception:  # noqa: BLE001
        return None
    ans = clean_number_format(strip_point_zero(_after_final_tag(raw or "")))
    if not ans or "no data" in ans.lower() or has_format_errors(ans):
        return None
    return ans


def _final_frame(nodes: list[SMGNode]) -> str | None:
    """The most recently created derived frame — the natural 'result'.

    Input sheets (``dfs[...]`` keys) are excluded: the first step's
    state diff reports the freshly loaded sheets as 'new', and rendering
    a raw source sheet as the result table would misrepresent it."""
    for n in reversed(nodes):
        derived = [f for f in n.new_frames if not f.startswith("dfs[")]
        if n.success and derived:
            return derived[-1]
    return None


# ---------------------------------------------------------------------------
# synthesis
# ---------------------------------------------------------------------------


def fallback_answer(question: str, nodes: list[SMGNode], table: str | None = None) -> str:
    """Deterministic synthesis when no LLM is configured: the last
    successful step's output is the answer, with a citation trail and the
    rendered result table when one exists."""
    ok = [(i, n) for i, n in enumerate(nodes, start=1) if n.success and n.output.strip()]
    if not ok:
        if table:
            return f"Result table:\n\n{table}"
        failures = "; ".join(f"[step {i}] {n.description}" for i, n in enumerate(nodes, start=1))
        return f"Analysis did not produce a result. Failed steps: {failures or 'none executed'}"
    i, last = ok[-1]
    cites = ", ".join(f"[step {j}]" for j, _ in ok)
    body = clean_number_format(last.output.strip()[:1200])
    if table and table not in body:
        body += f"\n\n{table}"
    return f"{body}\n\n(evidence: {cites}; answering step: [step {i}])"


def format_alt_paths(alt_paths: list[dict[str, Any]], max_paths: int = 3) -> str:
    """Cross-verification section from runner-up execution paths (ref
    ``_build_prompt`` all_paths_section :294-307): the answer LLM sees how
    the other rollouts ended so agreement raises confidence — but must
    still answer from the best path alone."""
    if not alt_paths:
        return ""
    lines = ["", "# Other execution paths (verification only):"]
    for i, p in enumerate(alt_paths[:max_paths], 1):
        lines.append(
            f"\nPath {i} (reward {p.get('reward', 0.0):.2f}, "
            f"{p.get('success', 0)}/{p.get('total', 0)} steps ok):"
        )
        if p.get("plan"):
            lines.append("  steps: " + " → ".join(str(s)[:60] for s in p["plan"][:6]))
        if p.get("result"):
            lines.append("  final output: " + str(p["result"])[:400])
    lines.append(
        "\nNOTE: these are for cross-checking only — output ONE answer "
        "based on the primary evidence above."
    )
    return "\n".join(lines)


async def synthesize_answer(
    question: str,
    nodes: list[SMGNode],
    llm_chat,
    state: dict[str, Any] | None = None,
    machine=None,
    chart_dir: str | None = None,
    alt_paths: list[dict[str, Any]] | None = None,
    schema_hint: str | None = None,
) -> str:
    """LLM synthesis with the evidence block; intent-matched style (terse
    for lookup/aggregation), number cleaning, one strict retry on format
    errors, deterministic fallback when ``llm_chat`` is None or fails.

    Visualization questions (ref answer_generator.py:426-470: the
    "Visualization" question type must yield an executed chart) route
    through viz.generate_chart — LLM matplotlib code when available,
    schema-driven ChartSpec otherwise — and return a full markdown report
    (answer + chart + result table + step trail)."""
    intent = analyze_question_intent(question)
    table = None
    if machine is not None:
        name = _final_frame(nodes)
        if name is not None:
            table = await render_frame(machine, name)

    from .viz import compose_report, generate_chart, is_visualization_question

    if machine is not None and is_visualization_question(question):
        import os
        import tempfile

        out_dir = chart_dir or tempfile.mkdtemp(prefix="dtr_chart_")
        chart_path = os.path.join(out_dir, "chart.png")
        path, code = await generate_chart(machine, question, llm_chat, chart_path)
        body = fallback_answer(question, nodes, None) if llm_chat is None else None
        if body is None:
            try:
                body = clean_number_format(
                    (await llm_chat(
                        ANSWER_PROMPT.format(
                            question=question,
                            evidence=build_evidence(nodes),
                            frames=", ".join(state or {}) or "(none)",
                        )
                    )).strip()
                )
            except Exception:  # noqa: BLE001
                body = fallback_answer(question, nodes, None)
        return compose_report(
            question, body, nodes, table=table, chart_path=path, chart_code=code or None
        )

    if llm_chat is None:
        return fallback_answer(question, nodes, table)

    evidence = build_evidence(nodes)
    if table:
        evidence += f"\n\nFinal result table:\n{table}"
    if schema_hint:
        # ref _build_prompt schema_hint :278-292 — point the LLM at the
        # linked headers so extraction stays on the relevant columns
        evidence += f"\n\nSchema hint — relevant columns: {schema_hint}"
    if alt_paths:
        evidence += "\n" + format_alt_paths(alt_paths)
    frames = ", ".join(f"{k} ({v.summary()})" for k, v in (state or {}).items()) or "(none)"
    if is_short_answer(intent):
        guidance = RANKING_GUIDANCE if intent in ("ranking", "comparison") else ""
        prompt = SHORT_ANSWER_PROMPT.format(
            question=question, evidence=evidence, intent=intent, guidance=guidance
        )
    else:
        prompt = ANSWER_PROMPT.format(question=question, evidence=evidence, frames=frames)
    try:
        out = await llm_chat(prompt)
        if out and has_format_errors(out):
            out = await llm_chat(STRICT_RETRY_PROMPT.format(question=question, evidence=evidence))
        if not out or has_format_errors(out):
            return fallback_answer(question, nodes, table)
        return clean_number_format(out.strip())
    except Exception:  # noqa: BLE001 - answer must always come back
        return fallback_answer(question, nodes, table)
