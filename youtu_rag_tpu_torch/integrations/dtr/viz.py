"""Chart + report generation for DTR answers.

Capability counterpart of the reference answer generator's Visualization
question type (``integrations/DTR/src/modules/answer_generator.py:426-470``:
the LLM must emit executable matplotlib code, which is run and judged on
the Excel-QA "Aesthetics" dimension). Here the chart path is two-tier:

- **LLM tier** — a code-only matplotlib prompt (same contract as the
  reference: no prose, exact column names, aggregate before plotting),
  executed through the sheet-state machine's sandbox with a savefig
  epilogue (headless Agg backend, no plt.show dependency);
- **deterministic tier** — ``chart_spec`` inspects the result frame's
  dtypes and picks bar / line / pie / hist with sensible axes, then
  renders it without any LLM — the hermetic path tests exercise.

``compose_report`` assembles the final deliverable: answer, rendered
result table, chart, and the step trail — the report surface behind the
reference's Excel-QA depth/aesthetics rows (``README.md:666-743``).

The port's copy of ``youtu_rag_tpu/integrations/dtr/viz.py``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from .smg import SheetStateMachine, SMGNode, TableState

CHART_CODE_PROMPT = """Generate ONLY executable Python matplotlib code for this request.

Question: {question}

Live frames (use them by name; `dfs` holds the raw sheets):
{state}

Rules (MANDATORY):
- output a single ```python code block, nothing else — it will be executed;
- use EXACT column names from the frames above;
- aggregate first when needed (groupby/sum/mean), drop non-data rows;
- figure size (10, 6), a title, axis labels, readable tick labels;
- finish with plt.savefig(CHART_PATH, dpi=120, bbox_inches='tight') —
  CHART_PATH is predefined; do NOT call plt.show().
"""

# tolerant of inline / CRLF fences (same shape as excel_agent._FENCE —
# a literal \n here would execute raw backticks on one-line replies)
_FENCE = re.compile(r"```(?:python)?\s*(.*?)```", re.DOTALL)

_VIZ_RE = re.compile(
    r"\b(chart|plot|graph|visuali[sz]e|draw|pie|bar chart|line chart|histogram|scatter)\b"
    r"|图表|画图|绘制|可视化"
)


def is_visualization_question(question: str) -> bool:
    return bool(_VIZ_RE.search(question.lower()))


@dataclass
class ChartSpec:
    kind: str  # bar | line | pie | hist
    x: str | None
    y: str | None
    title: str


_NUMERIC = ("int", "float")
_TIME_COL = re.compile(r"date|time|year|month|day|period|quarter|周期|日期|年", re.IGNORECASE)


def chart_spec(state: TableState, question: str = "") -> ChartSpec | None:
    """Deterministic chart choice from a frame's schema.

    time-ish column + numeric → line; categorical + numeric → bar
    (pie when the question asks for shares/proportions); all-numeric
    single column → hist. None when the frame has no numeric column."""
    num_cols = [c for c, t in state.dtypes.items() if t.startswith(_NUMERIC)]
    cat_cols = [c for c in state.columns if c not in num_cols]
    if not num_cols:
        return None
    title = (question.strip().rstrip("?").rstrip("？") or "Result")[:80]
    time_cols = [c for c in state.columns if _TIME_COL.search(c)]
    if time_cols and num_cols:
        return ChartSpec("line", time_cols[0], num_cols[0], title)
    if cat_cols and num_cols:
        kind = "pie" if re.search(r"share|proportion|percent|占比|比例", question.lower()) else "bar"
        return ChartSpec(kind, cat_cols[0], num_cols[0], title)
    if len(num_cols) >= 2:
        return ChartSpec("line", num_cols[0], num_cols[1], title)
    return ChartSpec("hist", None, num_cols[0], title)


def spec_to_code(spec: ChartSpec, frame_expr: str, chart_path: str) -> str:
    """Render a ChartSpec as matplotlib code over a live frame expression."""
    lines = [
        "import matplotlib",
        "matplotlib.use('Agg')",
        "import matplotlib.pyplot as plt",
        f"_cf = {frame_expr}",
        "plt.figure(figsize=(10, 6))",
    ]
    y = f"_cf[{spec.y!r}]"
    if spec.kind == "bar":
        lines += [
            f"_g = _cf.groupby({spec.x!r})[{spec.y!r}].sum().sort_values(ascending=False).head(20)",
            "plt.bar([str(v) for v in _g.index], _g.values)",
            f"plt.xlabel({spec.x!r})", f"plt.ylabel({spec.y!r})",
            "plt.xticks(rotation=45, ha='right')",
        ]
    elif spec.kind == "pie":
        lines += [
            f"_g = _cf.groupby({spec.x!r})[{spec.y!r}].sum().sort_values(ascending=False).head(8)",
            "plt.pie(_g.values, labels=[str(v) for v in _g.index], autopct='%1.1f%%')",
        ]
    elif spec.kind == "line":
        lines += [
            f"_s = _cf.sort_values({spec.x!r})" if spec.x else "_s = _cf",
            f"plt.plot(_s[{spec.x!r}], _s[{spec.y!r}], marker='o')" if spec.x
            else f"plt.plot({y}.values, marker='o')",
            f"plt.xlabel({spec.x!r})" if spec.x else "plt.xlabel('index')",
            f"plt.ylabel({spec.y!r})",
            "plt.xticks(rotation=45, ha='right')",
        ]
    else:  # hist
        lines += [
            f"plt.hist({y}.dropna().values, bins=20)",
            f"plt.xlabel({spec.y!r})", "plt.ylabel('count')",
        ]
    lines += [
        f"plt.title({spec.title!r})",
        "plt.tight_layout()",
        f"plt.savefig({chart_path!r}, dpi=120, bbox_inches='tight')",
        "print('chart saved')",
    ]
    return "\n".join(lines)


def _harden_llm_chart_code(code: str, chart_path: str) -> str:
    """Sandbox prep for LLM-written chart code: headless backend, a bound
    CHART_PATH, plt.show stripped, savefig forced if the model forgot."""
    body = code.replace("plt.show()", "")
    prelude = (
        "import matplotlib\nmatplotlib.use('Agg')\n"
        f"CHART_PATH = {chart_path!r}\n"
    )
    if "savefig" not in body:
        body += f"\nimport matplotlib.pyplot as plt\nplt.savefig({chart_path!r}, dpi=120, bbox_inches='tight')"
    return prelude + body + "\nprint('chart saved')"


async def generate_chart(
    machine: SheetStateMachine,
    question: str,
    llm_chat,
    chart_path: str,
) -> tuple[str | None, str]:
    """Produce a chart PNG for the question → (path or None, code used).

    LLM code (one repair attempt on error) first; deterministic
    ``chart_spec`` fallback over the newest derived frame (or the first
    raw sheet) when there is no LLM or its code keeps failing."""
    import os

    if llm_chat is not None:
        raw = await llm_chat(
            CHART_CODE_PROMPT.format(question=question, state=machine.state_summary())
        )
        m = _FENCE.search(raw)
        code = (m.group(1) if m else raw).strip()
        for attempt in range(2):
            hardened = _harden_llm_chart_code(code, chart_path)
            out, _state = await machine.execute_step(hardened)
            # the PNG on disk is the authoritative success signal: savefig
            # runs last, so an exception anywhere leaves no file (and
            # legitimate stdout containing the word "Error" can't
            # misclassify a good chart)
            if os.path.exists(chart_path):
                return chart_path, code
            if attempt == 0:  # only request a repair that will be executed
                raw = await llm_chat(
                    "The chart code failed:\n```python\n" + code + "\n```\nOutput:\n"
                    + out[-500:] + "\nFix it. Output ONLY the corrected ```python block."
                )
                m = _FENCE.search(raw)
                code = (m.group(1) if m else raw).strip()

    # deterministic fallback
    frame_expr = None
    for name in reversed(list(machine.state)):
        if not name.startswith("dfs["):
            frame_expr = name
            break
    if frame_expr is None and machine.state:
        frame_expr = next(iter(machine.state))
    if frame_expr is None:
        frame_expr = "list(dfs.values())[0]"
        st = None
    else:
        st = machine.state.get(frame_expr)
    if st is None:
        # no snapshot: probe the frame through the sandbox epilogue
        # (underscore names are skipped by the state snapshot, so use one
        # that survives it)
        _out, state = await machine.execute_step(f"probe_frame = ({frame_expr}).copy()")
        st = state.get("probe_frame") or next(iter(state.values()), None)
        if st is None:
            return None, ""
    spec = chart_spec(st, question)
    if spec is None:
        return None, ""
    code = spec_to_code(spec, frame_expr, chart_path)
    out, _ = await machine.execute_step(code)
    import os as _os

    if "Error" in out or not _os.path.exists(chart_path):
        return None, code
    return chart_path, code


def compose_report(
    question: str,
    answer: str,
    nodes: list[SMGNode],
    table: str | None = None,
    chart_path: str | None = None,
    chart_code: str | None = None,
) -> str:
    """Markdown report: answer → chart → result table → step trail.
    The deliverable surface behind the reference's Excel-QA depth/
    aesthetics scoring (``README.md:666-743``)."""
    parts = [f"# Analysis Report\n\n**Question:** {question}\n\n## Answer\n\n{answer}"]
    if chart_path:
        parts.append(f"## Chart\n\n![chart]({chart_path})")
        if chart_code:
            parts.append(f"<details><summary>chart code</summary>\n\n```python\n{chart_code}\n```\n</details>")
    if table:
        parts.append(f"## Result table\n\n{table}")
    trail = "\n".join(
        f"{i}. {'✅' if n.success else '❌'} {n.description}"
        for i, n in enumerate(nodes, start=1)
    )
    if trail:
        parts.append(f"## Analysis steps\n\n{trail}")
    return "\n\n".join(parts)
