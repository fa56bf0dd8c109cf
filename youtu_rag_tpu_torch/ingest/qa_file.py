"""QA-file parsing + validation for knowledge-base QA sources.

A copy of ``youtu_rag_tpu/ingest/qa_file.py``; ``pandas`` is imported
inside the functions that read a file.

Parity surface: ``utu/rag/api/services/kb_config_service.py:497-580``
(``validate_qa_file``) and the QAProcessor's column conventions
(``utu/rag/knowledge_builder/processors.py:1470-1520``): an Excel workbook
whose ``example`` sheet (or a CSV) carries ``question`` / ``answer`` /
``howtofind`` columns, with en/zh header aliases. Validation reports the
matched columns, row count, a 3-row sample, and precise errors; parsing
returns the pairs the QAProcessor ingests.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

from ..utils.log import get_logger

logger = get_logger("ingest.qa_file")

HEADER_ALIASES = {
    "question": ["question", "问题", "题目"],
    "answer": ["answer", "答案", "回答"],
    "howtofind": ["howtofind", "how to find", "查找方式"],
}
REQUIRED = ("question", "answer", "howtofind")
PREFERRED_SHEET = "example"


def _match_columns(headers: list[str]) -> dict[str, str]:
    """required name → actual column name (first alias hit wins)."""
    out: dict[str, str] = {}
    lowered = {str(h).lower().strip(): h for h in headers}
    for required, aliases in HEADER_ALIASES.items():
        for alias in aliases:
            if alias in lowered and required not in out:
                out[required] = lowered[alias]
                break
    return out


def _load_frame(path: str):
    import pandas as pd

    p = Path(path)
    if p.suffix.lower() == ".csv":
        return pd.read_csv(p), None
    sheets = pd.read_excel(p, sheet_name=None)
    if PREFERRED_SHEET in sheets:
        return sheets[PREFERRED_SHEET], PREFERRED_SHEET
    # the reference hard-requires the 'example' sheet; a single-sheet
    # workbook is accepted here (clearly the intended data), multi-sheet
    # without 'example' is rejected with the same error shape
    if len(sheets) == 1:
        name, df = next(iter(sheets.items()))
        return df, name
    raise ValueError(
        f"required sheet {PREFERRED_SHEET!r} not found; available sheets: {list(sheets)}"
    )


def validate_qa_file(path: str, filename: str | None = None) -> dict[str, Any]:
    """Validation report (ref return contract: valid/filename/sheet_name/
    row_count/columns/errors/sample_data)."""
    filename = filename or Path(path).name
    try:
        df, sheet_name = _load_frame(path)
    except Exception as e:  # noqa: BLE001 - unreadable file → invalid, not a 500
        return {"valid": False, "filename": filename, "errors": [str(e)]}
    cols = _match_columns(list(df.columns))
    missing = [r for r in REQUIRED if r not in cols]
    if missing:
        return {
            "valid": False,
            "filename": filename,
            "sheet_name": sheet_name,
            "errors": [
                f"Missing required columns: {missing}",
                "Expected columns (one of): question(问题), answer(答案), howtofind(查找方式)",
                f"Got headers: {list(df.columns)[:5]}",
            ],
        }
    df = df.dropna(how="all")
    sample = [
        {
            r: ("" if _is_na(row[cols[r]]) else str(row[cols[r]]))
            for r in REQUIRED
        }
        for _, row in df.head(3).iterrows()
    ]
    return {
        "valid": True,
        "filename": filename,
        "sheet_name": sheet_name,
        "row_count": int(len(df)),
        "columns": list(cols),
        "errors": [],
        "sample_data": sample,
    }


def _is_na(v: Any) -> bool:
    import pandas as pd

    try:
        return bool(pd.isna(v))
    except (TypeError, ValueError):
        return False


def parse_qa_file(path: str) -> list[dict[str, str]]:
    """QA pairs ready for the QAProcessor; raises ValueError on an invalid
    file (callers surface it as a per-source build error)."""
    report = validate_qa_file(path)
    if not report["valid"]:
        raise ValueError("; ".join(report["errors"]))
    df, _ = _load_frame(path)
    cols = _match_columns(list(df.columns))
    pairs = []
    for _, row in df.dropna(how="all").iterrows():
        q = "" if _is_na(row[cols["question"]]) else str(row[cols["question"]]).strip()
        if not q:
            continue
        pairs.append(
            {
                "question": q,
                "answer": "" if _is_na(row[cols["answer"]]) else str(row[cols["answer"]]).strip(),
                "howtofind": (
                    "" if _is_na(row[cols["howtofind"]]) else str(row[cols["howtofind"]]).strip()
                ),
            }
        )
    return pairs
