"""Multi-sheet workbook loader/profiler for the Excel agent.

Parity surface: the reference's multi-sheet loader module
(``integrations/DTR/src/modules`` multi-sheet loader, ~370 LoC): load every
sheet, detect headerless sheets, infer semantic column types, and produce a
compact per-sheet profile the planner/coder prompts from. The agent's old
``load_sheets``/``load_schema`` only dumped dtypes + two head rows; this
profiler adds:

- header detection: a first row that looks like data (numeric-dominant or
  duplicating row 2's types) gets synthetic ``col_N`` names instead of
  silently becoming the header;
- semantic types per column: ``id`` (unique key), ``numeric``, ``datetime``
  (parse-probed on object columns), ``categorical`` (low cardinality, with
  top values), ``text``;
- null fractions and unique counts — the stats SQL-ish reasoning needs to
  pick join keys and group-bys.

The port's copy of ``youtu_rag_tpu/integrations/dtr/loader.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np


@dataclass
class ColumnProfile:
    name: str
    dtype: str
    semantic: str  # id | numeric | datetime | categorical | text
    null_frac: float = 0.0
    n_unique: int = 0
    top_values: list[Any] = field(default_factory=list)

    def brief(self) -> str:
        bits = [self.semantic]
        if self.null_frac > 0:
            bits.append(f"{self.null_frac:.0%} null")
        if self.semantic == "categorical" and self.top_values:
            tv = ", ".join(str(v)[:20] for v in self.top_values[:4])
            bits.append(f"values: {tv}")
        return f"{self.name} ({'; '.join(bits)})"


@dataclass
class SheetProfile:
    name: str
    shape: tuple[int, int]
    columns: list[ColumnProfile]
    synthetic_header: bool = False
    sample: list[dict] = field(default_factory=list)
    structure: str = ""  # TableStructure.brief(): title/hierarchy/fill notes

    def brief(self, max_cols: int = 16) -> str:
        cols = "; ".join(c.brief() for c in self.columns[:max_cols])
        extra = f" (+{len(self.columns) - max_cols} more cols)" if len(self.columns) > max_cols else ""
        header_note = " [headerless: synthetic col names]" if self.synthetic_header else ""
        structure_note = f"\n  structure: {self.structure}" if self.structure else ""
        return (
            f"- {self.name}: {self.shape[0]} rows x {self.shape[1]} cols{header_note}\n"
            f"  columns: {cols}{extra}{structure_note}\n"
            f"  sample: {self.sample[:2]}"
        )


def _first_row_is_data(df) -> bool:
    """True when the parsed header row looks like a data row: mostly
    numeric-parseable, or duplicated/unnamed placeholder labels."""
    cols = [str(c) for c in df.columns]
    if not cols:
        return False
    unnamed = sum(c.startswith("Unnamed:") for c in cols)
    if unnamed >= max(len(cols) // 2, 1):
        return True

    def numericish(s: str) -> bool:
        try:
            float(s)
            return True
        except ValueError:
            return False

    return sum(numericish(c) for c in cols) >= max(len(cols) // 2, 1)


def load_sheets(path: str) -> dict[str, Any]:
    """Load every sheet with header detection. csv/tsv → one sheet; a
    DIRECTORY of csv files → one sheet per file (named by stem) — the
    offline multi-sheet workbook format (the image has no openpyxl, and
    multi-sheet joins need more than one frame)."""
    import os

    import pandas as pd

    if os.path.isdir(path):
        sheets = {}
        raw = {}
        for fn in sorted(os.listdir(path)):
            if not fn.endswith((".csv", ".tsv")):
                continue
            full = os.path.join(path, fn)
            sep = "\t" if fn.endswith(".tsv") else ","
            stem = os.path.splitext(fn)[0]
            sheets[stem] = pd.read_csv(full, sep=sep)
            raw[stem] = (lambda f=full, s=sep: pd.read_csv(f, sep=s, header=None))
        if not sheets:
            raise RuntimeError(f"workbook directory {path!r} holds no csv/tsv files")
    elif path.endswith((".csv", ".tsv")):
        sep = "\t" if path.endswith(".tsv") else ","
        sheets = {"Sheet1": pd.read_csv(path, sep=sep)}
        raw = {"Sheet1": (lambda: pd.read_csv(path, sep=sep, header=None))}
    else:
        try:
            sheets = pd.read_excel(path, sheet_name=None)
        except ImportError as e:  # pandas lazily needs openpyxl/xlrd
            raise RuntimeError(
                "reading .xlsx needs the 'openpyxl' package (not installed "
                "in this environment); convert to CSV or install it"
            ) from e
        raw = {name: (lambda n=name: pd.read_excel(path, sheet_name=n, header=None)) for name in sheets}

    from .table_structure import detect_header_end, structure_sheet

    out = {}
    for name, df in sheets.items():
        raw_df = raw[name]()
        header_end = detect_header_end(raw_df)
        if header_end == 1 and len(df) > 0 and not _first_row_is_data(df):
            out[name] = df  # pandas' own parse is already right
            continue
        # headerless (0), multi-row/banner headers (≥2), or a parsed
        # header that looks like data → full structuring pass
        sdf, ts = structure_sheet(raw_df)
        sdf.attrs["structure"] = ts
        sdf.attrs["synthetic_header"] = header_end == 0
        out[name] = sdf
    return out


def profile_column(series) -> ColumnProfile:
    import pandas as pd

    n = max(len(series), 1)
    null_frac = float(series.isna().sum()) / n
    nun = int(series.nunique(dropna=True))
    dtype = str(series.dtype)

    if pd.api.types.is_datetime64_any_dtype(series):
        semantic = "datetime"
    elif pd.api.types.is_numeric_dtype(series):
        # all-unique integers look like keys; floats are measurements
        unique_int = (
            pd.api.types.is_integer_dtype(series)
            and nun == n - int(series.isna().sum())
            and nun > 20
        )
        semantic = "id" if unique_int else "numeric"
    else:
        # probe object columns for dates (sampled — cheap on wide tables)
        sample = series.dropna().astype(str).head(50)
        parsed = 0
        if len(sample):
            with pd.option_context("mode.chained_assignment", None):
                try:
                    parsed = pd.to_datetime(sample, errors="coerce", format="mixed").notna().sum()
                except (TypeError, ValueError):
                    parsed = 0
        if len(sample) and parsed >= 0.8 * len(sample):
            semantic = "datetime"
        elif nun == n - int(series.isna().sum()) and nun > 20:
            semantic = "id"
        elif nun <= max(20, int(0.05 * n)):
            semantic = "categorical"
        else:
            semantic = "text"

    top = []
    if semantic == "categorical":
        top = series.value_counts(dropna=True).head(5).index.tolist()
    return ColumnProfile(
        name=str(series.name),
        dtype=dtype,
        semantic=semantic,
        null_frac=round(null_frac, 3),
        n_unique=nun,
        top_values=top,
    )


def profile_workbook(sheets: dict[str, Any], sample_rows: int = 2) -> list[SheetProfile]:
    profiles = []
    for name, df in sheets.items():
        cols = [profile_column(df[c]) for c in df.columns]
        sample = df.head(sample_rows).to_dict(orient="records")
        # keep the sample JSON-safe and short
        for row in sample:
            for k, v in list(row.items()):
                if isinstance(v, float) and np.isnan(v):
                    row[k] = None
                else:
                    row[k] = str(v)[:40] if not isinstance(v, (int, float, bool, type(None))) else v
        ts = df.attrs.get("structure")
        profiles.append(
            SheetProfile(
                name=name,
                shape=(int(df.shape[0]), int(df.shape[1])),
                columns=cols,
                synthetic_header=bool(df.attrs.get("synthetic_header")),
                sample=sample,
                structure=ts.brief() if ts is not None else "",
            )
        )
    return profiles


def detect_join_keys(
    sheets: dict[str, Any], max_pairs: int = 4, sample: int = 500,
) -> list[tuple[str, str, str, str, float]]:
    """Cross-sheet join-key candidates: column pairs whose VALUE SETS
    overlap heavily (Jaccard on sampled uniques) between two sheets.

    The reference's multi-sheet reasoning (smg_autonomous + schema
    linking) leaves the planner to guess join columns from names alone;
    value-overlap detection catches joins where names differ
    ("cust_id" ↔ "customer") and rejects name-equal columns holding
    disjoint domains. Returns (sheetA, colA, sheetB, colB, overlap),
    strongest first."""
    import pandas as pd

    def _key_cols(df):
        out = {}
        for c in df.columns:
            s = df[c].dropna()
            if len(s) == 0 or s.nunique() < 5:
                # join keys carry many distinct values; shared low-card
                # categoricals (status/flag) would otherwise produce
                # spurious 100%-overlap candidates that outrank real keys
                continue
            if pd.api.types.is_float_dtype(s):
                # blank cells promote integer id columns to float64 —
                # keep those (render without the '.0'), drop true floats
                # (measurements almost never join)
                if not bool((s % 1 == 0).all()):
                    continue
                s = s.astype("int64")
            head = s.head(sample)  # sample BEFORE str-converting
            vals = set(head.astype(str))
            if len(vals) > 1:
                out[str(c)] = vals
        return out

    names = list(sheets)
    cols = {n: _key_cols(sheets[n]) for n in names}
    cands: list[tuple[str, str, str, str, float]] = []
    for i, a in enumerate(names):
        for b in names[i + 1 :]:
            for ca, va in cols[a].items():
                for cb, vb in cols[b].items():
                    inter = len(va & vb)
                    if inter < 2:
                        continue
                    jac = inter / max(len(va | vb), 1)
                    if jac >= 0.3:
                        cands.append((a, ca, b, cb, round(jac, 3)))
    cands.sort(key=lambda t: -t[4])
    return cands[:max_pairs]


def workbook_brief(profiles: list[SheetProfile], relevant: dict[str, list[str]] | None = None,
                   join_keys: list[tuple[str, str, str, str, float]] | None = None) -> str:
    """The prompt block: per-sheet profile, schema-linked columns first,
    plus detected cross-sheet join keys (multi-sheet questions plan the
    right merge instead of guessing from column names)."""
    parts = []
    for p in profiles:
        hint = ""
        if relevant and relevant.get(p.name):
            hint = f"\n  relevant columns: {', '.join(relevant[p.name])}"
        parts.append(p.brief() + hint)
    if join_keys:
        joins = "; ".join(
            f"{a}.{ca} ↔ {b}.{cb} (overlap {o:.0%})" for a, ca, b, cb, o in join_keys
        )
        parts.append(f"likely join keys: {joins}")
    return "\n".join(parts)
