"""Messy-table structuring: multi-row headers, merged-cell spans, banners.

Parity surface: the reference's table-structure utilities —
``integrations/DTR/utils/meta_extractor.py:50-158`` (multi-row header
detection, merged-cell unmerge+fill, hierarchy triplets) and
``integrations/DTR/utils/smart_table_processor.py:25-418`` (header-end
detection, composite column naming, name cleaning/unique-ing, numeric
coercion, empty-row/col cleanup).

Redesigned to operate on raw DataFrames instead of openpyxl worksheets:
after any engine-less parse (CSV export, ``read_excel(header=None)``) a
merged header cell surfaces as a value followed by blanks across its span,
so horizontal forward-fill over the *non-leaf* header rows is the
unmerge-and-fill equivalent — no openpyxl needed (the image has none).
The reference's dataset-specific keyword lists ('civilian', 'HOUSEHOLD
DATA', 'Year' renames) are replaced by structural heuristics: full-width
single-value rows are banners, consecutive-duplicate path segments are
deduped, and a leading integer column in [1500, 2200] is annotated (not
renamed) as year-like.

The port's copy of ``youtu_rag_tpu/integrations/dtr/table_structure.py``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any

__all__ = [
    "TableStructure",
    "detect_header_end",
    "structure_sheet",
    "clean_frame",
    "fill_down_group_labels",
]


@dataclass
class TableStructure:
    """What the structurer learned about one sheet."""

    header_rows: int = 1
    title: str = ""
    columns: list[str] = field(default_factory=list)
    triplets: list[str] = field(default_factory=list)  # hierarchy facts for prompts
    notes: list[str] = field(default_factory=list)  # filled-down cols, year-like, …

    def brief(self) -> str:
        bits = []
        if self.title:
            bits.append(f"title: {self.title!r}")
        if self.header_rows > 1:
            bits.append(f"{self.header_rows}-row header")
        if self.triplets:
            bits.append("hierarchy: " + "; ".join(self.triplets[:8]))
        bits.extend(self.notes)
        return " | ".join(bits)


# ----------------------------------------------------------------- values


def _is_numeric_val(v) -> bool:
    """Numeric after comma-stripping (ref smart_table_processor.py:169-186)."""
    import pandas as pd

    if v is None or (isinstance(v, float) and v != v):
        return False
    if isinstance(v, (int, float)):
        return True
    if isinstance(v, str):
        try:
            float(v.replace(",", ""))
            return True
        except ValueError:
            return False
    return bool(pd.api.types.is_number(v))


def _clean_name(name: str, max_len: int = 50) -> str:
    """Column-name hygiene (ref smart_table_processor.py:343-360)."""
    clean = str(name).replace("\n", " ").replace("\r", " ")
    clean = " ".join(clean.split())
    clean = re.sub(r"[^\w\s-]", "", clean, flags=re.UNICODE)
    return clean[:max_len].strip()


def _unique_names(columns: list[str]) -> list[str]:
    """Suffix duplicates name, name_1, name_2 (ref :361-376)."""
    seen: dict[str, int] = {}
    out = []
    for col in columns:
        if col in seen:
            seen[col] += 1
            out.append(f"{col}_{seen[col]}")
        else:
            seen[col] = 0
            out.append(col)
    return out


# ------------------------------------------------------------ header scan


def detect_header_end(df_raw, max_scan: int = 15) -> int:
    """Index of the first data row in a header=None frame.

    A row is data when ≥50% of its non-null values are numeric and at
    least two are (ref smart_table_processor.py:147-167 ratio +
    meta_extractor.py:68-71 absolute floor). 0 means the sheet is
    headerless; no numeric row in the scan window falls back to 1
    (first row is the header — the all-text-table case, ref
    meta_extractor.py:57 default).
    """
    n = min(max_scan, len(df_raw))
    for idx in range(n):
        row = df_raw.iloc[idx]
        vals = [v for v in row if not _isna(v)]
        if not vals:
            continue  # blank padding row — keep scanning
        numeric = sum(_is_numeric_val(v) for v in vals)
        if numeric >= 2 and numeric / len(vals) >= 0.5:
            return idx
    return min(1, len(df_raw))


def _isna(v) -> bool:
    return v is None or (isinstance(v, float) and v != v)


def _banner_split(header_block) -> tuple[str, int]:
    """Leading rows with a single distinct non-null value are banners
    (title rows spanning the sheet) — the structural form of the
    reference's hardcoded 'HOUSEHOLD DATA'/'ANNUAL AVERAGES' skip list
    (smart_table_processor.py:222). Returns (title, first_level_row)."""
    titles = []
    start = 0
    width = header_block.shape[1]
    for idx in range(len(header_block)):
        vals = [str(v).strip() for v in header_block.iloc[idx] if not _isna(v)]
        distinct = {v for v in vals if v}
        # keep at least one row for column names
        if len(distinct) == 1 and width >= 2 and idx < len(header_block) - 1:
            titles.append(next(iter(distinct)))
            start = idx + 1
        else:
            break
    return " — ".join(titles), start


# ------------------------------------------------------- structure + names


def _structure_columns(header_block) -> tuple[list[str], list[str]]:
    """Composite names + hierarchy triplets from a multi-row header block.

    Non-leaf rows are forward-filled horizontally (merged-span recovery,
    ref meta_extractor.py:142-158); a column's name is its top-down path
    with blanks and consecutive duplicates dropped, joined with '_'
    (ref smart_table_processor.py:211-257). Triplets mirror
    meta_extractor.py:97-141: top-level values are column headers of the
    table; a non-leaf value spanning >1 column has_child each distinct
    value beneath its span.
    """
    n_levels, n_cols = header_block.shape
    # grid[level][col] = cleaned cell or ""
    grid = [
        ["" if _isna(v) else _clean_name(v) for v in header_block.iloc[lvl]]
        for lvl in range(n_levels)
    ]
    # spacer columns: blank at every level — never receive ffill
    spacer = [all(not grid[lvl][c] for lvl in range(n_levels)) for c in range(n_cols)]
    filled = [row[:] for row in grid]
    for lvl in range(n_levels - 1):  # leaf level is NOT filled
        last = ""
        for c in range(n_cols):
            if spacer[c]:
                last = ""
                continue
            if filled[lvl][c]:
                last = filled[lvl][c]
            elif last:
                filled[lvl][c] = last

    columns = []
    for c in range(n_cols):
        path = []
        for lvl in range(n_levels):
            v = filled[lvl][c]
            if v and (not path or path[-1] != v):
                path.append(v)
        columns.append("_".join(path) if path else f"col_{c}")
    columns = _unique_names(columns)

    triplets = []
    seen = set()
    for v in filled[0]:
        if v and v not in seen:
            triplets.append(f'(table, has_column_header, "{v}")')
            seen.add(v)
    for lvl in range(n_levels - 1):
        c = 0
        while c < n_cols:
            v = filled[lvl][c]
            if not v:
                c += 1
                continue
            end = c
            while end + 1 < n_cols and filled[lvl][end + 1] == v:
                end += 1
            if end > c:  # spans >1 column → a merged parent
                kids = []
                for cc in range(c, end + 1):
                    kid = filled[lvl + 1][cc]
                    if kid and kid != v and kid not in kids:
                        kids.append(kid)
                for kid in kids:
                    triplets.append(f'("{v}", has_child, "{kid}")')
            c = end + 1
    return columns, triplets


# ------------------------------------------------------------ data cleanup


def clean_frame(df):
    """Drop all-null rows/cols, coerce comma-formatted numerics, reset
    index (ref smart_table_processor.py:377-418)."""
    import pandas as pd

    df = df.dropna(how="all").dropna(axis=1, how="all")
    for col in df.columns:
        s = df[col]
        # object in classic pandas, dedicated `str` dtype in pandas 3
        if s.dtype == object or pd.api.types.is_string_dtype(s):
            stripped = s.astype(str).str.replace(",", "", regex=False)
            converted = pd.to_numeric(stripped, errors="coerce")
            # only adopt when most original non-null values survive
            non_null = s.notna().sum()
            if non_null and converted.notna().sum() / non_null > 0.5:
                df[col] = converted.where(s.notna())
    return df.reset_index(drop=True)


def fill_down_group_labels(df, max_cols: int = 2) -> tuple[Any, list[str]]:
    """Forward-fill leading label columns whose blanks are merged-cell
    artifacts (value-then-blank runs). The vertical counterpart of
    meta_extractor.py:142-158 unmerge+fill, gated structurally: object
    dtype, first value present, 10–90% blank, and low cardinality
    relative to the run count. Returns (df, names_of_filled_columns)."""
    import pandas as pd

    filled = []
    for col in list(df.columns)[:max_cols]:
        s = df[col]
        text_like = s.dtype == object or pd.api.types.is_string_dtype(s)
        if not text_like or len(s) < 4:
            continue
        null_frac = s.isna().mean()
        if not (0.1 <= null_frac <= 0.9) or _isna(s.iloc[0]):
            continue
        # blanks must directly follow values (runs), and each value must
        # head a run — i.e. distinct values ≈ number of runs
        runs = 0
        prev_blank = True
        for v in s:
            if not _isna(v):
                if prev_blank or runs == 0:
                    runs += 1
                prev_blank = False
            else:
                prev_blank = True
        n_vals = s.notna().sum()
        if n_vals and s.nunique(dropna=True) <= n_vals and runs >= 2:
            df[col] = s.ffill()
            filled.append(str(col))
    return df, filled


# --------------------------------------------------------------- top level


def structure_sheet(df_raw, fill_down: bool = True):
    """header=None frame → (clean df, TableStructure).

    The one-call equivalent of the reference's
    ``SmartTableProcessor.process_excel`` (smart_table_processor.py:25-69)
    + ``MetaExtractor.extract_meta_info`` header/hierarchy portion.
    """
    import pandas as pd

    ts = TableStructure()
    header_end = detect_header_end(df_raw)
    ts.header_rows = header_end

    if header_end == 0:  # headerless: synthetic names
        df = df_raw.copy()
        df.columns = [f"col_{i}" for i in range(df.shape[1])]
        ts.columns = list(df.columns)
        ts.notes.append("headerless: synthetic col names")
    else:
        block = df_raw.iloc[:header_end]
        title, level_start = _banner_split(block)
        ts.title = title
        names_block = block.iloc[level_start:]
        if len(names_block) == 0:  # every header row was a banner
            names_block = block.iloc[-1:]
        columns, triplets = _structure_columns(names_block)
        ts.triplets = triplets
        df = df_raw.iloc[header_end:].copy()
        df.columns = columns[: df.shape[1]]
        ts.header_rows = header_end

    df = clean_frame(df)
    ts.columns = [str(c) for c in df.columns]

    if fill_down and len(df):
        df, filled = fill_down_group_labels(df)
        if filled:
            ts.notes.append(f"filled-down group labels: {', '.join(filled)}")

    # year-like annotation (structural version of the ref's forced
    # 'Year' rename, smart_table_processor.py:270-293): note, don't rename
    if len(df.columns) and len(df) >= 3:
        first = pd.to_numeric(df[df.columns[0]], errors="coerce").dropna()
        if (
            len(first) >= 3
            and first.min() >= 1500
            and first.max() <= 2200
            and (first == first.astype(int)).all()
        ):
            ts.notes.append(f"first column {df.columns[0]!r} is year-like")

    return df, ts
