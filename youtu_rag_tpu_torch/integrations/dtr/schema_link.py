"""Element-index schema linking for multi-sheet workbooks.

Capability counterpart of the reference's schema-linking module
(``integrations/DTR/src/modules/schema_linking.py:38-542``: rank the
meta-graph's tables/columns/values against the question before prompting)
and of the text2sql element retrieval
(``utu/rag/knowledge_retrieval/chroma_retrical_text2sql.py:45-199``: query
``index_element`` vectors instead of matching strings).

Design: every sheet and column becomes an *element document* — name,
column list, and sampled cell values — embedded with the deterministic
hash embedder, then **idf-reweighted in hashed space**: dimensions that
fire in most elements (generic tokens — total, name, date, id — that
appear on every sheet) are downweighted by log(N/df) before cosine. That
is the failure mode of raw lexical overlap (``smg.link_sheets``): a wrong
sheet sharing three ubiquitous column words outscores the right sheet's
single rare-token match. Tests pin exactly that case.

Deterministic and offline — no LLM, no network; an LLM refinement can sit
on top (the reference's prompt-based linker) but the ranking itself is
the element index.

The port's copy of ``youtu_rag_tpu/integrations/dtr/schema_link.py``.
"""

from __future__ import annotations

import numpy as np

from ...models.embedder import HashEmbedder


def _element_text(kind: str, name: str, extra: list[str]) -> str:
    return f"{kind} {name} " + " ".join(str(x) for x in extra)


class ElementIndex:
    """Vector index over sheet/column elements of one workbook."""

    def __init__(self, sheets: dict, dim: int = 512, sample_rows: int = 12):
        self._embedder = HashEmbedder(dim=dim)
        self.elements: list[dict] = []  # {kind, sheet, column?, text}
        for sheet_name, df in sheets.items():
            cols = [str(c) for c in df.columns]
            self.elements.append(
                {
                    "kind": "sheet",
                    "sheet": sheet_name,
                    "text": _element_text("sheet", str(sheet_name), cols),
                }
            )
            for c in cols:
                try:
                    vals = df[c].dropna().astype(str).head(sample_rows).tolist()
                except Exception:  # noqa: BLE001 - odd dtypes sample empty
                    vals = []
                self.elements.append(
                    {
                        "kind": "column",
                        "sheet": sheet_name,
                        "column": c,
                        "text": _element_text("column", c, [str(sheet_name)] + vals),
                    }
                )
        vecs = self._embedder.embed_batch([e["text"] for e in self.elements])
        # idf reweighting in hashed space: df = #elements lighting the dim
        n = max(len(self.elements), 1)
        df_count = np.count_nonzero(vecs > 0, axis=0).astype(np.float32)
        self._idf = np.log1p(n / np.maximum(df_count, 1.0))
        w = vecs * self._idf[None, :]
        norms = np.linalg.norm(w, axis=1, keepdims=True)
        self._vecs = w / np.maximum(norms, 1e-12)

    def _embed_query(self, question: str) -> np.ndarray:
        q = self._embedder.embed_batch([question])[0] * self._idf
        return q / max(np.linalg.norm(q), 1e-12)

    def search(self, question: str, top_k: int = 10) -> list[tuple[dict, float]]:
        q = self._embed_query(question)
        sims = self._vecs @ q
        order = np.argsort(-sims)[:top_k]
        return [(self.elements[i], float(sims[i])) for i in order]

    def link(
        self, question: str, top_n: int = 4, col_threshold: float = 0.05
    ) -> list[tuple[str, float, list[str]]]:
        """Rank sheets → (sheet, score, matched_columns), the same contract
        as the lexical ``smg.link_sheets`` so callers swap transparently.

        Sheet score = its sheet-element similarity + the best column-element
        similarity (a strong column match should pull in its sheet even
        when the sheet name itself is opaque)."""
        q = self._embed_query(question)
        sims = self._vecs @ q
        sheet_score: dict[str, float] = {}
        col_best: dict[str, float] = {}
        matched: dict[str, list[tuple[str, float]]] = {}
        for e, s in zip(self.elements, sims):
            name = e["sheet"]
            if e["kind"] == "sheet":
                sheet_score[name] = sheet_score.get(name, 0.0) + float(s)
            else:
                col_best[name] = max(col_best.get(name, 0.0), float(s))
                if s > col_threshold:
                    matched.setdefault(name, []).append((e["column"], float(s)))
        out = []
        for name in sheet_score:
            score = sheet_score[name] + col_best.get(name, 0.0)
            cols = [c for c, _ in sorted(matched.get(name, []), key=lambda t: -t[1])[:8]]
            out.append((name, round(score, 6), cols))
        out.sort(key=lambda t: -t[1])
        return out[:top_n]


def link_sheets_element(
    question: str, sheets: dict, top_n: int = 4
) -> list[tuple[str, float, list[str]]]:
    """One-shot convenience wrapper (builds the index per call — fine at
    workbook scale; hold an ElementIndex for repeated questions)."""
    return ElementIndex(sheets).link(question, top_n=top_n)
