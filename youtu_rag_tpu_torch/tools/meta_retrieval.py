"""Metadata-aware (temporal) retrieval toolkit.

Parity with ``utu/rag/rag_tools/meta_retrieval_toolkit.py`` (+
``parser_timeliness.py``, ``utils/date_utils.py``): analyze the query for
temporal intent → epoch time-range filters; widen the window when recall is
poor (``expand_filter_scope``, :369-427); filtered embedding search; merge
results across searches with per-session state (:66-89, :619).

The reference parses dates with an LLM; here a deterministic parser covers
explicit forms (years, months, ISO dates, ranges, simple relative phrases)
and an optional LLM assist slot handles free-form text — hermetic by
default.

The port's copy of ``youtu_rag_tpu/tools/meta_retrieval.py``.
"""

from __future__ import annotations

import calendar
import json
import re
import time
from datetime import datetime
from typing import Any

from ..core.types import RetrievalResult
from ..utils.log import get_logger
from . import register_toolkit
from .base import register_tool
from .kb_search import BaseRAGToolkit, _format_results

logger = get_logger("tools.meta_retrieval")

_YEAR = re.compile(r"\b(19\d{2}|20\d{2})\b")
_YM = re.compile(r"\b(19\d{2}|20\d{2})[-/年](\d{1,2})\b")
_YMD = re.compile(r"\b(19\d{2}|20\d{2})[-/](\d{1,2})[-/](\d{1,2})\b")
_RANGE = re.compile(
    r"\b(?:between|from)\s+(19\d{2}|20\d{2})\s+(?:and|to)\s+(19\d{2}|20\d{2})\b", re.I
)
_RELATIVE = {
    "today": 0,
    "yesterday": 1,
    "last week": 7,
    "past week": 7,
    "last month": 30,
    "past month": 30,
    "last year": 365,
    "past year": 365,
}


_POPULARITY = re.compile(
    r"\b(most popular|most[- ]cited|most downloaded|most viewed|most used|"
    r"widely used|best[- ]known|hottest|highest[- ]rated|trending|"
    r"most starred|popular)\b",
    re.I,
)
# metadata fields tried in order when scoring popularity
_POP_KEYS = ("popularity", "citations", "downloads", "views", "stars", "rating")


def detect_preference(query: str) -> str | None:
    """Detect a ranking preference in the query (ref: the metadata-retrieval
    benchmark's Popularity Preference axis, README.md:816-882 — queries like
    'the most popular X' prefer high-popularity docs over equally-similar
    ones). Returns 'popularity' or None."""
    return "popularity" if _POPULARITY.search(query) else None


def _doc_popularity(metadata: dict | None, key: str | None = None) -> float | None:
    md = metadata or {}
    for k in ((key,) if key else ()) + _POP_KEYS:
        v = md.get(k)
        if isinstance(v, (int, float)):
            return float(v)
    return None


def popularity_blend(
    results: list[RetrievalResult],
    top_k: int,
    key: str | None = None,
    weight: float = 0.5,
) -> list[RetrievalResult]:
    """Blend similarity with normalized popularity metadata:
    final = (1-w)·sim_norm + w·pop_norm over the candidate pool, resorted.
    Docs without popularity metadata get pop_norm 0 (similarity only)."""
    if not results:
        return results
    sims = [r.score for r in results]
    lo, hi = min(sims), max(sims)
    pops = [_doc_popularity(r.chunk.metadata, key) for r in results]
    known = [p for p in pops if p is not None]
    p_lo, p_hi = (min(known), max(known)) if known else (0.0, 0.0)

    def norm(v, a, b):
        return 0.5 if b <= a else (v - a) / (b - a)

    scored = []
    for r, p in zip(results, pops):
        s = (1.0 - weight) * norm(r.score, lo, hi)
        if p is not None:
            s += weight * norm(p, p_lo, p_hi)
        scored.append((s, r))
    scored.sort(key=lambda x: -x[0])
    out = []
    for i, (s, r) in enumerate(scored[:top_k]):
        r.score = float(s)
        r.rank = i + 1
        out.append(r)
    return out


def _epoch(y: int, m: int = 1, d: int = 1) -> int:
    return int(datetime(y, m, d).timestamp())


def parse_time_range(query: str, now: float | None = None) -> tuple[int, int, str] | None:
    """Return (start_epoch, end_epoch, orientation) or None.

    orientation: past | future | range — drives expansion direction
    (ref: expand_filter_scope orientation handling)."""
    now = now or time.time()
    q = query.lower()

    m = _RANGE.search(q)
    if m:
        y1, y2 = int(m.group(1)), int(m.group(2))
        return _epoch(min(y1, y2)), _epoch(max(y1, y2) + 1) - 1, "range"
    m = _YMD.search(q)
    if m:
        y, mo, d = int(m.group(1)), int(m.group(2)), int(m.group(3))
        start = _epoch(y, mo, d)
        return start, start + 86400 - 1, "range"
    m = _YM.search(q)
    if m:
        y, mo = int(m.group(1)), int(m.group(2))
        last = calendar.monthrange(y, mo)[1]
        return _epoch(y, mo, 1), _epoch(y, mo, last) + 86400 - 1, "range"
    for phrase, days in _RELATIVE.items():
        if phrase in q:
            if days == 0:
                start = datetime.fromtimestamp(now).replace(hour=0, minute=0, second=0)
                return int(start.timestamp()), int(now), "past"
            return int(now - days * 86400), int(now), "past"
    m = _YEAR.search(q)
    if m:
        y = int(m.group(1))
        return _epoch(y), _epoch(y + 1) - 1, "range"
    return None


@register_toolkit("meta_retrieval")
class MetaRetrievalToolkit(BaseRAGToolkit):
    """config keys: kb (KnowledgeBase|name), time_key (metadata field,
    default 'publish_ts'), llm_agent (optional time-parsing assist)."""

    def __init__(self, config=None):
        super().__init__(config)
        self.time_key: str = self.config.config.get("time_key", "publish_ts")
        self.popularity_key: str | None = self.config.config.get("popularity_key")
        self.popularity_weight: float = float(self.config.config.get("popularity_weight", 0.5))
        self.llm_agent = self.config.config.get("llm_agent")
        self._sessions: dict[str, dict[str, Any]] = {}

    def _session(self, session_id: str) -> dict[str, Any]:
        return self._sessions.setdefault(
            session_id,
            {"time_range": None, "orientation": None, "preference": None, "results": {}},
        )

    async def search_with_preference(
        self,
        query: str,
        top_k: int = 5,
        filters: dict[str, Any] | None = None,
        preference: str | None = None,
    ) -> list[RetrievalResult]:
        """Dense search honoring a ranking preference: popularity queries
        over-fetch 4× then blend normalized popularity metadata into the
        score (the engine path behind the Popularity Preference rows of the
        metadata-retrieval table, ref README.md:816-882)."""
        if preference == "popularity":
            pool = await self.kb.retriever.retrieve(
                query, top_k=top_k * 4, filters=filters,
                enable_reranking=False, similarity_threshold=0.0,
            )
            return popularity_blend(
                pool, top_k, key=self.popularity_key, weight=self.popularity_weight
            )
        return await self.kb.retriever.retrieve(
            query, top_k=top_k, filters=filters,
            enable_reranking=False, similarity_threshold=0.0,
        )

    @register_tool
    async def query_analysis(self, query: str, session_id: str = "default") -> str:
        """Analyze a query for temporal intent and derive time-range filters.

        Args:
            query: The user query to analyze.
            session_id: Session handle carrying state across tool calls.
        """
        sess = self._session(session_id)
        sess["preference"] = detect_preference(query)
        parsed = parse_time_range(query)
        if parsed is None and self.llm_agent is not None:
            try:
                raw = await self.llm_agent.run(
                    "Extract the time range this query refers to. Reply JSON "
                    '{"start": "YYYY-MM-DD"|null, "end": "YYYY-MM-DD"|null, '
                    f'"orientation": "past|future|range"}}. Query: {query}'
                )
                data = json.loads(raw[raw.index("{") : raw.rindex("}") + 1])
                if data.get("start"):
                    s = int(datetime.fromisoformat(data["start"]).timestamp())
                    e = (
                        int(datetime.fromisoformat(data["end"]).timestamp()) + 86399
                        if data.get("end")
                        else int(time.time())
                    )
                    parsed = (s, e, data.get("orientation", "range"))
            except Exception:  # noqa: BLE001
                logger.exception("LLM time parse failed")
        if parsed is None:
            sess["time_range"] = None
            return json.dumps(
                {"has_temporal_intent": False, "preference": sess["preference"]}
            )
        start, end, orientation = parsed
        sess["time_range"] = [start, end]
        sess["orientation"] = orientation
        return json.dumps(
            {
                "has_temporal_intent": True,
                "time_range": {
                    "start": datetime.fromtimestamp(start).isoformat(),
                    "end": datetime.fromtimestamp(end).isoformat(),
                },
                "orientation": orientation,
                "preference": sess["preference"],
                "filter": {self.time_key: {"$gte": start, "$lte": end}},
            }
        )

    @register_tool
    async def expand_filter_scope(self, session_id: str = "default", factor: float = 2.0) -> str:
        """Widen the session's time window when recall was insufficient.

        Args:
            session_id: Session handle from query_analysis.
            factor: Window growth factor.
        """
        sess = self._session(session_id)
        tr = sess.get("time_range")
        if not tr:
            return "No time filter to expand."
        start, end = tr
        width = max(end - start, 86400)
        extra = int(width * (factor - 1.0))
        orientation = sess.get("orientation") or "range"
        if orientation == "past":
            start -= extra
        elif orientation == "future":
            end += extra
        else:
            start -= extra // 2
            end += extra // 2
        sess["time_range"] = [start, end]
        return json.dumps(
            {
                "time_range": {
                    "start": datetime.fromtimestamp(start).isoformat(),
                    "end": datetime.fromtimestamp(end).isoformat(),
                },
                "filter": {self.time_key: {"$gte": start, "$lte": end}},
            }
        )

    @register_tool
    async def kb_embedding_search(
        self, query: str, top_k: int = 5, session_id: str = "default", use_time_filter: bool = True
    ) -> str:
        """Dense search applying the session's temporal filter.

        Args:
            query: Search text.
            top_k: Number of results.
            session_id: Session handle from query_analysis.
            use_time_filter: Apply the session time-range filter if present.
        """
        sess = self._session(session_id)
        filters: dict[str, Any] | None = None
        if use_time_filter and sess.get("time_range"):
            start, end = sess["time_range"]
            filters = {self.time_key: {"$gte": start, "$lte": end}}
        results = await self.search_with_preference(
            query, top_k=top_k, filters=filters, preference=sess.get("preference")
        )
        sess["results"][query] = results
        return _format_results(results)

    @register_tool
    async def merge_retrieval_results(self, session_id: str = "default", top_k: int = 10) -> str:
        """Merge and dedupe all results gathered this session, score-sorted.

        Args:
            session_id: Session handle.
            top_k: Number of merged results to return.
        """
        sess = self._session(session_id)
        best: dict[str, RetrievalResult] = {}
        for results in sess["results"].values():
            for r in results:
                prev = best.get(r.chunk.id)
                if prev is None or r.score > prev.score:
                    best[r.chunk.id] = r
        merged = sorted(best.values(), key=lambda r: -r.score)[:top_k]
        for i, r in enumerate(merged):
            r.rank = i + 1
        return _format_results(merged)
