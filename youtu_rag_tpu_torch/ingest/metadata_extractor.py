"""Metadata extraction: publish_date / key_timepoints / authors / summary.

A copy of ``youtu_rag_tpu/ingest/metadata_extractor.py`` (host only).

Parity with ``utu/rag/knowledge_builder/metadata_extractor.py:18-259``
(LLM extraction from filename + 500-char preview, with date validation and
batch mode). Hermetic default: a deterministic regex extractor covers
explicit dates/authors; an LLMAgent upgrades quality when configured —
the same split as the time parser in tools/meta_retrieval."""

from __future__ import annotations

import json
import re
from datetime import datetime
from typing import Any

from ..utils.log import get_logger

logger = get_logger("ingest.metadata")

_DATE_PATTERNS = [
    (re.compile(r"\b(19\d{2}|20\d{2})[-/._](\d{1,2})[-/._](\d{1,2})\b"), "%Y-%m-%d"),
    (re.compile(r"\b(19\d{2}|20\d{2})年(\d{1,2})月(\d{1,2})日"), "%Y-%m-%d"),
    (re.compile(r"\b(19\d{2}|20\d{2})[-/._](\d{1,2})\b"), "%Y-%m"),
    (re.compile(r"\b(19\d{2}|20\d{2})\b"), "%Y"),
]
_AUTHOR_RE = re.compile(
    r"(?:author[s]?|by|作者)[:：\s]+([A-Z][A-Za-z. ]{2,40}|[一-鿿]{2,8})", re.IGNORECASE
)

PREVIEW_CHARS = 500  # ref: 500-char preview window

EXTRACT_PROMPT = """Extract metadata from this document preview.

Filename: {filename}
Preview:
{preview}

Reply JSON only:
{{"publish_date": "YYYY-MM-DD"|null, "key_timepoints": ["YYYY-MM-DD", ...],
 "authors": ["name", ...], "summary": "<one sentence>"}}"""


def validate_date(s: str | None) -> str | None:
    """Normalize to ISO date; reject impossible dates (ref date validation)."""
    if not s:
        return None
    for fmt in ("%Y-%m-%d", "%Y/%m/%d", "%Y-%m", "%Y"):
        try:
            d = datetime.strptime(str(s).strip(), fmt)
            if 1900 <= d.year <= 2100:
                return d.strftime("%Y-%m-%d")
        except ValueError:
            continue
    return None


class MetadataExtractor:
    def __init__(self, llm_agent=None):
        self.llm_agent = llm_agent

    def _heuristic(self, filename: str, preview: str) -> dict[str, Any]:
        text = f"{filename}\n{preview}"
        dates: list[str] = []
        for pattern, fmt in _DATE_PATTERNS:
            for m in pattern.finditer(text):
                groups = m.groups()
                try:
                    if fmt == "%Y-%m-%d":
                        d = datetime(int(groups[0]), int(groups[1]), int(groups[2]))
                    elif fmt == "%Y-%m":
                        d = datetime(int(groups[0]), int(groups[1]), 1)
                    else:
                        d = datetime(int(groups[0]), 1, 1)
                except ValueError:
                    continue
                iso = d.strftime("%Y-%m-%d")
                if iso not in dates:
                    dates.append(iso)
            if dates:
                break  # most-specific pattern wins
        authors = [m.group(1).strip() for m in _AUTHOR_RE.finditer(preview)][:5]
        first_line = next((ln.strip() for ln in preview.split("\n") if ln.strip()), "")
        return {
            "publish_date": dates[0] if dates else None,
            "key_timepoints": dates[:10],
            "authors": authors,
            "summary": first_line[:200],
        }

    async def extract_metadata(self, filename: str, content: str) -> dict[str, Any]:
        preview = content[:PREVIEW_CHARS]
        if self.llm_agent is not None:
            try:
                raw = await self.llm_agent.run(
                    EXTRACT_PROMPT.format(filename=filename, preview=preview)
                )
                data = json.loads(raw[raw.index("{") : raw.rindex("}") + 1])
                data["publish_date"] = validate_date(data.get("publish_date"))
                data["key_timepoints"] = [
                    d for d in map(validate_date, data.get("key_timepoints") or []) if d
                ]
                data.setdefault("authors", [])
                data.setdefault("summary", "")
                return data
            except Exception:  # noqa: BLE001
                logger.exception("LLM metadata extraction failed; falling back")
        return self._heuristic(filename, preview)

    async def extract_batch(self, items: list[tuple[str, str]]) -> list[dict[str, Any]]:
        return [await self.extract_metadata(f, c) for f, c in items]


def metadata_to_device_fields(meta: dict[str, Any]) -> dict[str, Any]:
    """Flatten extracted metadata into filterable index fields: ISO dates →
    epoch seconds (int) so temporal filters compile to device masks."""
    out: dict[str, Any] = {}
    if meta.get("publish_date"):
        out["publish_date"] = meta["publish_date"]
        out["publish_ts"] = int(datetime.strptime(meta["publish_date"], "%Y-%m-%d").timestamp())
    if meta.get("authors"):
        out["author"] = meta["authors"][0]
    if meta.get("summary"):
        out["summary"] = meta["summary"][:200]
    return out
