"""Hierarchical LLM chunking ("HiChunk") client.

A copy of ``youtu_rag_tpu/ingest/hichunk.py``; the remote client posts
through ``utils/http.py``, which imports ``httpx`` only when it is called.

Capability parity with ``utu/rag/knowledge_builder/chunk_processor.py:
218-541``: split a document into sentences (EN/ZH), feed indexed-line
windows to a chunk-point model with residual carry-over between windows,
collect hierarchical chunk points per level, and render a
``*_chunklevel.md`` markdown whose H1/H2 headers encode the hierarchy —
the exact input the HierarchicalMarkdownSplitter consumes.

Backends:
- remote HiChunk-style endpoint (OpenAI-compatible, model answers with
  ``level<TAB>line_index`` records) when ``base_url`` is configured;
- ``HeuristicChunkPointModel`` — deterministic offline fallback inferring
  chunk points from markdown headers and paragraph boundaries, so the
  full pipeline stays hermetic."""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from ..utils.http import post_json_with_retry
from ..utils.log import get_logger

logger = get_logger("ingest.hichunk")

_SENT_SPLIT = re.compile(r"(?<=[.!?。！？;；])\s+|\n")

HICHUNK_PROMPT = (
    "You segment documents hierarchically. Given numbered lines, output the "
    "chunk start points as lines of 'level<TAB>line_index' (level 1 = top). "
    "Output nothing else.\n\n"
)


def split_sentences(text: str, line_max_len: int = 256) -> list[str]:
    """Sentence segmentation for EN/ZH with a hard length cap
    (ref: sentence splitting in chunk_processor)."""
    out: list[str] = []
    for raw in _SENT_SPLIT.split(text):
        s = raw.strip()
        if not s:
            continue
        while len(s) > line_max_len:
            out.append(s[:line_max_len])
            s = s[line_max_len:]
        out.append(s)
    return out


@dataclass
class ChunkPoint:
    level: int  # 1-based; 1 = coarsest
    line: int  # global sentence index


class HeuristicChunkPointModel:
    """Deterministic chunk-point inference: markdown headers → level 1/2,
    long-gap paragraph starts → level 2."""

    def infer(self, indexed_lines: list[tuple[int, str]]) -> list[ChunkPoint]:
        points = []
        for idx, line in indexed_lines:
            if re.match(r"^#\s+", line):
                points.append(ChunkPoint(1, idx))
            elif re.match(r"^##+\s+", line):
                points.append(ChunkPoint(2, idx))
        if not points and indexed_lines:
            # paragraph-ish fallback: every ~8 sentences starts a chunk
            for pos, (idx, _) in enumerate(indexed_lines):
                if pos % 8 == 0:
                    points.append(ChunkPoint(1, idx))
        return points


class RemoteChunkPointModel:
    """HiChunk-style endpoint client (ref: call_llm with retries)."""

    def __init__(self, base_url: str, model: str = "HiChunk", timeout: float = 120.0):
        self.base_url = base_url
        self.model = model
        self.timeout = timeout

    async def infer_async(self, indexed_lines: list[tuple[int, str]]) -> list[ChunkPoint]:
        import httpx

        text = HICHUNK_PROMPT + "".join(f"[{i}] {s}\n" for i, s in indexed_lines)
        try:
            body = await post_json_with_retry(
                f"{self.base_url.rstrip('/')}/v1/chat/completions",
                {
                    "model": self.model,
                    "messages": [{"role": "user", "content": text}],
                    "temperature": 0.0,
                    "max_tokens": 4096,
                },
                timeout=self.timeout,
                max_retries=3,
                backoff=2.0,
                log=logger,
            )
            out = body["choices"][0]["message"]["content"] or ""
        except (RuntimeError, httpx.HTTPError, KeyError, IndexError, TypeError, ValueError) as e:
            raise RuntimeError(f"HiChunk endpoint failed: {e}") from e
        return self._parse(out)

    @staticmethod
    def _parse(output: str) -> list[ChunkPoint]:
        points = []
        for line in output.strip().split("\n"):
            m = re.match(r"\s*(\d+)[\t ,]+(\d+)\s*$", line)
            if m:
                points.append(ChunkPoint(int(m.group(1)), int(m.group(2))))
        return points


@dataclass
class HiChunkEngine:
    """Windowed hierarchical chunk-point inference with residual carry.

    Mirrors the reference flow: sentences stream through fixed-size
    windows; each window keeps the last ``residual_lines`` sentences of the
    previous one so boundaries never fall between windows blindly."""

    window_size: int = 4000  # characters per window
    line_max_len: int = 256
    max_level: int = 2
    residual_lines: int = 4
    model: object = field(default_factory=HeuristicChunkPointModel)

    async def chunk_points(self, text: str) -> tuple[list[str], list[ChunkPoint]]:
        sentences = split_sentences(text, self.line_max_len)
        points: list[ChunkPoint] = []
        start = 0
        carry: list[tuple[int, str]] = []
        while start < len(sentences):
            window: list[tuple[int, str]] = list(carry)
            used = sum(len(s) + 8 for _, s in window)
            consumed = 0
            while start < len(sentences):
                s = sentences[start]
                if used + len(s) + 8 > self.window_size and window and consumed:
                    break
                # `consumed` guard: a window must always take at least one
                # NEW sentence — when the carry alone fills the budget
                # (small window_size vs line_max_len) breaking here would
                # rebuild the identical carry and loop forever
                window.append((start, s))
                used += len(s) + 8
                start += 1
                consumed += 1
            infer = getattr(self.model, "infer_async", None)
            got = await infer(window) if infer else self.model.infer(window)
            seen = {(p.level, p.line) for p in points}
            for p in got:
                if 1 <= p.level <= self.max_level and (p.level, p.line) not in seen:
                    points.append(p)
            carry = window[-self.residual_lines :] if start < len(sentences) else []
        points.sort(key=lambda p: (p.line, p.level))
        return sentences, points

    async def to_chunklevel_markdown(self, text: str) -> str:
        """Render hierarchy as H1/H2 markdown (``*_chunklevel.md``)."""
        sentences, points = await self.chunk_points(text)
        by_line: dict[int, int] = {}
        for p in points:
            by_line[p.line] = min(by_line.get(p.line, p.level), p.level)
        out: list[str] = []
        section = 0
        for i, s in enumerate(sentences):
            lvl = by_line.get(i)
            if lvl is not None:
                section += 1
                header = "#" * lvl
                title = re.sub(r"^#+\s*", "", s)[:80]
                out.append(f"{header} {title or f'Section {section}'}")
                if re.match(r"^#+\s+", s):
                    continue  # the sentence was itself a header
            out.append(s)
        return "\n".join(out)


def get_hichunk_engine(base_url: str | None = None, **kwargs) -> HiChunkEngine:
    import os

    url = base_url or os.environ.get("YRT_CHUNK_URL") or os.environ.get("UTU_CHUNK_URL")
    model = RemoteChunkPointModel(url) if url else HeuristicChunkPointModel()
    return HiChunkEngine(model=model, **kwargs)
