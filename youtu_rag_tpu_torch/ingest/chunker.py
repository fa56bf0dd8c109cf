"""Text chunking strategies.

Behavior parity with the reference splitters
(``utu/rag/knowledge_builder/chunker.py:10-349``), verified by golden
tests: the recursive splitter cascades separators ["\\n\\n", "\\n", ". ",
" ", ""] accumulating pieces up to chunk_size with suffix overlap; the
hierarchical splitter groups markdown lines under their H1/H2 headers,
packs whole lines up to chunk_size, prefixes each chunk with its header
context, and applies header-aware overlap. Pure host-side string work —
feeds the batched device embedder downstream."""

from __future__ import annotations

import re
from typing import Any

from ..core.config import ChunkingConfig
from ..core.types import BaseTextSplitter

_DEFAULT_SEPARATORS = ["\n\n", "\n", ". ", " ", ""]


class RecursiveTextSplitter(BaseTextSplitter):
    """Separator-cascade splitter with greedy accumulation + overlap."""

    def __init__(self, config: ChunkingConfig | None = None):
        self.config = config or ChunkingConfig(strategy="recursive")
        self.separators = self.config.separators or list(_DEFAULT_SEPARATORS)

    def split_text(self, text: str, metadata: dict[str, Any] | None = None) -> list[str]:
        return self._split(text, self.separators)

    # The accumulate/recurse/overlap order below matches the reference
    # exactly (chunker.py:34-122): overlap is applied per recursion level,
    # and final chunks are stripped and emptiness-filtered.
    def _split(self, text: str, separators: list[str]) -> list[str]:
        if not separators or separators[0] == "":
            return self._fixed_windows(text)

        sep, rest = separators[0], separators[1:]
        size = self.config.chunk_size
        keep = self.config.keep_separator

        pieces = text.split(sep)
        out: list[str] = []
        acc = ""
        for i, piece in enumerate(pieces):
            candidate = acc + piece
            if keep and i < len(pieces) - 1:
                candidate += sep
            if len(candidate) <= size:
                acc = candidate
                continue
            if acc:
                out.append(acc)
            if len(piece) > size:
                out.extend(self._split(piece, rest))
                acc = ""
            else:
                acc = piece + (sep if keep and i < len(pieces) - 1 else "")
        if acc:
            out.append(acc)

        if self.config.chunk_overlap > 0 and len(out) > 1:
            ov = self.config.chunk_overlap
            out = [out[0]] + [out[i - 1][-ov:] + out[i] for i in range(1, len(out))]

        return [c.strip() for c in out if c.strip()]

    def _fixed_windows(self, text: str) -> list[str]:
        size = self.config.chunk_size
        # overlap >= size passes config validation (overlap caps at 1000
        # regardless of size); an unguarded stride would be <= 0 — empty
        # output (silently unindexed text) or a range() ValueError
        stride = size - self.config.chunk_overlap
        if stride <= 0:
            stride = max(size // 2, 1)
        return [text[i : i + size] for i in range(0, len(text), stride)]


class HierarchicalMarkdownSplitter(BaseTextSplitter):
    """H1/H2-aware markdown splitter for hierarchically chunked docs.

    Designed for the ``_chunklevel.md`` output of hierarchical LLM chunking
    (ref: chunker.py:124-349 consuming chunk_processor.py output): whole
    lines are never cut; every chunk carries its header path."""

    _H1 = re.compile(r"^#\s+(.+)$")
    _H2 = re.compile(r"^##\s+(.+)$")

    def __init__(self, config: ChunkingConfig | None = None):
        self.config = config or ChunkingConfig(strategy="hierarchical")

    def split_text(self, text: str, metadata: dict[str, Any] | None = None) -> list[str]:
        if not text or not text.strip():
            return []
        chunks: list[str] = []
        for header, lines in self._sections(text):
            chunks.extend(self._pack_section(header, lines))
        return [c.strip() for c in chunks if c.strip()]

    def _sections(self, text: str):
        """Yield (header_text, content_lines) per H1/H2 section.

        Header-only sections (consecutive headers with no body) still
        yield — a heading is indexable text and dropping it would lose
        e.g. '# Overview' directly followed by '# Details'."""
        h1 = h2 = None
        lines: list[str] = []
        saw_header = False

        def flush():
            nonlocal lines, saw_header
            if lines or saw_header:
                parts = []
                if h1:
                    parts.append(f"# {h1}")
                if h2:
                    parts.append(f"## {h2}")
                if parts or lines:
                    yield "\n".join(parts), lines
                lines = []
            saw_header = False

        for line in text.split("\n"):
            m1 = self._H1.match(line)
            if m1:
                yield from flush()
                h1, h2 = m1.group(1).strip(), None
                saw_header = True
                continue
            m2 = self._H2.match(line)
            if m2:
                yield from flush()
                h2 = m2.group(1).strip()
                saw_header = True
                continue
            if line.strip():
                lines.append(line)
        yield from flush()

    def _pack_section(self, header: str, lines: list[str]) -> list[str]:
        size = self.config.chunk_size
        if not lines:
            return [header] if header else []

        groups: list[list[str]] = []
        cur: list[str] = []
        cur_len = len(header)
        for line in lines:
            need = len(line) + 1
            if cur and cur_len + need > size:
                groups.append(cur)
                cur = [line]
                cur_len = len(header) + need
            else:
                cur.append(line)
                cur_len += need
        if cur:
            groups.append(cur)

        def with_header(body: str) -> str:
            return f"{header}\n\n{body}" if header else body

        chunks = [with_header("\n".join(g)) for g in groups]

        ov = self.config.chunk_overlap
        if ov > 0 and len(chunks) > 1:
            bodies = ["\n".join(g) for g in groups]
            chunks = [chunks[0]] + [
                with_header(f"{bodies[i - 1][-ov:].lstrip()}\n{bodies[i]}")
                for i in range(1, len(chunks))
            ]
        return chunks


def get_splitter(config: ChunkingConfig | None = None) -> BaseTextSplitter:
    config = config or ChunkingConfig()
    if config.strategy == "hierarchical":
        return HierarchicalMarkdownSplitter(config)
    return RecursiveTextSplitter(config)
