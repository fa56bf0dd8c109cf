"""Plain recursive character splitter, the semantics of the reference
project's ``RecursiveTextSplitter``: split on the first separator of
["\\n\\n", "\\n", ". ", " ", ""], keep each separator on its piece, pack
pieces greedily up to ``size`` characters, recurse into a piece that alone
is longer, prefix every chunk after the first with the last ``overlap``
characters of the one before (at each level), strip, drop empty chunks; a
text with no separator left is cut into windows of ``size`` every
``size - overlap`` characters. Imports nothing of the program."""

from __future__ import annotations

SEPARATORS = ["\n\n", "\n", ". ", " ", ""]


def split(text: str, size: int, overlap: int, seps: list[str] = SEPARATORS) -> list[str]:
    if not seps or seps[0] == "":
        stride = size - overlap if size > overlap else max(size // 2, 1)
        return [text[i:i + size] for i in range(0, len(text), stride)]
    sep = seps[0]
    parts = text.split(sep)
    chunks: list[str] = []
    cur = ""
    for i, part in enumerate(parts):
        tail = sep if i < len(parts) - 1 else ""
        if len(cur + part + tail) <= size:
            cur = cur + part + tail
            continue
        if cur:
            chunks.append(cur)
        if len(part) > size:
            chunks.extend(split(part, size, overlap, seps[1:]))
            cur = ""
        else:
            cur = part + tail
    if cur:
        chunks.append(cur)
    if overlap > 0 and len(chunks) > 1:
        chunks = [chunks[0]] + [chunks[i - 1][-overlap:] + chunks[i] for i in range(1, len(chunks))]
    return [c.strip() for c in chunks if c.strip()]
