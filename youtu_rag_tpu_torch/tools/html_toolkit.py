"""HTML report toolkit: markdown → styled standalone HTML.

Parity with ``utu/rag/rag_tools/html_toolkit.py:445-574`` (report
designer/painter): agents turn analysis output into a polished HTML report
file. The converter is self-contained (headers, lists, tables, code,
emphasis) — no markdown dependency.

The port's copy of ``youtu_rag_tpu/tools/html_toolkit.py``.
"""

from __future__ import annotations

import html
import re
import tempfile
from pathlib import Path

from . import register_toolkit
from .base import AsyncBaseToolkit, register_tool

_CSS = """
body { font-family: system-ui, sans-serif; max-width: 860px; margin: 40px auto;
       padding: 0 24px; color: #1c1e21; line-height: 1.6; }
h1 { border-bottom: 2px solid #4f9cff; padding-bottom: 8px; }
h2 { margin-top: 32px; color: #21437a; }
table { border-collapse: collapse; margin: 16px 0; width: 100%; }
th, td { border: 1px solid #d5dbe3; padding: 8px 12px; text-align: left; }
th { background: #f0f4fa; }
code { background: #f4f4f6; padding: 2px 5px; border-radius: 4px; font-size: 90%; }
pre { background: #14161a; color: #e8e8e8; padding: 14px; border-radius: 8px;
      overflow-x: auto; }
pre code { background: none; color: inherit; }
blockquote { border-left: 4px solid #4f9cff; margin: 0; padding: 4px 16px;
             color: #4a5568; background: #f7faff; }
"""


def markdown_to_html(md: str) -> str:
    """Small deterministic markdown renderer."""
    lines = md.split("\n")
    out: list[str] = []
    in_code = False
    in_list = False
    in_table = False

    def close_list():
        nonlocal in_list
        if in_list:
            out.append("</ul>")
            in_list = False

    def close_table():
        nonlocal in_table
        if in_table:
            out.append("</table>")
            in_table = False

    def inline(s: str) -> str:
        s = html.escape(s)
        s = re.sub(r"`([^`]+)`", r"<code>\1</code>", s)
        s = re.sub(r"\*\*([^*]+)\*\*", r"<strong>\1</strong>", s)
        s = re.sub(r"\*([^*]+)\*", r"<em>\1</em>", s)
        s = re.sub(r"\[([^\]]+)\]\(([^)]+)\)", r'<a href="\2">\1</a>', s)
        return s

    for line in lines:
        if line.startswith("```"):
            close_list()
            close_table()
            out.append("<pre><code>" if not in_code else "</code></pre>")
            in_code = not in_code
            continue
        if in_code:
            out.append(html.escape(line))
            continue
        m = re.match(r"^(#{1,4})\s+(.*)$", line)
        if m:
            close_list()
            close_table()
            lvl = len(m.group(1))
            out.append(f"<h{lvl}>{inline(m.group(2))}</h{lvl}>")
            continue
        if re.match(r"^\s*[-*]\s+", line):
            close_table()
            if not in_list:
                out.append("<ul>")
                in_list = True
            out.append(f"<li>{inline(re.sub(r'^\\s*[-*]\\s+', '', line))}</li>")
            continue
        if "|" in line and line.strip().startswith("|"):
            close_list()
            cells = [c.strip() for c in line.strip().strip("|").split("|")]
            if re.fullmatch(r"[\s:|-]+", line.strip()):
                continue  # separator row
            tag = "td" if in_table else "th"
            if not in_table:
                out.append("<table>")
                in_table = True
            out.append("<tr>" + "".join(f"<{tag}>{inline(c)}</{tag}>" for c in cells) + "</tr>")
            continue
        if line.startswith(">"):
            close_list()
            close_table()
            out.append(f"<blockquote>{inline(line[1:].strip())}</blockquote>")
            continue
        close_list()
        close_table()
        if line.strip():
            out.append(f"<p>{inline(line)}</p>")
    close_list()
    close_table()
    if in_code:
        out.append("</code></pre>")
    return "\n".join(out)


@register_toolkit("html")
class HTMLToolkit(AsyncBaseToolkit):
    """config keys: output_dir (default tmp), title."""

    def __init__(self, config=None):
        super().__init__(config)
        self.output_dir = Path(
            self.config.config.get("output_dir") or tempfile.mkdtemp(prefix="yrt-html-")
        )

    @register_tool
    async def render_html_report(self, markdown: str, title: str = "Report", filename: str = "report.html") -> str:
        """Render a markdown report into a styled standalone HTML file.

        Args:
            markdown: The report content in markdown.
            title: The page title.
            filename: Output file name.
        """
        body = markdown_to_html(markdown)
        doc = (
            "<!DOCTYPE html><html><head><meta charset='utf-8'>"
            f"<title>{html.escape(title)}</title><style>{_CSS}</style></head>"
            f"<body><h1>{html.escape(title)}</h1>\n{body}\n</body></html>"
        )
        self.output_dir.mkdir(parents=True, exist_ok=True)
        # agent-controlled filename: contain it (an absolute filename
        # replaces the base entirely with pathlib; '..' walks out)
        base = self.output_dir.resolve()
        path = (base / filename).resolve()
        if not path.is_relative_to(base):
            return f"Error: filename escapes the output directory: {filename!r}"
        path.write_text(doc, encoding="utf-8")
        return f"wrote HTML report to {path}"

    @register_tool
    async def markdown_preview(self, markdown: str) -> str:
        """Convert markdown to an HTML fragment (no file written).

        Args:
            markdown: Markdown source.
        """
        return markdown_to_html(markdown)
