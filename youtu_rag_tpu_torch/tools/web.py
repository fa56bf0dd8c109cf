"""Web / external-content toolkits (remote-service adapters).

Parity surface with ``utu/tools``: SearchToolkit + SerperToolkit
(``search_toolkit.py``, ``serper_toolkit.py``), DocumentToolkit
(``document_toolkit.py:82``), ArxivToolkit, WikipediaToolkit,
GitHubToolkit. All delegate to external HTTP APIs exactly like the
reference; in an offline environment each tool returns a clear
configuration error instead of crashing the agent loop (tool errors
surface to the LLM as text via ToolRouter).

The port's copy of ``youtu_rag_tpu/tools/web.py``.
"""

from __future__ import annotations

import json
import os
from typing import Any

from ..utils.log import get_logger
from . import register_toolkit
from .base import AsyncBaseToolkit, register_tool

logger = get_logger("tools.web")


async def _post_json(url: str, payload: dict, headers: dict | None = None, timeout: float = 30.0) -> dict:
    # the shared retry path (utils/http.py): transient 429/5xx from
    # search providers retry with backoff like every other remote adapter
    from ..utils.http import post_json_with_retry

    return await post_json_with_retry(url, payload, headers=headers, timeout=timeout, log=logger)


async def _get(url: str, params: dict | None = None, headers: dict | None = None, timeout: float = 30.0):
    import httpx

    async with httpx.AsyncClient(timeout=timeout, follow_redirects=True) as client:
        r = await client.get(url, params=params, headers=headers or {})
        r.raise_for_status()
        return r


@register_toolkit("search")
class SearchToolkit(AsyncBaseToolkit):
    """Web search via a Serper-compatible endpoint + page fetch
    (ref: serper_toolkit.py; env: YRT_SERPER_API_KEY / SERPER_API_KEY)."""

    @property
    def _api_key(self) -> str | None:
        return (
            self.config.config.get("api_key")
            or os.environ.get("YRT_SERPER_API_KEY")
            or os.environ.get("SERPER_API_KEY")
        )

    @register_tool
    async def web_search(self, query: str, num_results: int = 5) -> str:
        """Search the web and return titles, links and snippets.

        Args:
            query: The search query.
            num_results: Number of results to return.
        """
        if self.config.config.get("engine") == "baidu":
            return await self._baidu_search(query, num_results)
        if not self._api_key:
            return "Error: web search is not configured (set YRT_SERPER_API_KEY)."
        data = await _post_json(
            "https://google.serper.dev/search",
            {"q": query, "num": num_results},
            headers={"X-API-KEY": self._api_key},
        )
        out = []
        for item in (data.get("organic") or [])[:num_results]:
            out.append(f"- {item.get('title')}\n  {item.get('link')}\n  {item.get('snippet', '')}")
        return "\n".join(out) or "No results."

    async def _baidu_search(self, query: str, num_results: int) -> str:
        """Key-less Baidu scrape (ref: search/baidu_search.py:50-95 — same
        `.result` / `h3 > a` / `.c-abstract` selectors; subject to anti-bot
        measures, degrades with a clear error)."""
        try:
            r = await _get(
                "https://www.baidu.com/s",
                params={"wd": query, "rn": str(max(num_results, 10))},
                headers={"User-Agent": "Mozilla/5.0 (X11; Linux x86_64)"},
            )
        except Exception as e:  # noqa: BLE001
            return f"Error: baidu search failed: {e}"
        from bs4 import BeautifulSoup

        soup = BeautifulSoup(r.text, "html.parser")
        out = []
        for item in soup.select(".result")[:num_results]:
            a = item.select_one("h3 > a")
            desc = item.select_one(".c-abstract, .c-span-last")
            if a is None:
                continue
            out.append(
                f"- {a.get_text(strip=True)}\n  {a.get('href', '')}\n  "
                f"{desc.get_text(strip=True) if desc else ''}"
            )
        return "\n".join(out) or "No results."

    @register_tool
    async def fetch_page(self, url: str, max_chars: int = 8000) -> str:
        """Fetch a web page and return its text content.

        Args:
            url: The page URL.
            max_chars: Truncate the extracted text to this length.
        """
        try:
            r = await _get(url)
        except Exception as e:  # noqa: BLE001
            return f"Error fetching {url}: {e}"
        text = r.text
        # crude tag strip (the reference optionally uses crawl4ai)
        import re

        text = re.sub(r"<script.*?</script>|<style.*?</style>", " ", text, flags=re.DOTALL | re.IGNORECASE)
        text = re.sub(r"<[^>]+>", " ", text)
        text = re.sub(r"\s+", " ", text)
        return text[:max_chars]


@register_toolkit("wikipedia")
class WikipediaToolkit(AsyncBaseToolkit):
    """Wikipedia REST API search + summary (ref: wikipedia toolkit)."""

    @register_tool
    async def wikipedia_search(self, query: str, lang: str = "en") -> str:
        """Look up a topic on Wikipedia and return the page summary.

        Args:
            query: Topic to look up.
            lang: Wikipedia language code.
        """
        try:
            r = await _get(
                f"https://{lang}.wikipedia.org/api/rest_v1/page/summary/{query.replace(' ', '_')}"
            )
            data = r.json()
            return f"{data.get('title')}\n{data.get('extract', '')}"
        except Exception as e:  # noqa: BLE001
            return f"Error querying Wikipedia: {e}"


@register_toolkit("arxiv")
class ArxivToolkit(AsyncBaseToolkit):
    """arXiv API search (ref: arxiv toolkit)."""

    @register_tool
    async def arxiv_search(self, query: str, max_results: int = 5) -> str:
        """Search arXiv for papers.

        Args:
            query: Search terms.
            max_results: Number of papers to return.
        """
        try:
            r = await _get(
                "http://export.arxiv.org/api/query",
                params={"search_query": f"all:{query}", "max_results": max_results},
            )
        except Exception as e:  # noqa: BLE001
            return f"Error querying arXiv: {e}"
        import re

        entries = re.findall(r"<entry>(.*?)</entry>", r.text, re.DOTALL)
        out = []
        for e in entries[:max_results]:
            title = re.search(r"<title>(.*?)</title>", e, re.DOTALL)
            summary = re.search(r"<summary>(.*?)</summary>", e, re.DOTALL)
            link = re.search(r"<id>(.*?)</id>", e)
            out.append(
                f"- {title.group(1).strip() if title else '?'}\n  {link.group(1) if link else ''}\n  "
                f"{(summary.group(1).strip()[:300] if summary else '')}"
            )
        return "\n".join(out) or "No papers found."


@register_toolkit("github")
class GitHubToolkit(AsyncBaseToolkit):
    """GitHub repo/code search (ref: github toolkit; optional GITHUB_TOKEN)."""

    def _headers(self) -> dict:
        tok = self.config.config.get("token") or os.environ.get("GITHUB_TOKEN")
        return {"Authorization": f"Bearer {tok}"} if tok else {}

    @register_tool
    async def github_search_repos(self, query: str, max_results: int = 5) -> str:
        """Search GitHub repositories.

        Args:
            query: Search terms.
            max_results: Number of repositories to return.
        """
        try:
            r = await _get(
                "https://api.github.com/search/repositories",
                params={"q": query, "per_page": max_results},
                headers=self._headers(),
            )
            items = r.json().get("items", [])
        except Exception as e:  # noqa: BLE001
            return f"Error querying GitHub: {e}"
        return "\n".join(
            f"- {i['full_name']} (★{i['stargazers_count']}): {i.get('description', '')}"
            for i in items
        ) or "No repositories found."


@register_toolkit("document")
class DocumentToolkit(AsyncBaseToolkit):
    """Document QA: load a local file and answer with the configured LLM
    (ref: document_toolkit.py:82 — chunkr/LLM file QA).
    config: llm_agent (LLMAgent); falls back to returning the raw text."""

    @register_tool
    async def document_qa(self, path: str, question: str, max_chars: int = 12000) -> str:
        """Answer a question about a local document.

        Args:
            path: Path to the document file.
            question: The question to answer.
            max_chars: Maximum document characters to read.
        """
        from ..ingest.loaders import load_document

        try:
            docs = load_document(path)
        except Exception as e:  # noqa: BLE001
            return f"Error loading {path}: {e}"
        content = "\n\n".join(d.content for d in docs)[:max_chars]
        llm = self.config.config.get("llm_agent")
        if llm is None:
            return f"[document content of {path}]\n{content}"
        return await llm.run(
            f"Document:\n{content}\n\nQuestion: {question}\nAnswer from the document only."
        )
