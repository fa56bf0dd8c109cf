"""Async HTTP POST with transient-failure retry: a copy of
``youtu_rag_tpu/utils/http.py`` for the port's remote adapters
(``RemoteEmbedder``, ``RemoteReranker``).

Retries 429/500/502/503-style statuses, timeouts and connection errors
with backoff; raises other HTTP errors (4xx, other 5xx) at once. ``httpx``
is imported inside the function, so the package imports without it;
``transport`` takes an ``httpx`` transport, the seam the hermetic tests
use."""

from __future__ import annotations

import asyncio
import logging
from typing import Any

from .log import get_logger

logger = get_logger("utils.http")

#: statuses worth retrying: rate limit, transient upstream failures,
#: gateway errors while a service starts up.
RETRYABLE_STATUSES: tuple[int, ...] = (429, 500, 502, 503)


async def post_json_with_retry(
    url: str,
    payload: dict,
    *,
    headers: dict[str, str] | None = None,
    timeout: float = 60.0,
    max_retries: int = 3,
    backoff: float = 1.5,
    retry_statuses: tuple[int, ...] = RETRYABLE_STATUSES,
    log: logging.Logger | None = None,
    transport: Any = None,
) -> dict:
    """POST ``payload`` as JSON; return the decoded JSON response.

    Retries up to ``max_retries`` times on ``retry_statuses``, timeouts and
    connection errors, sleeping ``backoff**attempt`` seconds between tries.
    Any other HTTP error status raises ``httpx.HTTPStatusError`` without
    retrying."""
    import httpx

    lg = log or logger
    last: Exception | None = None
    async with httpx.AsyncClient(timeout=timeout, transport=transport) as client:
        for attempt in range(max_retries):
            try:
                r = await client.post(url, json=payload, headers=headers or {})
                if r.status_code in retry_statuses:
                    last = RuntimeError(f"HTTP {r.status_code} from {url}")
                    lg.warning(
                        "attempt %d/%d: retryable HTTP %d from %s",
                        attempt + 1, max_retries, r.status_code, url,
                    )
                else:
                    r.raise_for_status()  # 4xx / other 5xx: non-retryable
                    return r.json()
            except httpx.HTTPStatusError:
                raise
            except httpx.HTTPError as e:  # timeout / connect / protocol
                last = e
                lg.warning("attempt %d/%d: %s: %s", attempt + 1, max_retries, type(e).__name__, e)
            if attempt < max_retries - 1:
                await asyncio.sleep(backoff**attempt)
    raise RuntimeError(f"POST {url} failed after {max_retries} attempts: {last}")
