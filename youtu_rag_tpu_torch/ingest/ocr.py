"""OCR client: scanned PDFs/images → markdown derived files.

A copy of ``youtu_rag_tpu/ingest/ocr.py``; its client posts through
``utils/http.py``, which imports ``httpx`` only when it is called.

Parity with the reference's OCR pipeline (``routes/minio_files.py:182-280``
``_process_ocr`` posting to an OCR model service and storing per-page
markdown derivatives; loaders then prefer ``*_ocr.md``,
``pdf_loader.py:17-148``). The client is an HTTP adapter (env
``YRT_OCR_URL`` / ``UTU_OCR_URL``); offline it reports cleanly and the
pipeline continues with the original file."""

from __future__ import annotations

import base64
import os
from pathlib import Path

from ..utils.http import post_json_with_retry
from ..utils.log import get_logger

logger = get_logger("ingest.ocr")

OCR_EXTENSIONS = {".pdf", ".png", ".jpg", ".jpeg", ".tiff", ".bmp", ".webp"}


class RemoteOCRClient:
    def __init__(self, base_url: str | None = None, timeout: float = 300.0, max_retries: int = 3):
        self.base_url = base_url or os.environ.get("YRT_OCR_URL") or os.environ.get("UTU_OCR_URL")
        self.timeout = timeout
        self.max_retries = max_retries

    @property
    def available(self) -> bool:
        return bool(self.base_url)

    async def ocr(self, data: bytes, filename: str) -> dict:
        """POST the document; returns the raw service response:
        ``{"pages": [{"markdown", "structured"?, "layout_image"(b64 png)?}]}``
        or ``{"markdown": ...}`` for single-page services."""
        if not self.available:
            raise RuntimeError("OCR is not configured (set YRT_OCR_URL)")
        payload = {
            "filename": filename,
            "data": base64.b64encode(data).decode(),
            "output": "markdown",
        }
        return await post_json_with_retry(
            f"{self.base_url.rstrip('/')}/ocr",
            payload,
            timeout=self.timeout,
            max_retries=self.max_retries,
            backoff=2.0,
            log=logger,
        )

    async def ocr_to_markdown(self, data: bytes, filename: str) -> str:
        """POST the document, return combined per-page markdown."""
        return combine_pages(pages_from_response(await self.ocr(data, filename)))


def pages_from_response(body: dict) -> list[dict]:
    """Normalize an OCR response to [{"markdown", "structured"?, "layout_image"?}]."""
    pages = body.get("pages")
    if pages:
        return [p if isinstance(p, dict) else {"markdown": str(p)} for p in pages]
    return [{"markdown": body.get("markdown", "")}]


def combine_pages(pages: list[dict]) -> str:
    """Per-page markdown → one combined document (the derived file the
    loaders prefer). Page headers keep edits page-addressable."""
    if len(pages) == 1:
        return pages[0].get("markdown", "")
    return "\n\n".join(f"# Page {i + 1}\n\n{p.get('markdown', '')}" for i, p in enumerate(pages))


def needs_ocr(filename: str) -> bool:
    return Path(filename).suffix.lower() in OCR_EXTENSIONS


def page_md_name(name: str, page: int) -> str:
    return f"page_{page}_{Path(name).stem}_ocr.md"


def page_layout_name(name: str, page: int) -> str:
    return f"page_{page}_{Path(name).stem}_layout.png"


def page_json_name(name: str, page: int) -> str:
    return f"page_{page}_{Path(name).stem}_ocr.json"


def combined_md_name(name: str) -> str:
    return f"{Path(name).stem}_ocr.md"


async def process_ocr_to_store(file_store, bucket: str, name: str, client: RemoteOCRClient | None = None) -> str | None:
    """Run OCR on an uploaded file and persist its derivatives beside it:
    per-page ``page_N_<stem>_ocr.md`` (+ ``.json`` structured data and
    ``page_N_<stem>_layout.png`` overlays when the service returns them)
    plus the combined ``<stem>_ocr.md`` the loaders prefer
    (ref: minio_files.py:182-280 per-page derivative scheme). Returns the
    combined derived name, or None when OCR is unconfigured/inapplicable."""
    client = client or RemoteOCRClient()
    if not client.available or not needs_ocr(name):
        return None
    data = file_store.download(bucket, name)
    pages = pages_from_response(await client.ocr(data, name))
    for i, page in enumerate(pages, start=1):
        file_store.upload(
            bucket,
            page_md_name(name, i),
            page.get("markdown", "").encode("utf-8"),
            {"derived_from": name, "kind": "ocr_page", "page": i},
        )
        if page.get("structured") is not None:
            import json as _json

            file_store.upload(
                bucket,
                page_json_name(name, i),
                _json.dumps(page["structured"], ensure_ascii=False).encode("utf-8"),
                {"derived_from": name, "kind": "ocr_structured", "page": i},
            )
        if page.get("layout_image"):
            file_store.upload(
                bucket,
                page_layout_name(name, i),
                base64.b64decode(page["layout_image"]),
                {"derived_from": name, "kind": "ocr_layout", "page": i},
            )
    derived = combined_md_name(name)
    file_store.upload(
        bucket, derived, combine_pages(pages).encode("utf-8"), {"derived_from": name, "kind": "ocr"}
    )
    logger.info("OCR derived files stored: %s (%d pages)", derived, len(pages))
    return derived
