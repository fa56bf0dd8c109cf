"""Document loaders: file extension → Document(s).

Parity surface with ``utu/rag/document_loaders/`` (extension dispatch
``base_loader.py:14-43``; text/markdown, Excel→markdown-table
``excel_loader.py:13-90``, PDF ``pdf_loader.py:17-148``, DOCX, image-OCR).
PDF/DOCX/OCR depend on optional libraries or remote services and degrade
with a clear error when unavailable (this image ships neither pypdf nor
python-docx; the OCR client is an HTTP adapter like the reference's)."""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Callable

from ..core.types import Document
from ..utils.log import get_logger

logger = get_logger("ingest.loaders")


def _doc_id(path: str) -> str:
    # document id = source filename, matching the reference's convention of
    # deleting/reinserting chunks by source file (processors.py:363-369)
    return os.path.basename(path)


def load_text(path: str, metadata: dict | None = None) -> list[Document]:
    content = Path(path).read_text(encoding="utf-8", errors="replace")
    meta = {"source": _doc_id(path), "file_type": Path(path).suffix.lstrip("."), **(metadata or {})}
    return [Document(id=_doc_id(path), content=content, metadata=meta)]


def load_excel(path: str, metadata: dict | None = None) -> list[Document]:
    """Every sheet renders to a markdown table (ref: excel_loader.py:13-90).
    The structured SQLite path lives in the processors, not here."""
    import pandas as pd

    docs = []
    sheets = pd.read_excel(path, sheet_name=None) if path.lower().endswith((".xlsx", ".xls")) else {
        "Sheet1": pd.read_csv(path)
    }
    for sheet_name, df in sheets.items():
        md = df.to_markdown(index=False)
        meta = {
            "source": _doc_id(path),
            "sheet": sheet_name,
            "n_rows": int(df.shape[0]),
            "n_cols": int(df.shape[1]),
            "file_type": "excel",
            **(metadata or {}),
        }
        suffix = f"#{sheet_name}" if len(sheets) > 1 else ""
        docs.append(Document(id=_doc_id(path) + suffix, content=md, metadata=meta))
    return docs


def load_pdf(path: str, metadata: dict | None = None) -> list[Document]:
    try:
        import pypdf  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "PDF loading requires pypdf (not in this image) or an OCR "
            "service (set YRT_OCR_URL and use OcrLoader)"
        ) from e
    reader = pypdf.PdfReader(path)
    text = "\n\n".join(page.extract_text() or "" for page in reader.pages)
    meta = {"source": _doc_id(path), "n_pages": len(reader.pages), "file_type": "pdf", **(metadata or {})}
    return [Document(id=_doc_id(path), content=text, metadata=meta)]


def load_docx(path: str, metadata: dict | None = None) -> list[Document]:
    try:
        import docx  # noqa: F401
    except ImportError as e:
        raise RuntimeError("DOCX loading requires python-docx (not in this image)") from e
    d = docx.Document(path)
    text = "\n".join(p.text for p in d.paragraphs)
    meta = {"source": _doc_id(path), "file_type": "docx", **(metadata or {})}
    return [Document(id=_doc_id(path), content=text, metadata=meta)]


class DocumentLoaderRegistry:
    """Extension dispatch (ref: base_loader.py:14-43). Derived files take
    priority at load time: ``<name>_chunklevel.md`` (hierarchical LLM
    chunking output) over ``<name>_ocr.md`` over the original — mirroring
    processors.py:196-338."""

    _LOADERS: dict[str, Callable[..., list[Document]]] = {
        ".txt": load_text,
        ".md": load_text,
        ".markdown": load_text,
        ".json": load_text,
        ".jsonl": load_text,
        ".py": load_text,
        ".html": load_text,
        ".csv": load_excel,
        ".xlsx": load_excel,
        ".xls": load_excel,
        ".pdf": load_pdf,
        ".docx": load_docx,
    }

    @classmethod
    def register(cls, ext: str, loader: Callable[..., list[Document]]) -> None:
        cls._LOADERS[ext.lower()] = loader

    @classmethod
    def supported_extensions(cls) -> list[str]:
        return sorted(cls._LOADERS)

    @classmethod
    def load(cls, path: str, metadata: dict | None = None, prefer_derived: bool = True) -> list[Document]:
        p = Path(path)
        if prefer_derived:
            stem = p.with_suffix("")
            for suffix, note in ((f"{stem}_chunklevel.md", "chunklevel"), (f"{stem}_ocr.md", "ocr")):
                if os.path.exists(suffix):
                    logger.info("using derived file %s for %s", suffix, path)
                    docs = load_text(suffix, metadata)
                    for d in docs:
                        d.id = _doc_id(path)  # keep original identity
                        d.metadata["source"] = _doc_id(path)
                        d.metadata["derived"] = note
                    return docs
        ext = p.suffix.lower()
        loader = cls._LOADERS.get(ext)
        if loader is None:
            raise ValueError(f"unsupported file type {ext!r} ({path}); supported: {cls.supported_extensions()}")
        return loader(path, metadata)


def load_document(path: str, metadata: dict | None = None, **kwargs: Any) -> list[Document]:
    return DocumentLoaderRegistry.load(path, metadata, **kwargs)
