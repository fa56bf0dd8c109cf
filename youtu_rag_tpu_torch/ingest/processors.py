"""Per-source-type processors for the staged knowledge build.

A copy of ``youtu_rag_tpu/ingest/processors.py`` over the port's store;
``pandas`` is imported inside the spreadsheet and database processors.

Behavior anchored to ``utu/rag/knowledge_builder/processors.py``:
- three-index scheme: content chunks (``index_type=index_content``), one
  file-summary vector (``index_summary``, chunk_index −1, :423-464), and
  element vectors for tables/columns (``index_element``, :581-686);
- delete-then-reinsert per document id for idempotency (:363-421);
- Excel structured detection ≥2 columns and ≥5 rows (:852) → SQLite table
  + table vector + per-column top-value vectors + full-text markdown
  chunks + summary;
- QA pairs become question-embedded vectors with answer payloads
  (:1447-1603).

Device shape: every processor only *prepares* (chunk, text) pairs;
embeddings happen in one batched pass per source via the shared embedder."""

from __future__ import annotations

import io
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from ..core.config import KnowledgeBuilderConfig
from ..core.types import BaseEmbedder, Chunk, Document
from ..retrieval.store import TorchVectorStore
from ..utils.hashing import md5_hex
from ..utils.log import get_logger
from .builder import make_chunk_id
from .chunker import get_splitter
from .loaders import DocumentLoaderRegistry
from .tables import TableStore

logger = get_logger("ingest.processors")

INDEX_CONTENT = "index_content"
INDEX_SUMMARY = "index_summary"
INDEX_ELEMENT = "index_element"


@dataclass
class SourceTask:
    """One unit of build work (file path or inline document or qa set)."""

    source_id: str
    kind: str  # text | table | qa | database
    path: str | None = None
    document: Document | None = None
    qa_pairs: list[dict[str, str]] = field(default_factory=list)
    metadata: dict[str, Any] = field(default_factory=dict)


@dataclass
class ProcessResult:
    source_id: str
    ok: bool = True
    chunks: int = 0
    tables: list[str] = field(default_factory=list)
    error: str | None = None


class ProcessorContext:
    def __init__(
        self,
        kb_name: str,
        store: TorchVectorStore,
        embedder: BaseEmbedder,
        tables: TableStore,
        config: KnowledgeBuilderConfig | None = None,
    ):
        self.kb_name = kb_name
        self.store = store
        self.embedder = embedder
        self.tables = tables
        self.config = config or KnowledgeBuilderConfig()


class BaseSourceProcessor:
    kind = "text"

    def __init__(self, ctx: ProcessorContext):
        self.ctx = ctx

    async def process(self, task: SourceTask) -> ProcessResult:
        raise NotImplementedError

    # -- shared helpers ----------------------------------------------------

    async def _embed_and_store(self, chunks: list[Chunk]) -> int:
        if not chunks:
            return 0
        bs = max(self.ctx.config.embedding.batch_size, 1)
        texts = [c.content for c in chunks]
        for i in range(0, len(texts), bs):
            embs = await self.ctx.embedder.embed_texts(texts[i : i + bs])
            for c, e in zip(chunks[i : i + bs], embs):
                c.embedding = e
        await self.ctx.store.add_chunks(chunks)
        return len(chunks)

    def _load(self, task: SourceTask) -> Document:
        if task.document is not None:
            return task.document
        docs = DocumentLoaderRegistry.load(task.path, task.metadata or None)
        return docs[0]

    def _content_chunks(
        self, doc: Document, strategy: str | None = None, id_salt: str | None = None
    ) -> list[Chunk]:
        """``id_salt`` disambiguates chunk ids for multi-part documents
        (Excel sheets share one document_id; two identical sheets would
        otherwise mint identical (doc, index, text) chunk ids)."""
        cfg = self.ctx.config.chunking
        if strategy:
            cfg = cfg.model_copy(update={"strategy": strategy})
        elif doc.metadata and doc.metadata.get("derived") == "chunklevel":
            # hierarchical output gets the header-aware splitter
            cfg = cfg.model_copy(update={"strategy": "hierarchical"})
        splitter = get_splitter(cfg)
        texts = splitter.split_text(doc.content, doc.metadata)
        id_base = f"{doc.id}#{id_salt}" if id_salt else doc.id
        out = []
        for i, t in enumerate(texts):
            meta = dict(doc.metadata or {})
            meta.update(
                {
                    "source": doc.id,
                    "chunk_index": i,
                    "total_chunks": len(texts),
                    "index_type": INDEX_CONTENT,
                }
            )
            out.append(Chunk(make_chunk_id(id_base, i, t), doc.id, t, i, meta))
        return out

    def _summary_chunk(self, doc: Document, summary: str | None = None) -> Chunk:
        """File-level discovery vector (ref: _create_summary_index,
        filename + summary in one vector, chunk_index −1)."""
        text = f"{doc.id}\n{summary or doc.content[:500]}"
        meta = dict(doc.metadata or {})
        meta.update({"source": doc.id, "index_type": INDEX_SUMMARY, "chunk_index": -1})
        return Chunk(md5_hex(f"summary:{doc.id}"), doc.id, text, -1, meta)


class TextProcessor(BaseSourceProcessor):
    """PDF/Word/Text/Markdown (ref: processors.py:692-713)."""

    kind = "text"

    async def process(self, task: SourceTask) -> ProcessResult:
        doc = self._load(task)
        await self.ctx.store.delete_by_document_id(doc.id)
        chunks = self._content_chunks(doc)
        chunks.append(self._summary_chunk(doc))
        n = await self._embed_and_store(chunks)
        return ProcessResult(task.source_id, chunks=n)


class ExcelProcessor(BaseSourceProcessor):
    """Structured spreadsheet path (ref: processors.py:716-1146)."""

    kind = "table"

    # structured-detection thresholds (ref: processors.py:852)
    MIN_COLS = 2
    MIN_ROWS = 5
    TOP_VALUES = 10

    async def process(self, task: SourceTask) -> ProcessResult:
        import pandas as pd

        path = task.path
        source_id = task.source_id
        await self.ctx.store.delete_by_document_id(source_id)

        if path and path.lower().endswith(".csv"):
            sheets = {"Sheet1": pd.read_csv(path)}
        elif path:
            sheets = pd.read_excel(path, sheet_name=None)
        elif task.document is not None:
            sheets = {"Sheet1": pd.read_csv(io.StringIO(task.document.content))}
        else:
            return ProcessResult(source_id, ok=False, error="no path or document")

        chunks: list[Chunk] = []
        tables: list[str] = []
        for sheet_name, df in sheets.items():
            structured = df.shape[1] >= self.MIN_COLS and df.shape[0] >= self.MIN_ROWS
            if structured:
                table = self.ctx.tables.store_dataframe(
                    self.ctx.kb_name, source_id, f"{Path(source_id).stem}_{sheet_name}", df
                )
                tables.append(table)
                chunks.append(self._table_vector(source_id, table, df))
                chunks.extend(self._column_vectors(source_id, table, df))
            # full-text markdown chunks in all cases (ref full-text path).
            # Scale guard: whole-sheet to_markdown on a 100k-row sheet blows
            # host memory — sample evenly past max_fulltext_rows (the
            # reference row-samples big sheets the same way).
            max_ft = self.ctx.config.max_fulltext_rows
            if len(df) > max_ft:
                import numpy as _np

                sel = _np.unique(_np.linspace(0, len(df) - 1, max_ft).astype(int))
                md = df.iloc[sel].to_markdown(index=False)
                md += f"\n\n[{len(df)} rows total; {len(sel)} sampled — full data in table store]"
            else:
                md = df.to_markdown(index=False)
            doc = Document(
                source_id,
                md,
                {**task.metadata, "source": source_id, "sheet": sheet_name, "file_type": "excel"},
            )
            chunks.extend(self._content_chunks(doc, id_salt=sheet_name))
            if not structured:
                # unstructured small sheets also index per-row docs (ref
                # row-docs), capped so a wide-but-short pathological sheet
                # can't mint unbounded vectors
                for ri, row in df.head(self.ctx.config.max_row_docs).iterrows():
                    text = "; ".join(f"{c}={row[c]}" for c in df.columns)
                    meta = {
                        "source": source_id,
                        "sheet": sheet_name,
                        "row": int(ri),
                        "index_type": INDEX_CONTENT,
                    }
                    chunks.append(
                        Chunk(md5_hex(f"{source_id}:{sheet_name}:row{ri}"), source_id, text, ri, meta)
                    )

        # all sheets share one document_id: renumber CONTENT chunk_index
        # to a single per-document sequence (per-sheet indexes restarted
        # at 0, breaking any consumer ordering/paginating a document by
        # index). Element vectors (table/column) keep their conventions.
        content = [c for c in chunks if (c.metadata or {}).get("index_type") == INDEX_CONTENT]
        for i, c in enumerate(content):
            c.chunk_index = i
            c.metadata["chunk_index"] = i
            c.metadata["total_chunks"] = len(content)

        summary_doc = Document(
            source_id,
            f"Spreadsheet with sheets: {', '.join(sheets)}; tables: {', '.join(tables) or 'none'}",
            {**task.metadata, "source": source_id, "file_type": "excel"},
        )
        chunks.append(self._summary_chunk(summary_doc))
        n = await self._embed_and_store(chunks)
        return ProcessResult(source_id, chunks=n, tables=tables)

    def _table_vector(self, source_id: str, table: str, df) -> Chunk:
        """Table-level element vector: name + columns + sample rows
        (ref: _create_table_vector)."""
        sample = df.head(3).to_markdown(index=False)
        text = f"Table {table} from {source_id}\nColumns: {', '.join(map(str, df.columns))}\n{sample}"
        meta = {
            "source": source_id,
            "index_type": INDEX_ELEMENT,
            "element_type": "table",
            "table_name": table,
        }
        return Chunk(md5_hex(f"table:{self.ctx.kb_name}:{table}"), source_id, text, 0, meta)

    def _column_vectors(self, source_id: str, table: str, df) -> list[Chunk]:
        """Per-text-column top-N frequent values (ref:
        _create_column_vectors_shared, 'individual' strategy)."""
        out = []
        for col in df.columns:
            series = df[col]
            if series.dtype.kind not in ("O", "U", "S"):  # text-like columns only
                continue
            top = series.astype(str).value_counts().head(self.TOP_VALUES)
            if top.empty:
                continue
            values = ", ".join(top.index.tolist())
            text = f"Column {col} of table {table}: example values: {values}"
            meta = {
                "source": source_id,
                "index_type": INDEX_ELEMENT,
                "element_type": "column",
                "table_name": table,
                "column_name": str(col),
            }
            out.append(
                Chunk(md5_hex(f"col:{self.ctx.kb_name}:{table}:{col}"), source_id, text, 0, meta)
            )
        return out


class DatabaseProcessor(BaseSourceProcessor):
    """External DB ingestion: per-table schema + element vectors
    (ref: processors.py:1148-1445; sqlite path — mysql adapter gated)."""

    kind = "database"

    async def process(self, task: SourceTask) -> ProcessResult:
        import pandas as pd
        import sqlite3

        db_path = task.path
        source_id = task.source_id
        await self.ctx.store.delete_by_document_id(source_id)
        conn = sqlite3.connect(db_path)
        try:
            names = [
                r[0]
                for r in conn.execute(
                    "SELECT name FROM sqlite_master WHERE type='table' AND name NOT LIKE 'sqlite_%'"
                )
            ]
            excel = ExcelProcessor(self.ctx)
            chunks: list[Chunk] = []
            tables: list[str] = []
            for name in names:
                df = pd.read_sql_query(f'SELECT * FROM "{name}"', conn)
                table = self.ctx.tables.store_dataframe(self.ctx.kb_name, source_id, name, df)
                tables.append(table)
                chunks.append(excel._table_vector(source_id, table, df))
                chunks.extend(excel._column_vectors(source_id, table, df))
            doc = Document(
                source_id,
                f"Database {source_id} with tables: {', '.join(tables)}",
                {**task.metadata, "source": source_id, "file_type": "database"},
            )
            chunks.append(self._summary_chunk(doc))
            n = await self._embed_and_store(chunks)
            return ProcessResult(source_id, chunks=n, tables=tables)
        finally:
            conn.close()


class QAProcessor(BaseSourceProcessor):
    """QA-pair associations: the question is the vector, the answer rides
    in metadata (ref: processors.py:1447-1603)."""

    kind = "qa"

    async def process(self, task: SourceTask) -> ProcessResult:
        source_id = task.source_id
        await self.ctx.store.delete_by_document_id(source_id)
        chunks = []
        for i, pair in enumerate(task.qa_pairs):
            q, a = pair.get("question", ""), pair.get("answer", "")
            if not q:
                continue
            meta = {
                "source": source_id,
                "index_type": INDEX_CONTENT,
                "element_type": "qa",
                "answer": a[:2000],
                "related_file": pair.get("related_file", ""),
            }
            # the QUESTION alone is the vector (the documented parity
            # contract): question-shaped queries must not be diluted by
            # long answer text; the answer rides in metadata
            chunks.append(Chunk(md5_hex(f"qa:{source_id}:{i}:{q}"), source_id, q, i, meta))
        n = await self._embed_and_store(chunks)
        return ProcessResult(source_id, chunks=n)


_EXCEL_EXTS = {".xlsx", ".xls", ".csv"}
_DB_EXTS = {".db", ".sqlite", ".sqlite3"}


class FileProcessorFactory:
    """kind/extension → processor (ref: processors.py:1605-1708)."""

    @staticmethod
    def task_kind(task: SourceTask) -> str:
        if task.kind != "text":
            return task.kind
        if task.qa_pairs:
            return "qa"
        if task.path:
            ext = Path(task.path).suffix.lower()
            if ext in _EXCEL_EXTS:
                return "table"
            if ext in _DB_EXTS:
                return "database"
        return "text"

    @staticmethod
    def create(kind: str, ctx: ProcessorContext) -> BaseSourceProcessor:
        return {
            "text": TextProcessor,
            "table": ExcelProcessor,
            "qa": QAProcessor,
            "database": DatabaseProcessor,
        }[kind](ctx)
