"""Text2SQL toolkit + agent.

Parity surface with the reference's text2sql stack:
- schema/value linking over vectorized table/column metadata — the
  ``index_element`` vectors built by the Excel/Database processors stand in
  for Chroma's ``index_element`` collection
  (``utu/rag/knowledge_retrieval/chroma_retrical_text2sql.py:45-199``,
  ``utu/tools/text2sql/unified_schemalink_valuelink.py:1-546``);
- DDL formatting + per-column example values (:64-103 / sqlite_tools.py);
- read-only SQL execution with error-driven retry
  (``utu/rag/rag_agents/orchestra_react_text2sql.py:37-540``
  ``Text2sqlAgent.text2sql/sql_gen_exec``).

The linking search runs on the same fused device kernel as every other
retrieval — table/column relevance is one masked top-k over
``index_type == index_element``.

The port's copy of ``youtu_rag_tpu/tools/text2sql.py``.
"""

from __future__ import annotations

import json
import re
from typing import Any

from ..utils.log import get_logger
from . import register_toolkit
from .base import register_tool
from .kb_search import BaseRAGToolkit

logger = get_logger("tools.text2sql")


@register_toolkit("text2sql")
class Text2SQLToolkit(BaseRAGToolkit):
    """config keys: kb (KnowledgeBase|name), tables (TableStore), llm_agent."""

    def __init__(self, config=None):
        super().__init__(config)
        self.llm_agent = self.config.config.get("llm_agent")
        self._adapter = None  # external database (sqlite file / mysql server)
        # optional VectorMemoryToolkit: remembered schema knowledge joins
        # schema_link output and SQL patterns feed generation
        # (ref: memory_toolkit.py:1540-1590 schema/sql_pattern memories)
        self.memory = self.config.config.get("memory")

    @property
    def tables(self):
        t = self.config.config.get("tables")
        if t is not None:
            return t
        # no explicit store: resolve through the KB (name → registry), the
        # same path every other RAG toolkit takes — this is how the API's
        # orchestra_react_sql agent reaches the tables of the chat's KB
        return self.kb.tables

    @property
    def adapter(self):
        """External-database adapter when config has a 'database_url'
        (sqlite:///... or mysql://...; ref: the mysql branch of the
        reference's db_utils). None → the KB's in-process TableStore."""
        if self._adapter is None and self.config.config.get("database_url"):
            from ..db.adapters import adapter_from_url

            self._adapter = adapter_from_url(
                self.config.config["database_url"],
                driver=self.config.config.get("db_driver"),
            )
        return self._adapter

    @register_tool
    async def schema_link(self, query: str, top_k: int = 3) -> str:
        """Find the database tables and columns most relevant to a question,
        with schema DDL and example values.

        Args:
            query: The natural-language question.
            top_k: Number of candidate tables to return.
        """
        kb = self.kb
        # one fused element-index search ranks tables and columns together
        results = await kb.retriever.retrieve(
            query,
            top_k=top_k * 6,
            filters={"index_type": "index_element"},
            enable_reranking=False,
            similarity_threshold=0.0,
        )
        tables: dict[str, dict[str, Any]] = {}
        for r in results:
            meta = r.chunk.metadata or {}
            tname = meta.get("table_name")
            if not tname:
                continue
            entry = tables.setdefault(tname, {"score": r.score, "columns": []})
            entry["score"] = max(entry["score"], r.score)
            if meta.get("element_type") == "column":
                entry["columns"].append(meta.get("column_name"))
        if not tables:
            return "No relevant tables found in the knowledge base."

        ranked = sorted(tables.items(), key=lambda kv: -kv[1]["score"])[:top_k]
        parts = []
        if self.config.config.get("tables") is None and self.adapter is not None:
            # external-database deployment (database_url, no TableStore):
            # DDL/examples come from the adapter — the TableStore property
            # would raise and kill the whole text2sql flow
            for tname, info in ranked:
                try:
                    parts.append(
                        f"-- table {tname} (relevance {info['score']:.3f})\n"
                        + self.adapter.table_ddl(tname)
                    )
                except Exception:  # noqa: BLE001 - table may not exist remotely
                    continue
            return "\n\n".join(parts) or "No relevant tables found."
        for tname, info in ranked:
            ddl = self.tables.get_schema(tname)
            sample = self.tables.sample_rows(tname, 3)
            value_lines = []
            for col in info["columns"][:6]:
                try:
                    top_vals = self.tables.column_top_values(tname, col, 5)
                    value_lines.append(
                        f"  {col}: " + ", ".join(repr(v) for v, _ in top_vals)
                    )
                except Exception:  # noqa: BLE001 - column may be renamed
                    continue
            parts.append(
                f"-- table {tname} (relevance {info['score']:.3f})\n{ddl}\n"
                + ("example values:\n" + "\n".join(value_lines) + "\n" if value_lines else "")
                + f"sample rows: {json.dumps(sample, ensure_ascii=False, default=str)[:500]}"
            )
        if self.memory is not None:
            try:
                known = await self.memory.search_schema_knowledge(query, top_k=2)
                if known:
                    parts.append(f"-- remembered schema knowledge\n{known}")
            except Exception:  # noqa: BLE001 - memory is advisory
                logger.exception("schema-knowledge recall failed")
        return "\n\n".join(parts)

    @register_tool
    async def execute_sql(self, sql: str) -> str:
        """Execute a read-only SELECT statement against the knowledge base's
        structured tables and return the result rows.

        Args:
            sql: The SELECT statement to run.
        """
        if self.adapter is not None:
            try:
                result = self.adapter.query(sql)
            except Exception as e:  # noqa: BLE001 - same error contract as TableStore
                result = {"error": str(e)}
        else:
            result = self.tables.execute_sql(sql)
        return json.dumps(result, ensure_ascii=False, default=str)

    @register_tool
    async def list_tables(self) -> str:
        """List the structured tables available in this knowledge base."""
        if self.adapter is not None:
            names = self.adapter.list_tables()
            if not names:
                return "No tables in the connected database."
            return "\n".join(f"- {t}\n{self.adapter.table_ddl(t)}" for t in names)
        rows = self.tables.tables_for_kb(self.kb.name)
        if not rows:
            return "No structured tables in this knowledge base."
        return "\n".join(
            f"- {r['table_name']} ({r['n_rows']} rows; columns: {r['columns']})" for r in rows
        )


SQL_GEN_PROMPT = """You translate questions into SQLite SELECT statements.

Relevant schema:
{schema}
{patterns}
Question: {question}
{error_context}
Reply with the SQL statement only (no markdown fences)."""

ANSWER_PROMPT = """Answer the question from the SQL result.

Question: {question}
SQL: {sql}
Result: {result}

Write a concise answer."""

_SQL_FENCE = re.compile(r"```(?:sql)?\s*(.*?)```", re.DOTALL)


class Text2SQLAgent:
    """link → generate (schema + remembered patterns) → execute (with
    error retry) → answer, learning successful queries back into memory
    (ref: Text2sqlAgent.sql_gen_exec flow + memory_toolkit sql_pattern)."""

    def __init__(
        self,
        toolkit: Text2SQLToolkit,
        llm_agent,
        max_retries: int = 2,
        learn_patterns: bool = True,
    ):
        self.toolkit = toolkit
        self.llm = llm_agent
        self.max_retries = max_retries
        self.learn_patterns = learn_patterns

    @staticmethod
    def _extract_sql(text: str) -> str:
        m = _SQL_FENCE.search(text)
        sql = (m.group(1) if m else text).strip()
        return sql.rstrip(";") + ";"

    async def _recall_patterns(self, question: str) -> str:
        if self.toolkit.memory is None:
            return ""
        try:
            patterns = await self.toolkit.memory.search_sql_patterns(question, top_k=2)
        except Exception:  # noqa: BLE001 - memory is advisory
            logger.exception("sql-pattern recall failed")
            return ""
        return f"\nRemembered SQL patterns (apply when relevant):\n{patterns}\n" if patterns else ""

    async def text2sql(self, question: str) -> dict[str, Any]:
        schema = await self.toolkit.schema_link(question)
        patterns = await self._recall_patterns(question)
        error_context = ""
        sql, result = "", {"error": "not attempted"}
        for attempt in range(self.max_retries + 1):
            raw = await self.llm.run(
                SQL_GEN_PROMPT.format(
                    schema=schema,
                    patterns=patterns,
                    question=question,
                    error_context=error_context,
                )
            )
            sql = self._extract_sql(raw)
            result = json.loads(await self.toolkit.execute_sql(sql))
            if "error" not in result:
                break
            error_context = (
                f"The previous attempt failed.\nSQL: {sql}\nError: {result['error']}\n"
                "Fix the statement."
            )
        answer = None
        if "error" not in result:
            answer = await self.llm.run(
                ANSWER_PROMPT.format(
                    question=question, sql=sql, result=json.dumps(result, default=str)[:2000]
                )
            )
            if self.learn_patterns and self.toolkit.memory is not None and attempt > 0:
                # the first draft failed and a later one worked: the fix is
                # worth remembering for next time
                try:
                    await self.toolkit.memory.store_sql_pattern(
                        pattern_name=f"learned:{question[:48]}",
                        sql_pattern=sql,
                        description=f"Working query for questions like: {question[:160]}",
                        examples=[question],
                    )
                except Exception:  # noqa: BLE001
                    logger.exception("sql-pattern learn failed")
        return {"sql": sql, "result": result, "answer": answer}


class Text2SQLWorkerAgent:
    """Orchestra worker that drives the FULL text2sql pipeline.

    The serving pipeline (`orchestra_react_sql`) previously ran a free-form
    SimpleAgent tool loop, which lacked the execution-error retry the bare
    Text2SQLAgent has — so the full pipeline could lose to its own worker.
    In the reference the orchestra's workers ARE Text2sqlAgents running
    ``sql_gen_exec`` with error feedback
    (``utu/rag/rag_agents/orchestra_react_text2sql.py:37-540``); this class
    restores that shape: every subtask runs link → generate → execute
    (with retry) → answer, and the SQL/result land on the TaskRecorder as a
    tool call so streaming/tracing surfaces see them.
    """

    def __init__(
        self,
        toolkit: Text2SQLToolkit,
        llm_agent,
        name: str = "text2sql",
        max_retries: int = 2,
        learn_patterns: bool = True,
    ):
        from ..agents.config import AgentConfig

        self.name = name
        self.agent = Text2SQLAgent(
            toolkit, llm_agent, max_retries=max_retries, learn_patterns=learn_patterns
        )
        # OrchestraAgent._agents_info falls back to worker.config when no
        # workers_info is configured
        self.config = AgentConfig(type="llm")
        self.config.agent.name = name
        self.config.agent.instructions = (
            "Answers questions over structured tables: schema/value linking, "
            "SQL generation with execution-error retry, result summarization."
        )

    async def build(self) -> "Text2SQLWorkerAgent":
        return self

    async def cleanup(self) -> None:
        return None

    @staticmethod
    def _subtask_question(task: str) -> str:
        # OrchestraAgent.work prefixes accumulated context as
        # "Overall context so far:\n...\n\nYour subtask: <task>"
        if "Your subtask:" in task:
            return task.split("Your subtask:", 1)[1].strip()
        return task

    async def run(self, task: str):
        from ..agents.events import TaskRecorder, ToolCallRecord

        rec = TaskRecorder(task=task)
        r = await self.agent.text2sql(self._subtask_question(task))
        rec.add_tool_call(
            ToolCallRecord(
                name="execute_sql",
                arguments=json.dumps({"sql": r["sql"]}, ensure_ascii=False),
                output=json.dumps(r["result"], ensure_ascii=False, default=str)[:2000],
            )
        )
        out = r.get("answer") or json.dumps(r["result"], ensure_ascii=False, default=str)[:500]
        rec.set_final_output(out or "")
        rec.finish()
        return rec
