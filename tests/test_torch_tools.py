"""The port's builtin toolkits (``youtu_rag_tpu_torch/tools``) against the
JAX package's, on the CPU.

- the registry: ``TOOLKIT_MAP``'s keys are JAX's, and every registered
  toolkit's ``get_tools_in_openai()`` equals JAX's;
- the host toolkits (``file_edit``, ``file``, ``html``, ``tabular``,
  ``codesnip``, ``bash``, ``python_executor``, ``memory_simple``,
  ``user_interaction``, the gated media and web adapters) give the same
  outputs on the same inputs, each in a workspace of its own (the
  workspace path reads ``<ws>`` in both);
- the KB toolkits over a port KB on the CPU and a JAX KB built from the
  same seeded sources, their hash embedders on the Python path: ``rag``
  (add, search, stats, clear), ``meta_retrieval`` (temporal analysis,
  filtered search, scope expansion, merge, the popularity preference) and
  ``text2sql`` (schema link, SQL, tables, the link → generate → execute →
  answer agent with a scripted client, the orchestra worker, then over a
  ``sqlite:///`` ``database_url``) return the same text;
- MCP: list and call over a local stdio server script (no network), and
  the web toolkits on a fake transport.

Tolerance: none; the tools print scores with three decimals and their
texts must be equal (the hash embedder's Python path agrees bit for bit,
``tests/test_torch_kb.py``)."""

import asyncio
import json
import sqlite3
import sys

import numpy as np
import pandas as pd
import pytest

import youtu_rag_tpu.tools as jax_tools
import youtu_rag_tpu.tools.builtin  # noqa: F401 - fills the registry
from youtu_rag_tpu.agents.llm import FakeChatClient as JaxFake
from youtu_rag_tpu.agents.llm_agent import LLMAgent as JaxLLMAgent
from youtu_rag_tpu.core.config import IndexConfig as JaxIndexConfig
from youtu_rag_tpu.core.config import RAGConfig as JaxRAGConfig
from youtu_rag_tpu.core.config import VectorStoreConfig as JaxVectorStoreConfig
from youtu_rag_tpu.core.types import Document as JaxDocument
from youtu_rag_tpu.ingest.processors import SourceTask as JaxSourceTask
from youtu_rag_tpu.retrieval.kb import KnowledgeBase as JaxKB
from youtu_rag_tpu.tools.base import ToolkitConfig as JaxToolkitConfig
from youtu_rag_tpu.tools.text2sql import Text2SQLAgent as JaxText2SQLAgent
from youtu_rag_tpu.tools.text2sql import Text2SQLWorkerAgent as JaxWorker
from youtu_rag_tpu_torch import tools
from youtu_rag_tpu_torch.agents.llm import FakeChatClient
from youtu_rag_tpu_torch.agents.llm_agent import LLMAgent
from youtu_rag_tpu_torch.core.config import IndexConfig, RAGConfig, VectorStoreConfig
from youtu_rag_tpu_torch.core.types import Document
from youtu_rag_tpu_torch.ingest.processors import SourceTask
from youtu_rag_tpu_torch.retrieval.kb import KnowledgeBase
from youtu_rag_tpu_torch.tools.base import ToolkitConfig
from youtu_rag_tpu_torch.tools.text2sql import Text2SQLAgent, Text2SQLWorkerAgent

import youtu_rag_tpu_torch.tools.builtin  # noqa: E402,F401,I001 - fills the registry

TOOLKIT_MAP, JAX_TOOLKIT_MAP = tools.TOOLKIT_MAP, jax_tools.TOOLKIT_MAP

PORT = {"tools": tools, "cfg": ToolkitConfig, "kb": KnowledgeBase, "rag": RAGConfig,
        "vs": VectorStoreConfig, "index": IndexConfig, "doc": Document, "task": SourceTask,
        "fake": FakeChatClient, "llm": LLMAgent, "t2s": Text2SQLAgent,
        "worker": Text2SQLWorkerAgent, "device": {"device": "cpu"}}
JAX = {"tools": jax_tools, "cfg": JaxToolkitConfig, "kb": JaxKB, "rag": JaxRAGConfig,
       "vs": JaxVectorStoreConfig, "index": JaxIndexConfig, "doc": JaxDocument,
       "task": JaxSourceTask, "fake": JaxFake, "llm": JaxLLMAgent, "t2s": JaxText2SQLAgent,
       "worker": JaxWorker, "device": {}}


def both(fn, tmp_path):
    """fn(pkg, workspace) on each package in a workspace of its own; the
    workspace's path reads <ws> in the outputs."""
    outs = []
    for name, pkg in (("port", PORT), ("jax", JAX)):
        ws = tmp_path / name
        ws.mkdir()
        out = asyncio.run(fn(pkg, ws))
        outs.append(json.loads(json.dumps(out, default=str).replace(str(ws), "<ws>")))
    return outs


# ---------------------------------------------------------------------------
# the registry and the schemas
# ---------------------------------------------------------------------------


def test_toolkit_map_keys_match_jax():
    assert sorted(TOOLKIT_MAP) == sorted(JAX_TOOLKIT_MAP)
    with pytest.raises(KeyError):
        tools.get_toolkit("no_such_toolkit")


@pytest.mark.parametrize("name", sorted(JAX_TOOLKIT_MAP))
def test_toolkit_schemas_match_jax(name, tmp_path):
    """get_toolkit builds every name of JAX's registry; the tools it offers
    an agent are JAX's, schema for schema (a toolkit that makes a store or
    a KB takes device "cpu" here)."""
    cfg = {"workspace": str(tmp_path), "workspace_root": str(tmp_path),
           "output_dir": str(tmp_path), "path": str(tmp_path / "notes.jsonl")}
    port = tools.get_toolkit(name, ToolkitConfig(name=name, config={**cfg, "device": "cpu"}))
    want = jax_tools.get_toolkit(name, JaxToolkitConfig(name=name, config=cfg))
    assert type(port).__name__ == type(want).__name__
    assert port.get_tools_in_openai() == want.get_tools_in_openai()
    assert port.get_tools_in_mcp() == want.get_tools_in_mcp()


# ---------------------------------------------------------------------------
# host toolkits: the same outputs on the same inputs
# ---------------------------------------------------------------------------


async def calls(tk, script):
    out = []
    for tool, args in script:
        try:
            out.append(await tk.call_tool(tool, args))
        except Exception as e:  # noqa: BLE001 - the raise is part of what is compared
            out.append(f"raised {type(e).__name__}: {e}")
    return out


def write_table(ws):
    pd.DataFrame({"a": [1, 2, 3, 4], "b": ["x", "y", "x", "z"],
                  "c": [0.5, 1.5, 2.5, np.nan]}).to_csv(ws / "t.csv", index=False)
    return str(ws / "t.csv")


HOST_CASES = {
    "file_edit": (lambda ws: {"workspace_root": str(ws), "backup_enabled": False}, lambda ws: [
        ("write_file", {"file_path": "notes.md", "content": "hello\nworld\n"}),
        ("read_file", {"file_path": "notes.md"}),
        ("edit_file", {"file_path": "notes.md", "diff": "<<<<<<< SEARCH\nhello\n=======\nhi\n"
                       ">>>>>>> REPLACE\n<<<<<<< SEARCH\nmissing\n=======\nx\n>>>>>>> REPLACE"}),
        ("read_file", {"file_path": "notes.md"}),
        ("edit_file", {"file_path": "notes.md", "diff": "not a diff"}),
        ("write_file", {"file_path": "sub/we ird$name.txt", "content": "ok"}),
        ("list_files", {}),
        ("read_file", {"file_path": "../outside.txt"}),
    ]),
    "file": (lambda ws: {"workspace": str(ws)}, lambda ws: [
        ("write_file", {"path": "a/b.txt", "content": "text"}),
        ("read_file", {"path": "a/b.txt", "max_chars": 2}),
        ("list_files", {"path": "a"}),
        ("read_file", {"path": "nope.txt"}),
        ("read_file", {"path": "../../etc/passwd"}),
    ]),
    "html": (lambda ws: {"output_dir": str(ws)}, lambda ws: [
        ("markdown_preview", {"markdown": "# Title\nSome **bold** and `code`.\n\n- one\n- two\n\n"
                              "| a | b |\n|---|---|\n| 1 | 2 |\n\n```\nraw\n```\n> quoted\n"
                              "<script>alert(1)</script>"}),
        ("render_html_report", {"markdown": "# Hi\ncontent", "title": "T", "filename": "r.html"}),
    ]),
    "tabular": (lambda ws: {}, lambda ws: [
        ("tabular_overview", {"path": write_table(ws)}),
        ("tabular_column_stats", {"path": str(ws / "t.csv"), "column": "a"}),
        ("tabular_column_stats", {"path": str(ws / "t.csv"), "column": "b"}),
        ("tabular_column_stats", {"path": str(ws / "t.csv"), "column": "zz"}),
        ("tabular_overview", {"path": str(ws / "missing.csv")}),
    ]),
    "codesnip": (lambda ws: {}, lambda ws: [
        ("run_snippet", {"code": "print(6 * 7)"}),
        ("run_snippet", {"code": "import sys; sys.stderr.write('err')"}),
        ("run_snippet", {"code": "pass"}),
    ]),
    "bash": (lambda ws: {"workspace": str(ws)}, lambda ws: [
        ("run_bash", {"command": "echo hi > f.txt && cat f.txt && ls"}),
        ("run_bash", {"command": "true"}),
        ("run_bash", {"command": "echo oops >&2; exit 3"}),
    ]),
    "python_executor": (lambda ws: {"workspace": str(ws)}, lambda ws: [
        ("execute_python_code", {"code": "print(sum(range(10)))"}),
        ("execute_python_code", {"code": "import sys; print('o'); sys.stderr.write('e')"}),
        ("execute_python_code", {"code": "raise SystemExit(0)"}),
    ]),
    "memory_simple": (lambda ws: {"path": str(ws / "mem.jsonl")}, lambda ws: [
        ("recall", {}),
        ("remember", {"note": "prefer bf16"}),
        ("remember", {"note": "block rows 2048"}),
        ("recall", {"keyword": "BF16"}),
        ("recall", {"limit": 1}),
        ("recall", {"keyword": "none"}),
    ]),
    "user_interaction": (lambda ws: {"ask_fn": lambda q: f"answer to: {q}"}, lambda ws: [
        ("ask_user", {"question": "which file?"}),
    ]),
    "image": (lambda ws: {}, lambda ws: [
        ("image_qa", {"path": str(ws / "img.png"), "question": "?"}),
    ]),
    "search": (lambda ws: {}, lambda ws: [
        ("web_search", {"query": "x"}),
    ]),
    "document": (lambda ws: {}, lambda ws: [
        ("document_qa", {"path": write_table(ws), "question": "what is a?"}),
        ("document_qa", {"path": str(ws / "missing.pdf"), "question": "?"}),
    ]),
}


@pytest.mark.parametrize("name", sorted(HOST_CASES))
def test_host_toolkit_outputs_match_jax(name, tmp_path, monkeypatch):
    for key in ("YRT_SERPER_API_KEY", "SERPER_API_KEY", "YRT_VISION_URL"):
        monkeypatch.delenv(key, raising=False)
    make_cfg, script = HOST_CASES[name]

    async def run(pkg, ws):
        tk = pkg["tools"].get_toolkit(name, pkg["cfg"](name=name, config=make_cfg(ws)))
        return await calls(tk, script(ws))

    got, want = both(run, tmp_path)
    assert got == want
    assert not any(o.startswith(("raised ModuleNotFoundError", "raised ValueError: Tool"))
                   for o in got)


# ---------------------------------------------------------------------------
# MCP over a local stdio server, the web toolkits on a fake transport
# ---------------------------------------------------------------------------

MCP_SERVER = r'''
import json, sys

def reply(obj):
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()

for line in sys.stdin:
    msg = json.loads(line)
    m, rid = msg.get("method"), msg.get("id")
    if m == "initialize":
        reply({"jsonrpc": "2.0", "id": rid, "result": {"protocolVersion": "2024-11-05",
               "serverInfo": {"name": "demo", "version": "0"}, "capabilities": {}}})
    elif m == "tools/list":
        reply({"jsonrpc": "2.0", "id": rid, "result": {"tools": [
            {"name": "add", "description": "Add two numbers",
             "inputSchema": {"type": "object", "properties": {"a": {"type": "integer"},
              "b": {"type": "integer"}}, "required": ["a", "b"]}},
            {"name": "echo", "description": "Echo structured content",
             "inputSchema": {"type": "object", "properties": {"x": {"type": "string"}}}},
            {"name": "fail", "description": "Always errors",
             "inputSchema": {"type": "object", "properties": {}}}]}})
    elif m == "tools/call":
        name, args = msg["params"]["name"], msg["params"]["arguments"]
        if name == "add":
            reply({"jsonrpc": "2.0", "id": rid, "result": {"content": [
                {"type": "text", "text": str(args["a"] + args["b"])}]}})
        elif name == "echo":
            reply({"jsonrpc": "2.0", "id": rid, "result": {"content": [
                {"type": "text", "text": args.get("x", "")}, {"type": "image", "data": "..."}]}})
        else:
            reply({"jsonrpc": "2.0", "id": rid, "result": {"isError": True,
                   "content": [{"type": "text", "text": "boom"}]}})
'''


@pytest.mark.parametrize("activated", [None, ["add", "fail"]], ids=["all", "activated"])
def test_mcp_stdio_list_and_call_match_jax(tmp_path, activated):
    server = tmp_path / "server.py"
    server.write_text(MCP_SERVER)

    async def run(pkg, ws):
        tk = pkg["tools"].get_toolkit("mcp", pkg["cfg"](
            name="mcp", mode="mcp", activated_tools=activated,
            config={"command": sys.executable, "args": [str(server)]}))
        await tk.build()
        try:
            schemas = tk.get_tools_in_openai()
            outs = await calls(tk, [("add", {"a": 20, "b": 22}), ("echo", {"x": "hi"}),
                                    ("fail", {}), ("missing", {})])
        finally:
            await tk.cleanup()
        return schemas, outs

    got, want = both(run, tmp_path)
    assert got == want
    assert got[1][0] == "42" and got[1][2].startswith("Error: boom")
    assert len(got[0]) == (3 if activated is None else 2)


def test_web_toolkits_on_a_fake_transport_match_jax(tmp_path, monkeypatch):
    """search (Serper-style POST through utils/http.py) and wikipedia (GET)
    against an httpx MockTransport: no request leaves the process."""
    import httpx

    seen = []

    def handler(request):
        seen.append((request.method, request.url.host, request.url.path))
        if request.url.host == "google.serper.dev":
            return httpx.Response(200, json={"organic": [
                {"title": "T1", "link": "https://a.example/1", "snippet": "s1"},
                {"title": "T2", "link": "https://a.example/2", "snippet": "s2"}]})
        return httpx.Response(200, json={"query": {"search": [
            {"title": "Jupiter", "snippet": "largest <b>planet</b>"}]},
            "extract": "Jupiter is the fifth planet."})

    real = httpx.AsyncClient

    def fake_client(*a, **kw):
        kw["transport"] = httpx.MockTransport(handler)
        return real(*a, **kw)

    monkeypatch.setattr(httpx, "AsyncClient", fake_client)
    monkeypatch.setenv("YRT_SERPER_API_KEY", "test-key")

    async def run(pkg, ws):
        out = []
        for name, tool, args in (("search", "web_search", {"query": "jupiter", "num_results": 2}),
                                 ("wikipedia", "wikipedia_search", {"query": "jupiter"})):
            tk = pkg["tools"].get_toolkit(name, pkg["cfg"](name=name))
            out.append(await calls(tk, [(tool, args)]))
        return out

    got, want = both(run, tmp_path)
    assert got == want
    assert "T1" in got[0][0] and seen and all(h != "" for _, h, _ in seen)


# ---------------------------------------------------------------------------
# the KB toolkits: rag, meta_retrieval, text2sql
# ---------------------------------------------------------------------------


def make_kb(pkg, name: str):
    cfg = pkg["rag"](name=name, vector_store=pkg["vs"](index=pkg["index"](min_capacity=256,
                                                                          block_rows=128)))
    kb = pkg["kb"](name, cfg, **pkg["device"])
    kb.embedder._use_native = False  # the Python hash path on both sides
    return kb


def without_engine(stats: str) -> dict:
    """rag_stats' JSON less the fields that name the engine."""
    out = json.loads(stats)
    out.pop("device", None)
    out.pop("backend")
    return out


def test_rag_toolkit_matches_jax(tmp_path):
    async def run(pkg, ws):
        name = "ragtk"
        raw = {"name": name, "vector_store": {"index": {"min_capacity": 256, "block_rows": 128}}}
        tk = pkg["tools"].get_toolkit("rag", pkg["cfg"](
            name="rag", config={"rag_config": raw, "name": name, **pkg["device"]}))
        tk.kb.embedder._use_native = False
        out = [await tk.call_tool("rag_build", {"texts": [
            "jupiter is the largest planet", "cats are small felines",
            "sourdough rises with wild yeast"], "source": "inline"})]
        out.append(await tk.call_tool("rag_retrieve", {"query": "largest planet jupiter",
                                                       "top_k": 2}))
        out.append(without_engine(await tk.call_tool("rag_stats", {})))
        out.append(await tk.call_tool("rag_clear", {}))
        out.append(await tk.call_tool("rag_retrieve", {"query": "jupiter"}))
        return out, str(getattr(tk.kb, "device", "cpu"))

    (got, device), (want, _) = both(run, tmp_path)
    assert got == want and device == "cpu"
    assert "3 documents" in got[0] and "jupiter" in got[1] and "cleared 3" in got[3]


# 32 dated documents over 2019-2022, two topics; some carry citations
META_TOPICS = ("transformer attention retrieval", "graph neural network molecules")


def meta_documents(pkg):
    import datetime

    rng = np.random.default_rng(3)
    docs = []
    for i in range(32):
        year, month = 2019 + i % 4, 1 + int(rng.integers(0, 12))
        ts = int(datetime.datetime(year, month, 15).timestamp())
        topic = META_TOPICS[i % 2]
        meta = {"publish_ts": ts, "source": f"paper-{i}"}
        if i % 3:
            meta["citations"] = int(rng.integers(0, 500))
        docs.append(pkg["doc"](f"paper-{i}", f"Paper {i} ({year}-{month:02d}) on {topic}: "
                               + " ".join(rng.choice(topic.split(), size=12)), meta))
    return docs


def test_meta_retrieval_toolkit_matches_jax(tmp_path):
    async def run(pkg, ws):
        kb = make_kb(pkg, "meta")
        await kb.build_documents(meta_documents(pkg))
        tk = pkg["tools"].get_toolkit("meta_retrieval", pkg["cfg"](
            name="meta_retrieval", config={"kb": kb}))
        script = [
            ("query_analysis", {"query": "attention retrieval papers from 2021", "session_id": "a"}),
            ("kb_embedding_search", {"query": "transformer attention retrieval", "top_k": 4,
                                     "session_id": "a"}),
            ("expand_filter_scope", {"session_id": "a", "factor": 3.0}),
            ("kb_embedding_search", {"query": "attention", "top_k": 4, "session_id": "a"}),
            ("merge_retrieval_results", {"session_id": "a", "top_k": 5}),
            ("query_analysis", {"query": "papers between 2019 and 2020 on graphs",
                                "session_id": "b"}),
            ("kb_embedding_search", {"query": "graph neural network", "top_k": 3,
                                     "session_id": "b", "use_time_filter": True}),
            ("query_analysis", {"query": "the most cited molecules work", "session_id": "c"}),
            ("kb_embedding_search", {"query": "graph molecules", "top_k": 3, "session_id": "c"}),
            ("expand_filter_scope", {"session_id": "c"}),
            ("query_analysis", {"query": "work from 2020-03 on graphs", "session_id": "d"}),
            ("kb_embedding_search", {"query": "graph", "top_k": 5, "session_id": "d"}),
        ]
        return await calls(tk, script)

    got, want = both(run, tmp_path)
    assert got == want
    assert json.loads(got[0])["has_temporal_intent"] and "(2021-" in got[1]
    assert "(2019-" not in got[1] and "(2022-" not in got[1]


T2S_SQL = 'SELECT employee, salary FROM "{t}" ORDER BY salary DESC LIMIT 1'


def t2s_rule(fake, table, state):
    """The scripted model of text2sql: a bad first draft, then the SQL."""

    def rule(messages, tools_):
        content = messages[-1].content or ""
        if content.startswith("You translate questions"):
            state["drafts"] += 1
            if state["drafts"] % 2 == 1:
                return fake.text_response("SELECT nope FROM missing;")
            return fake.text_response(f"```sql\n{T2S_SQL.format(t=table)}\n```")
        if content.startswith("Answer the question"):
            return fake.text_response("frank earns the most (130).")
        return fake.text_response("?")

    return rule


def t2s_sources(ws):
    pd.DataFrame({"employee": ["alice", "bob", "carol", "dave", "erin", "frank"],
                  "department": ["eng", "eng", "sales", "sales", "hr", "eng"],
                  "salary": [120, 110, 90, 95, 80, 130]}).to_csv(ws / "staff.csv", index=False)
    pd.DataFrame({"city": ["paris", "rome", "oslo"], "country": ["fr", "it", "no"]}).to_csv(
        ws / "cities.csv", index=False)
    pd.DataFrame({"sku": ["a1", "b2"], "price": [3.5, 4.0]}).to_csv(ws / "prices.csv",
                                                                    index=False)
    pd.DataFrame({"team": ["eng", "sales"], "lead": ["alice", "carol"]}).to_csv(
        ws / "teams.csv", index=False)
    return ["staff.csv", "cities.csv", "prices.csv", "teams.csv"]


def test_text2sql_toolkit_and_agent_match_jax(tmp_path):
    async def run(pkg, ws):
        kb = make_kb(pkg, "t2s")
        names = t2s_sources(ws)
        report = await kb.build_sources([pkg["task"](n, "table", path=str(ws / n))
                                         for n in names])
        assert report.failed == 0
        table = next(t for t in report.tables if t.startswith("staff"))
        tk = pkg["tools"].get_toolkit("text2sql", pkg["cfg"](name="text2sql", config={"kb": kb}))
        out = [sorted(report.tables)]
        out += await calls(tk, [
            ("schema_link", {"query": "which employee has the highest salary?", "top_k": 2}),
            ("execute_sql", {"sql": f'SELECT employee FROM "{table}" WHERE salary > 115'}),
            ("execute_sql", {"sql": f'DELETE FROM "{table}"'}),
            ("list_tables", {})])
        state = {"drafts": 0}
        llm = pkg["llm"](client=pkg["fake"](rule_fn=t2s_rule(pkg["fake"], table, state)))
        out.append(await pkg["t2s"](tk, llm).text2sql("who earns the most?"))
        rec = await pkg["worker"](tk, llm).run("Overall context so far:\n-\n\n"
                                               "Your subtask: who earns the most?")
        out.append([rec.final_output, [(t.name, t.arguments, t.output) for t in rec.tool_calls]])
        out.append(state["drafts"])

        # the same toolkit over an external sqlite database (database_url)
        db = ws / "ext.sqlite"
        conn = sqlite3.connect(db)
        conn.execute(f'CREATE TABLE "{table}" (employee TEXT, department TEXT, salary INTEGER)')
        conn.executemany(f'INSERT INTO "{table}" VALUES (?, ?, ?)',
                         [("zed", "eng", 200), ("amy", "hr", 70)])
        conn.commit()
        conn.close()
        ext = pkg["tools"].get_toolkit("text2sql", pkg["cfg"](
            name="text2sql", config={"kb": kb, "database_url": f"sqlite:///{db}"}))
        out += await calls(ext, [
            ("schema_link", {"query": "which employee has the highest salary?", "top_k": 2}),
            ("execute_sql", {"sql": T2S_SQL.format(t=table)}),
            ("list_tables", {})])
        state["drafts"] = 0
        out.append(await pkg["t2s"](ext, llm).text2sql("who earns the most?"))
        return out

    got, want = both(run, tmp_path)
    assert got == want
    assert "CREATE TABLE" in got[1] and json.loads(got[2])["rows"] == [["alice"], ["frank"]]
    assert "error" in json.loads(got[3])
    assert got[5]["result"]["rows"][0][0] == "frank" and "frank" in got[5]["answer"]
    assert json.loads(got[9])["rows"][0][0] == "zed" and got[11]["result"]["rows"][0][0] == "zed"


def test_db_adapter_matches_jax(tmp_path):
    from youtu_rag_tpu.db.adapters import adapter_from_url as jax_adapter
    from youtu_rag_tpu_torch.db.adapters import adapter_from_url

    db = tmp_path / "a.sqlite"
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE t (id INTEGER, name TEXT)")
    conn.executemany("INSERT INTO t VALUES (?, ?)", [(i, f"n{i}") for i in range(5)])
    conn.commit()
    conn.close()
    outs = []
    for make in (adapter_from_url, jax_adapter):
        a = make(f"sqlite:///{db}")
        res = [a.list_tables(), a.table_ddl("t"), a.query("SELECT * FROM t WHERE id > 2", limit=1)]
        for bad in ("DELETE FROM t", "SELECT 1; DROP TABLE t", "WITH x AS (SELECT 1) DELETE FROM t"):
            try:
                a.query(bad)
                res.append("ran")
            except ValueError as e:
                res.append(str(e))
        a.close()
        try:
            make("mysql://u:p@localhost/db", driver=None).query("SELECT 1")
        except Exception as e:  # noqa: BLE001 - no MySQL driver here: the same gated error
            res.append(type(e).__name__)
        outs.append(res)
    assert outs[0] == outs[1]
