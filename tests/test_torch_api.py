"""The port's HTTP/SSE API against the JAX package's, on the CPU.

One request script drives both apps, the JAX package's
``create_app(ApiState(...))`` and the port's ``create_app(ApiState(...,
device="cpu"))``, each served on localhost from a data dir of its own.
Every route group of the app has a script; the responses must be equal
after dropping wall-time fields, the data-dir prefix of paths and the
random ids of a run. Floats agree within ``TOL`` (bf16 index, f32 sums in
another order), and ranked lists may swap entries whose scores lie within
``TOL`` (``same_up_to_ties``). SSE and WebSocket card sequences are
compared the same way, card by card.

Three fields name the engine and differ by design: a KB's ``backend``
("tpu" against "torch"), the ``device`` the port's KB stats add, and the
storage backend class the build report and the monitor name
(``ENGINE_NAMES``)."""

from __future__ import annotations

import asyncio
import csv
import io
import json
import re
import sqlite3
import tempfile
import zipfile

import numpy as np
import pytest

from torch_api_helpers import (  # noqa: F401 - port_registry is a fixture
    Served, make_state, multipart, package, port_registry, sse_cards)
from torch_native_helpers import jax_lib, jax_tracer_restored  # noqa: F401 - fixtures

pytestmark = pytest.mark.usefixtures("jax_tracer_restored")

TOL = 1e-4
WALL = {"retrieval_time_ms", "uploaded_at", "time", "created_at", "executed_at", "duration_s",
        # the storage monitor's clock and the query latencies it logs
        "checked_at", "last_check_time", "avg_latency_ms", "p50_latency_ms", "p95_latency_ms",
        "max_latency_ms",
        # a tool call's wall time in a stored trajectory
        "duration_ms"}
RANDOM_IDS = [
    (re.compile(r"run_[0-9a-f]+"), "run_*"),
    (re.compile(r"mem-[0-9a-f]{16}"), "mem-*"),
    (re.compile(r"up-[0-9a-f]{12}"), "up-*"),
    (re.compile(r"sess-[0-9a-f]{8}"), "sess-*"),
]
# (key, JAX value, port value): fields that name the engine
ENGINE_NAMES = {
    ("backend", "tpu", "torch"),
    ("backend", "tpu_device_index", "torch_device_index"),
    ("backend", "TpuVectorStore", "TorchVectorStore"),
}
PORT_ONLY_KEYS = {"device"}

FACTS = {
    "zoka.md": "# Zoka\nThe color of Zoka is teal. Zoka has a mass of 230 kg.",
    "vexaril.md": "# Vexaril\nThe launch code of Vexaril is 4821. Vexaril orbits a cold star.",
    "moon.md": "# Moon\nThe moon orbits the earth once every twenty-seven days.",
    "pasta.md": "# Pasta\nBoil pasta for ten minutes in salted water, then drain it.",
    "vault.md": "# Vault\nRegistry code ZX-9981 belongs to the vault door of the archive.",
}
FILLER = "notes archive record paragraph section appendix summary outline draft figure".split()
WORDS = ("alpha beta gamma delta epsilon zeta eta theta iota kappa lambda mu nu xi omicron pi "
         "rho sigma tau upsilon phi chi psi omega amber birch cedar dune ember fjord grove "
         "harbor inlet jade kelp lagoon marsh").split()


def documents(seed: int = 0) -> list[dict]:
    rng = np.random.default_rng(seed)
    docs = []
    for i, (name, text) in enumerate(sorted(FACTS.items())):
        body = text + "\n\n" + " ".join(rng.choice(FILLER, size=120)) + "."
        docs.append({"id": name, "content": body,
                     "metadata": {"topic": "space" if i % 2 else "misc", "n": i}})
    return docs


# ---------------------------------------------------------------------------
# normalising and comparing responses
# ---------------------------------------------------------------------------


def normalize(x, data_dir: str):
    if isinstance(x, dict):
        return {k: normalize(v, data_dir) for k, v in x.items() if k not in WALL}
    if isinstance(x, list):
        return [normalize(v, data_dir) for v in x]
    if isinstance(x, str):
        x = x.replace(data_dir, "<data>")
        for pat, sub in RANDOM_IDS:
            x = pat.sub(sub, x)
        return x
    return x


def identity(item: dict):
    return item.get("chunk_id") or item.get("content")


def is_ranked(xs) -> bool:
    return bool(xs) and all(isinstance(x, dict) and "score" in x and identity(x) for x in xs)


def same_up_to_ties(got: list[dict], want: list[dict], tol: float = TOL) -> bool:
    """The same entry at each rank with scores within ``tol``, except that
    entries whose reference scores lie within ``tol`` of each other may
    trade places."""
    if len(got) != len(want):
        return False
    want_score = {identity(w): w["score"] for w in want}
    for g, w in zip(got, want):
        if abs(g["score"] - w["score"]) > tol:
            return False
        if identity(g) != identity(w) and abs(want_score.get(identity(g), np.inf) - w["score"]) > tol:
            return False
    return True


def assert_same(got, want, where: str = "") -> None:
    """``got`` (the port's) equals ``want`` (JAX's) up to the tolerances
    of the module docstring."""
    if isinstance(want, dict):
        assert isinstance(got, dict), where
        got = {k: v for k, v in got.items() if k not in PORT_ONLY_KEYS}
        assert got.keys() == want.keys(), (where, sorted(got), sorted(want))
        for k in want:
            if isinstance(want[k], str) and (k, want[k], got[k]) in ENGINE_NAMES:
                continue
            assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (where, got, want)
        if is_ranked(want) and is_ranked(got):
            assert same_up_to_ties(got, want), (where, [(identity(g), g["score"]) for g in got],
                                                [(identity(w), w["score"]) for w in want])
            by_id = {identity(g): g for g in got}
            for w in want:
                if identity(w) in by_id:
                    assert_same({**by_id[identity(w)], "score": w["score"], "rank": w.get("rank")},
                                {**w, "rank": w.get("rank")}, f"{where}[{identity(w)}]")
            return
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, float) and isinstance(got, (int, float)):
        assert abs(got - want) <= TOL, (where, got, want)
    else:
        assert got == want, (where, got, want)


class Recorder:
    """A served app and the normalised responses of the script it runs."""

    def __init__(self, pkg, state):
        self.pkg, self.state = pkg, state
        self.app = Served(pkg.app.create_app(state))
        self.data_dir = str(state.data_dir)
        self.log: list[tuple[str, object]] = []

    def keep(self, label: str, value) -> None:
        self.log.append((label, normalize(value, self.data_dir)))

    async def call(self, label: str, path: str, method: str = "GET", body=None,
                   headers=None, kind: str = "json"):
        r = await self.app.fetch(path, method, body, headers)
        if kind == "sse":
            assert r.headers["Content-Type"].startswith("text/event-stream"), label
            payload = sse_cards(r.body)
        elif kind == "text":
            payload = r.body.decode("utf-8")
        elif kind == "bytes":
            payload = r.body
        elif kind == "zip":
            with zipfile.ZipFile(io.BytesIO(r.body)) as z:
                payload = {n: z.read(n).decode("utf-8", "replace") for n in sorted(z.namelist())}
        else:
            payload = json.loads(r.body) if r.body else None
        self.keep(label, {"code": r.code, "body": payload})
        return r.code, payload

    async def ws(self, label: str, message: dict, until: tuple = ("done",)):
        cards = await self.app.ws_cards(message, until)
        self.keep(label, cards)
        return cards


def run_both(script, setup=None, prefix: str = "yrt-parity") -> tuple[list, list]:
    """Run ``script(rec)`` against the JAX app, then the port's, each on a
    fresh ``ApiState``; ``setup(pkg, state)`` (async) may equip the state
    first. Returns both logs."""

    async def one(name: str):
        pkg = package(name)
        state = make_state(pkg, prefix)
        if setup is not None:
            await setup(pkg, state)
        rec = Recorder(pkg, state)
        try:
            await script(rec)
        finally:
            await rec.app.close()
            # each package's process-wide registry forgets this run's KBs
            for name in state.kbs.names():
                pkg.kb.GLOBAL_KB_REGISTRY.remove(name)
        return rec.log

    return asyncio.run(one("jax")), asyncio.run(one("port"))


def assert_same_logs(port_log, jax_log) -> None:
    assert [label for label, _ in port_log] == [label for label, _ in jax_log]
    for (label, got), (_, want) in zip(port_log, jax_log):
        assert_same(got, want, label)


# ---------------------------------------------------------------------------
# agents the scripts chat with
# ---------------------------------------------------------------------------


def chat_rule(F):
    """Pick ``kb_search`` when asked to select agents; call the KB tool
    once, then answer with the first line of what it returned."""

    def rule(messages, tools):
        last = messages[-1].content or ""
        if last.startswith("Select the best agent") or "selected_agents" in last \
                or "Available agents" in last:
            return F.text_response('["kb_search", "orchestra"]')
        if messages[-1].role == "tool":
            return F.text_response("answer: " + last.splitlines()[0][:80])
        if tools and any(t["function"]["name"] == "kb_embedding_search" for t in tools):
            return F.tool_response("kb_embedding_search", {"query": last.splitlines()[-1]})
        return F.text_response("plain answer")

    return rule


async def chat_agent(pkg, state, kb: str = "facts") -> None:
    cfg = pkg.AgentConfig()
    cfg.toolkits["kb_search"] = pkg.ToolkitConfig(name="kb_search", config={"kb": kb})
    state.agent_config = cfg
    state.agent = pkg.SimpleAgent(cfg, client=pkg.FakeChatClient(rule_fn=chat_rule(pkg.FakeChatClient)),
                                  **pkg.kw)
    await state.agent.build()


# ---------------------------------------------------------------------------
# the scripts, one per route group
# ---------------------------------------------------------------------------


async def health_and_agents(rec: Recorder):
    await rec.call("health", "/health")
    await rec.call("agents", "/api/agents")
    await rec.call("switch orchestra", "/api/agents/switch", "POST", {"type": "orchestra"})
    await rec.call("agents after switch", "/api/agents")
    await rec.call("switch bogus", "/api/agents/switch", "POST", {"type": "bogus"})
    await rec.call("bad json", "/api/agents/switch", "POST", "{not json")
    await rec.call("health after switch", "/health")


async def chat(rec: Recorder):
    await rec.call("build facts", "/api/knowledge-bases/facts/build", "POST",
                   {"documents": documents()})
    await rec.call("non-stream", "/api/chat", "POST",
                   {"query": "What is the color of Zoka?", "stream": False})
    await rec.call("sse", "/api/chat", "POST", {"query": "What is the launch code of Vexaril?"},
                   kind="sse")
    await rec.call("sse kb_id", "/api/chat", "POST",
                   {"query": "moon orbit", "kb_id": "facts"}, kind="sse")
    await rec.call("sse unknown kb", "/api/chat", "POST", {"query": "q", "kb_id": "ghost"})
    await rec.call("auto-select", "/api/chat", "POST",
                   {"query": "What is the mass of Zoka?", "auto_select": True}, kind="sse")
    await rec.call("auto-select non-stream", "/api/chat", "POST",
                   {"query": "q", "auto_select": True, "stream": False})
    await rec.call("missing query", "/api/chat", "POST", {})
    rec.state.files.upload("uploads", "notes.md", b"HBM runs at 820 GB/s")
    await rec.call("file attached", "/api/chat", "POST",
                   {"query": "summarize", "file_ids": ["notes.md"], "stream": False})
    await rec.call("file missing", "/api/chat", "POST",
                   {"query": "q", "file_ids": ["nope.md"], "stream": False})
    await rec.ws("ws", {"query": "What is the color of Zoka?", "kb_id": "facts"})
    await rec.ws("ws missing query", {"kb_id": "facts"}, until=("error",))
    await rec.ws("ws unknown kb", {"query": "q", "kb_id": "ghost"}, until=("error",))


async def kb_lifecycle(rec: Recorder):
    kb = "/api/knowledge-bases"
    await rec.call("create", kb, "POST", {"name": "kb1", "description": "facts corpus"})
    await rec.call("create duplicate", kb, "POST", {"name": "kb1"})
    await rec.call("create bad name", kb, "POST", {"name": "../files"})
    await rec.call("create missing name", kb, "POST", {})
    await rec.call("create int8", kb, "POST", {"name": "kb8", "config": {
        "vector_store": {"index": {"storage_dtype": "int8"}}}})
    await rec.call("create bad config", kb, "POST", {"name": "kbx", "config": {
        "vector_store": {"index": {"storage_dtype": "int3"}}}})
    for name in ("kb1", "kb8"):
        await rec.call(f"build {name}", f"{kb}/{name}/build", "POST", {
            "documents": documents(),
            "qa_pairs": [{"question": "What is the refund window?", "answer": "30 days"},
                         {"question": "Who is the ceo?", "answer": "Jane Doe"}]})
    await rec.call("rebuild skips", f"{kb}/kb1/build", "POST", {"documents": documents()})
    await rec.call("build nothing", f"{kb}/kb1/build", "POST", {})
    await rec.call("build missing file", f"{kb}/kb1/build", "POST", {"files": ["ghost.md"]})
    await rec.call("list", kb)
    await rec.call("get", f"{kb}/kb1")
    await rec.call("get 404", f"{kb}/ghost")
    await rec.call("build logs", f"{kb}/kb1/build-logs")
    for name in ("kb1", "kb8"):
        for mode in ("dense", "hybrid", "lexical"):
            for q in ("What is the color of Zoka?", "code ZX-9981", "moon orbit earth"):
                await rec.call(f"{name} {mode} {q}", f"{kb}/{name}/query", "POST",
                               {"query": q, "mode": mode, "top_k": 4})
        await rec.call(f"{name} filtered", f"{kb}/{name}/query", "POST",
                       {"query": "Zoka", "filters": {"topic": "space"}, "top_k": 10})
    await rec.call("hybrid alpha", f"{kb}/kb1/query", "POST",
                   {"query": "ZX-9981 vault", "mode": "hybrid", "hybrid_alpha": 0.2})
    await rec.call("bad alpha", f"{kb}/kb1/query", "POST",
                   {"query": "q", "mode": "hybrid", "hybrid_alpha": 2})
    await rec.call("bad mode", f"{kb}/kb1/query", "POST", {"query": "q", "mode": "fuzzy"})
    await rec.call("query missing", f"{kb}/kb1/query", "POST", {})
    await rec.call("query 404", f"{kb}/ghost/query", "POST", {"query": "q"})
    await rec.call("qa", f"{kb}/kb1/qa", "POST",
                   {"question": "refund window length?", "threshold": 0.25})
    await rec.call("qa no match", f"{kb}/kb1/qa", "POST",
                   {"question": "zebra stripes", "threshold": 0.95})
    await rec.call("chunks", f"{kb}/kb1/chunks?limit=4")
    await rec.call("chunks page", f"{kb}/kb1/chunks?limit=4&offset=4")
    await rec.call("chunks by doc", f"{kb}/kb1/chunks?document_id=zoka.md")
    await rec.call("chunks text", f"{kb}/kb1/chunks?q=vault")
    await rec.call("chunks qa", f"{kb}/kb1/chunks?index_type=qa")
    await rec.call("chunks 404", f"{kb}/ghost/chunks")
    await rec.call("snapshot save", f"{kb}/kb1/snapshot", "POST", {"action": "save"})
    await rec.call("snapshot bad action", f"{kb}/kb1/snapshot", "POST", {"action": "zap"})
    await rec.call("snapshot restore", f"{kb}/kb1/snapshot", "POST", {"action": "restore"})
    await rec.call("after restore", f"{kb}/kb1/query", "POST", {"query": "Vexaril launch code"})
    await rec.call("create empty", kb, "POST", {"name": "empty"})
    await rec.call("snapshot empty", f"{kb}/empty/snapshot", "POST", {"action": "save"})
    await rec.call("delete", f"{kb}/kb8", "DELETE")
    await rec.call("delete 404", f"{kb}/kb8", "DELETE")
    await rec.call("list after delete", kb)


async def kb_index(rec: Recorder):
    kb = "/api/knowledge-bases"
    # distinct word mixes: no two rows tie on a query's top scores
    rng = np.random.default_rng(1)
    docs = [{"id": f"d{i}", "content": f"topic {i % 7} body {i} " + " ".join(rng.choice(WORDS, 12))}
            for i in range(200)]
    await rec.call("create empty", kb, "POST", {"name": "kbe"})
    await rec.call("ivf on empty", f"{kb}/kbe/index", "POST", {"action": "build_ivf"})
    await rec.call("index empty", f"{kb}/kbe/index")
    for name, cfg in (("kbi", None), ("kbi8", {"vector_store": {"index": {"storage_dtype": "int8"}}})):
        await rec.call(f"create {name}", kb, "POST", {"name": name, **({"config": cfg} if cfg else {})})
        await rec.call(f"build {name}", f"{kb}/{name}/build", "POST", {"documents": docs})
        await rec.call(f"index {name}", f"{kb}/{name}/index")
        await rec.call(f"build_ivf {name}", f"{kb}/{name}/index", "POST",
                       {"action": "build_ivf", "n_lists": 4})
        await rec.call(f"index ivf {name}", f"{kb}/{name}/index")
        for q in ("topic 3 alpha cedar", "body 17 jade marsh", "topic 6 ember kelp omega"):
            await rec.call(f"ivf query {name} {q}", f"{kb}/{name}/query", "POST",
                           {"query": q, "top_k": 3})
        await rec.call(f"delete doc {name}", f"{kb}/{name}/qa-pairs?source_id=d0", "DELETE")
        await rec.call(f"compact {name}", f"{kb}/{name}/index", "POST", {"action": "compact"})
        await rec.call(f"drop_ivf {name}", f"{kb}/{name}/index", "POST", {"action": "drop_ivf"})
        await rec.call(f"index dropped {name}", f"{kb}/{name}/index")
        await rec.call(f"bad action {name}", f"{kb}/{name}/index", "POST", {"action": "zap"})
    await rec.call("index 404", f"{kb}/ghost/index")


async def kb_qa(rec: Recorder):
    kb = "/api/knowledge-bases"
    await rec.call("add pairs", f"{kb}/qkb/qa-pairs", "POST", {"source_id": "faq", "pairs": [
        {"question": "What is the capital of France?", "answer": "Paris", "related_file": "geo.md"},
        {"question": "What is 2+2?", "answer": "4"}]})
    await rec.call("add bad pairs", f"{kb}/qkb/qa-pairs", "POST", {"pairs": [{"answer": "x"}]})
    code, listed = await rec.call("list pairs", f"{kb}/qkb/qa-pairs")
    await rec.call("search pairs", f"{kb}/qkb/qa-pairs?q=capital")
    ids = [p["id"] for p in listed["qa_pairs"]]
    await rec.call("execute", f"{kb}/qkb/qa/execute", "POST", {"id": ids[0]})
    await rec.call("batch execute", f"{kb}/qkb/qa/batch-execute", "POST",
                   {"ids": ids + ["missing-id"]})
    await rec.call("execute missing", f"{kb}/qkb/qa/execute", "POST", {"id": "nope"})
    await rec.call("execute no id", f"{kb}/qkb/qa/execute", "POST", {})
    await rec.call("execute 404 kb", f"{kb}/ghost/qa/execute", "POST", {"id": "x"})
    await rec.call("pairs after execute", f"{kb}/qkb/qa-pairs")
    await rec.call("qa answers", f"{kb}/qkb/qa", "POST", {"question": "capital of France?",
                                                          "threshold": 0.25})
    await rec.call("delete by id", f"{kb}/qkb/qa-pairs?id={ids[1]}", "DELETE")
    await rec.call("delete by source", f"{kb}/qkb/qa-pairs?source_id=faq", "DELETE")
    await rec.call("delete neither", f"{kb}/qkb/qa-pairs", "DELETE")
    await rec.call("pairs empty", f"{kb}/qkb/qa-pairs")
    await rec.call("pairs 404", f"{kb}/ghost/qa-pairs")


async def kb_tables_config_metadata(rec: Recorder):
    kb = "/api/knowledge-bases"
    body, headers = multipart("facts.csv", b"topic,value\nhbm,820\nici,1600\nmxu,8\nvmem,128\n")
    await rec.call("upload csv", "/api/files/upload", "POST", body, headers)
    db_path = f"{tempfile.mkdtemp(prefix='yrt-sqlite-')}/shop.sqlite"
    with sqlite3.connect(db_path) as con:
        con.execute("CREATE TABLE orders (id INTEGER, total REAL)")
        con.executemany("INSERT INTO orders VALUES (?, ?)", [(1, 9.5), (2, 20.0), (3, 4.25)])
    with open(db_path, "rb") as f:
        body, headers = multipart("shop.sqlite", f.read())
    await rec.call("upload sqlite", "/api/files/upload", "POST", body, headers)
    qa_csv = b"question,answer,howtofind\nWhat is HBM?,High bandwidth memory,docs\nWho?,Ann,\n"
    body, headers = multipart("faq.csv", qa_csv)
    await rec.call("upload qa file", "/api/files/upload", "POST", body, headers)
    await rec.call("qa file validate", "/api/qa-files/validate", "POST", {"file": "faq.csv"})
    await rec.call("qa file missing", "/api/qa-files/validate", "POST", {"file": "nope.csv"})
    await rec.call("qa file none", "/api/qa-files/validate", "POST", {})
    await rec.call("db test file", "/api/db/test", "POST", {"file": "shop.sqlite"})
    await rec.call("db test nothing", "/api/db/test", "POST", {})
    await rec.call("db test missing", "/api/db/test", "POST", {"file": "nope.sqlite"})
    await rec.call("db test bad url", "/api/db/test", "POST", {"url": "bogus://x"})
    await rec.call("config put", f"{kb}/tkb/config", "PUT", {"sources": {
        "files": ["facts.csv"], "databases": [{"file": "shop.sqlite"}], "qa_files": ["faq.csv"],
        "documents": [{"id": "inline", "content": "An inline document about HBM."}]}})
    await rec.call("config get", f"{kb}/tkb/config")
    await rec.call("config bad", f"{kb}/tkb/config", "PUT", {"sources": "x"})
    await rec.call("config 404", f"{kb}/ghost/config")
    await rec.call("build from config", f"{kb}/tkb/build", "POST", {"from_config": True})
    await rec.call("tables", f"{kb}/tkb/tables")
    code, tables = await rec.call("tables again", f"{kb}/tkb/tables")
    for t in sorted(x["table_name"] for x in tables["tables"]):
        await rec.call(f"preview {t}", f"{kb}/tkb/tables?table={t}&limit=2")
        await rec.call(f"sql {t}", f"{kb}/tkb/tables", "POST", {"sql": f'SELECT COUNT(*) FROM "{t}"'})
    await rec.call("sql write refused", f"{kb}/tkb/tables", "POST", {"sql": "DROP TABLE x"})
    await rec.call("sql missing", f"{kb}/tkb/tables", "POST", {})
    await rec.call("preview unknown", f"{kb}/tkb/tables?table=nope")
    await rec.call("query csv", f"{kb}/tkb/query", "POST", {"query": "hbm value", "mode": "hybrid"})
    await rec.call("config shrink", f"{kb}/tkb/config", "PUT", {"sources": {"files": ["facts.csv"]}})
    await rec.call("tables after shrink", f"{kb}/tkb/tables")
    await rec.call("drop table", f"{kb}/tkb/tables?table=nope", "DELETE")
    await rec.call("drop no table", f"{kb}/tkb/tables", "DELETE")
    # metadata export and import
    await rec.call("meta build", f"{kb}/mkb/build", "POST", {"documents": [
        {"id": f"d{i}", "content": f"doc {i} text", "metadata": {"lang": "en"}} for i in range(3)]})
    code, exported = await rec.call("meta export", f"{kb}/mkb/metadata", kind="text")
    rows = list(csv.DictReader(io.StringIO(exported)))
    rows[0]["metadata"] = json.dumps({"lang": "fr", "reviewed": True})
    buf = io.StringIO()
    w = csv.DictWriter(buf, fieldnames=list(rows[0]))
    w.writeheader()
    w.writerows(rows)
    await rec.call("meta import csv", f"{kb}/mkb/metadata", "POST", buf.getvalue(),
                   {"Content-Type": "text/csv"})
    await rec.call("meta filtered", f"{kb}/mkb/query", "POST",
                   {"query": "doc", "top_k": 5, "filters": {"lang": "fr"}})
    await rec.call("meta import json", f"{kb}/mkb/metadata", "POST",
                   {"updates": [{"id": rows[1]["chunk_id"], "metadata": {"lang": "de"}}]})
    await rec.call("meta bad csv", f"{kb}/mkb/metadata", "POST", "wrong,header\n1,2",
                   {"Content-Type": "text/csv"})
    await rec.call("meta bad json", f"{kb}/mkb/metadata", "POST",
                   {"updates": [{"id": "x", "metadata": "no"}]})
    await rec.call("meta empty", f"{kb}/mkb/metadata", "POST", {"updates": []})
    await rec.call("meta 404", f"{kb}/ghost/metadata")
    await rec.call("meta export after", f"{kb}/mkb/metadata", kind="text")


async def files(rec: Recorder):
    body, headers = multipart("notes.md", b"# hello\nfile content about Zoka the teal",
                              "text/plain", metadata={"team": "a"})
    await rec.call("upload", "/api/files/upload", "POST", body, headers)
    await rec.call("upload no file", "/api/files/upload", "POST", b"", {"Content-Type": "text/plain"})
    await rec.call("list", "/api/files")
    await rec.call("download", "/api/files/notes.md", kind="text")
    await rec.call("download 404", "/api/files/ghost.md")
    await rec.call("build from file", "/api/knowledge-bases/kbf/build", "POST", {"files": ["notes.md"]})
    await rec.call("references", "/api/files/notes.md/references")
    await rec.call("delete refused", "/api/files/notes.md", "DELETE")
    # OCR derivatives, written as the OCR stage writes them
    files_ = rec.state.files
    files_.upload("uploads", "scan.pdf", b"%PDF-1.4 fake")
    for page, text in ((1, "page one text"), (2, "page two text")):
        files_.upload("uploads", f"page_{page}_scan_ocr.md", text.encode(),
                      {"derived_from": "scan.pdf", "kind": "ocr_page", "page": page})
    files_.upload("uploads", "page_1_scan_ocr.json", json.dumps([{"text": "page one text"}]).encode(),
                  {"derived_from": "scan.pdf"})
    files_.upload("uploads", "page_1_scan_layout.png", b"\x89PNG\r\n\x1a\nfake",
                  {"derived_from": "scan.pdf"})
    files_.upload("uploads", "scan_ocr.md", b"page one text\n\npage two text",
                  {"derived_from": "scan.pdf", "kind": "ocr"})
    await rec.call("ocr view", "/api/files/scan.pdf/ocr")
    await rec.call("ocr layout", "/api/files/scan.pdf/ocr/layout/1", kind="bytes")
    await rec.call("ocr layout 404", "/api/files/scan.pdf/ocr/layout/9")
    await rec.call("ocr edit", "/api/files/scan.pdf/ocr", "PUT",
                   {"page_num": 2, "markdown_text": "CORRECTED page two"})
    await rec.call("ocr edit missing", "/api/files/scan.pdf/ocr", "PUT", {"page_num": 2})
    await rec.call("ocr view edited", "/api/files/scan.pdf/ocr")
    await rec.call("ocr 404", "/api/files/notes.md/ocr")
    await rec.call("zip ocr", "/api/files/scan.pdf/download-with-ocr", kind="zip")
    await rec.call("zip derivatives", "/api/files/scan.pdf/download-with-derivatives", kind="zip")
    await rec.call("zip 404", "/api/files/ghost.pdf/download-with-ocr")
    await rec.call("list with derived", "/api/files")
    await rec.call("delete derived", "/api/files/scan.pdf", "DELETE")
    await rec.call("delete forced", "/api/files/notes.md?force=true", "DELETE")
    await rec.call("delete 404", "/api/files/notes.md", "DELETE")
    await rec.call("list after", "/api/files")
    body, headers = multipart("p.md", b"progress tracked")
    code, started = await rec.call("upload with progress", "/api/files/upload-with-progress",
                                   "POST", body, headers)
    for _ in range(200):
        if rec.state.uploads[started["task_id"]].status in ("COMPLETED", "FAILED"):
            break
        await asyncio.sleep(0.01)
    await rec.call("progress", f"/api/files/upload-progress/{started['task_id']}")
    await rec.call("progress 404", "/api/files/upload-progress/nope")
    await rec.call("stat after progress", "/api/files")


async def embed_rerank_monitor(rec: Recorder):
    await rec.call("embed", "/api/embedding/embed", "POST", {"texts": ["hello world", "zoka teal"]})
    await rec.call("embed one", "/api/embedding/embed", "POST", {"text": "single"})
    await rec.call("embed missing", "/api/embedding/embed", "POST", {})
    await rec.call("rerank", "/api/reranker/rerank", "POST", {
        "query": "capital of france",
        "documents": ["paris is the capital of france", "bananas", "france wine"], "top_n": 2})
    await rec.call("rerank missing", "/api/reranker/rerank", "POST", {"query": "q"})
    await rec.call("create kbm", "/api/knowledge-bases", "POST", {"name": "kbm"})
    await rec.call("build kbm", "/api/knowledge-bases/kbm/build", "POST", {"documents": documents()})
    await rec.call("query kbm", "/api/knowledge-bases/kbm/query", "POST", {"query": "Zoka"})
    await rec.call("monitor health", "/api/monitor/health")
    await rec.call("monitor metrics", "/api/monitor/metrics")


async def memory(rec: Recorder):
    await rec.call("config", "/api/memory/config")
    await rec.call("enable", "/api/memory/config", "POST", {"memoryEnabled": True})
    await rec.call("health", "/health")
    items = [("User prefers dark mode in every editor", "semantic", 0.9),
             ("Deployed the retrieval service on Tuesday", "episodic", 0.4),
             ("To rotate keys run the vault script first", "procedural", 0.7),
             ("The user likes teal and hiking", "semantic", 0.6),
             ("Working on the quarterly report draft", "working", 0.3)]
    for content, mtype, imp in items:
        await rec.call(f"add {mtype}", "/api/memory/items", "POST",
                       {"content": content, "memory_type": mtype, "importance": imp})
    await rec.call("add empty", "/api/memory/items", "POST", {"content": " "})
    await rec.call("add bad type", "/api/memory/items", "POST", {"content": "x", "memory_type": "dream"})
    await rec.call("list", "/api/memory/items")
    await rec.call("list semantic", "/api/memory/items?types=semantic")
    await rec.call("list page", "/api/memory/items?limit=2&offset=1")
    await rec.call("search", "/api/memory/items?q=dark%20mode%20editor")
    await rec.call("search typed", "/api/memory/items?q=teal&types=semantic,episodic")
    await rec.call("other user", "/api/memory/items?user_id=someone")
    code, listed = await rec.call("list for delete", "/api/memory/items?types=working,episodic")
    ids = sorted(i["id"] for i in listed["items"])
    await rec.call("delete", "/api/memory/items", "DELETE", {"ids": ids})
    await rec.call("delete bad", "/api/memory/items", "DELETE", {"ids": "x"})
    await rec.call("list after delete", "/api/memory/items")
    await rec.call("disable", "/api/memory/config", "POST", {"memoryEnabled": False})


async def trajectories(rec: Recorder):
    await rec.call("build facts", "/api/knowledge-bases/facts/build", "POST",
                   {"documents": documents()})
    agent = await rec.state.get_agent()
    F = rec.pkg.FakeChatClient
    agent.client = F(rule_fn=chat_rule(F))
    await rec.ws("ws", {"query": "What is the color of Zoka?"})
    await rec.call("sse", "/api/chat", "POST", {"query": "launch code of Vexaril"}, kind="sse")
    await rec.call("trajectories", "/api/trajectories?limit=5")


async def spa(rec: Recorder):
    await rec.call("index page", "/", kind="text")
    for path in ("/static/app.js", "/static/style.css", "/static/views/chat.js"):
        await rec.call(path, path, kind="text")
    await rec.call("static 404", "/static/nope.js", kind="text")


async def with_chat_agent(pkg, state):
    await chat_agent(pkg, state)


async def with_qa_agent(pkg, state):
    await chat_agent(pkg, state, kb="qkb")


async def with_trajectory_db(pkg, state):
    state.db = pkg.DBService(url=f"sqlite:///{tempfile.mkdtemp(prefix='yrt-traj-')}/t.db")
    cfg = pkg.AgentConfig()
    cfg.toolkits["kb_search"] = pkg.ToolkitConfig(name="kb_search", config={"kb": "facts"})
    cfg.model.model = "fake"
    state.agent_config = cfg


GROUPS = {
    "health_agents": (health_and_agents, with_chat_agent),
    "chat_sse_ws": (chat, with_chat_agent),
    "kb_lifecycle_query": (kb_lifecycle, with_chat_agent),
    "kb_index": (kb_index, None),
    "kb_qa_pairs_execute": (kb_qa, with_qa_agent),
    "files_ocr": (files, None),
    "embed_rerank_monitor": (embed_rerank_monitor, None),
    "memory": (memory, None),
    "trajectories": (trajectories, with_trajectory_db),
    "spa": (spa, None),
    "kb_tables_config_metadata": (kb_tables_config_metadata, None),
}


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_routes_match_jax(group, jax_lib, port_registry):
    script, setup = GROUPS[group]
    jax_log, port_log = run_both(script, setup)
    assert port_log, "the script recorded nothing"
    assert_same_logs(port_log, jax_log)
