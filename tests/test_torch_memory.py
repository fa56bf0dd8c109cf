"""The port's memory plane (``youtu_rag_tpu_torch/memory``) against the JAX
package's, on the CPU.

Every case of ``tests/memory/test_memory.py`` runs on both packages, with
that file's checks on each side, and the two sides return the same memory
ids, texts and tool outputs, with scores within ``TOL``. Then a seeded
multi-user store (users, types, sessions, importance, ``created_at`` and
categories drawn with numpy) answers every filter shape of the memory
reads the same on both sides, each hit the asking user's; the float
``$gte`` on ``importance`` holds at 0.7 and next to it; importance edits go
through the store's in-place ``update_metadata``.

Both sides draw node and session ids from the same seeded stream (the
modules' ``uuid``) and read one frozen clock (the modules' ``time``), set
before any node is made, so every undated node has age 0; the hash
embedder runs its Python path on both (the C path is 1-2 ulp off it).

Tolerance: ``TOL`` = 1e-4 on scores (the bf16 index: unit vectors, f32
sums in another order), as ``tests/test_torch_kb.py``; tool outputs print
scores with three decimals and must be equal."""

import asyncio
import json
import random
import time
import types
import uuid

import numpy as np
import pytest

import youtu_rag_tpu.memory.store as jax_store_mod
import youtu_rag_tpu.memory.toolkit as jax_toolkit_mod
import youtu_rag_tpu_torch.memory.store as store_mod
import youtu_rag_tpu_torch.memory.toolkit as toolkit_mod
from youtu_rag_tpu.core.config import IndexConfig as JaxIndexConfig
from youtu_rag_tpu.core.config import VectorStoreConfig as JaxVectorStoreConfig
from youtu_rag_tpu.core.types import Chunk as JaxChunk
from youtu_rag_tpu.models.embedder import HashEmbedder as JaxHashEmbedder
from youtu_rag_tpu.retrieval.store import TpuVectorStore
from youtu_rag_tpu_torch.core.config import IndexConfig, VectorStoreConfig
from youtu_rag_tpu_torch.core.types import Chunk
from youtu_rag_tpu_torch.models.embedder import HashEmbedder
from youtu_rag_tpu_torch.retrieval.store import TorchVectorStore
from torch_native_helpers import jax_tracer_restored  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("jax_tracer_restored")

TOL = 1e-4
DAY = 86400.0


class Side:
    """One package's memory plane: its store and toolkit modules, its hash
    embedder, and the keyword that puts a store on the CPU (port only)."""

    def __init__(self, name, store_module, toolkit_module, embedder_cls, device_kw):
        self.name = name
        self.mod = store_module
        self.tk_mod = toolkit_module
        self.embedder_cls = embedder_cls
        self.device_kw = device_kw

    def store(self, dim: int = 128):
        return self.mod.MemoryVectorStore(self.embedder_cls(dim, use_native=False),
                                          **self.device_kw)

    def toolkit(self, **cfg):
        cfg.setdefault("embedder", self.embedder_cls(256, use_native=False))
        return self.tk_mod.VectorMemoryToolkit({**cfg, **self.device_kw})

    def node(self, *args, **kwargs):
        return self.mod.MemoryNode.new(*args, **kwargs)


@pytest.fixture
def sides(monkeypatch):
    """(jax, port), each on a frozen clock and a seeded id stream."""
    now = time.time()
    frozen = types.SimpleNamespace(
        time=lambda: now, strftime=lambda fmt, *_: time.strftime(fmt, time.localtime(now)))
    out = []
    for name, smod, tmod, emb, kw in (
            ("jax", jax_store_mod, jax_toolkit_mod, JaxHashEmbedder, {}),
            ("port", store_mod, toolkit_mod, HashEmbedder, {"device": "cpu"})):
        ids = random.Random(0)
        stream = types.SimpleNamespace(uuid4=lambda ids=ids: uuid.UUID(int=ids.getrandbits(128)))
        for mod in (smod, tmod):
            monkeypatch.setattr(mod, "time", frozen)
            monkeypatch.setattr(mod, "uuid", stream)
        out.append(Side(name, smod, tmod, emb, kw))
    return out[0], out[1], now


def hits(pairs):
    """(id, type, user, content, score) of search_memories' (node, score)."""
    return [(m.id, m.memory_type, m.user_id, m.content, float(s)) for m, s in pairs]


def assert_same(got, want, where="result"):
    """Equal structures; floats within TOL."""
    if isinstance(want, float):
        assert isinstance(got, float) and abs(got - want) <= TOL, (where, got, want)
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (where, got, want)
        for k in want:
            assert_same(got[k], want[k], f"{where}[{k!r}]")
    else:
        assert got == want, (where, got, want)


# ---------------------------------------------------------------------------
# the cases of tests/memory/test_memory.py, each run on one side
# ---------------------------------------------------------------------------


async def case_add_and_search_by_type(side, now, tmp):
    s = side.store()
    await s.add(side.node("u1", "semantic", "the database password policy requires rotation"))
    await s.add(side.node("u1", "episodic", "yesterday we discussed kubernetes deployments"))
    await s.add(side.node("u2", "semantic", "other user's fact about databases"))
    found = await s.search_memories("u1", "database policy", memory_types=["semantic"])
    assert found
    assert found[0][0].user_id == "u1"
    assert found[0][0].memory_type == "semantic"
    assert "password policy" in found[0][0].content
    return hits(found)


async def case_importance_and_recency_weighting(side, now, tmp):
    s = side.store()
    old = side.node("u", "semantic", "shared topic alpha beta gamma", importance=0.1)
    old.created_at = now - 30 * DAY
    new = side.node("u", "semantic", "shared topic alpha beta gamma!", importance=0.9)
    await s.add(old)
    await s.add(new)
    found = await s.search_memories("u", "shared topic alpha beta gamma")
    assert found[0][0].importance == 0.9  # fresher + more important wins
    return hits(found)


async def case_working_memory_session_scoped(side, now, tmp):
    s = side.store()
    for i in range(5):
        n = side.node("u", "working", f"turn {i}", session_id="s1")
        n.created_at = now + i
        await s.add(n)
    await s.add(side.node("u", "working", "other session", session_id="s2"))
    wm = await s.get_working_memory("u", "s1", last_n=3)
    assert [m.content for m in wm] == ["turn 2", "turn 3", "turn 4"]
    return [(m.id, m.content) for m in wm]


async def case_procedural_cleanup(side, now, tmp):
    s = side.store()
    bad = side.node("u", "procedural", "bad skill")
    bad.use_count, bad.success_count = 5, 0
    good = side.node("u", "procedural", "good skill")
    good.use_count, good.success_count = 5, 5
    await s.add(bad)
    await s.add(good)
    removed = await s.cleanup_procedural("u")
    stats = s.stats("u")
    assert removed == 1
    assert stats["procedural"] == 1
    left = await s.search_memories("u", "skill", memory_types=["procedural"])
    assert [m.id for m, _ in left] == [good.id]
    return removed, stats, hits(left)


async def case_toolkit_roundtrip_and_context(side, now, tmp):
    tk = side.toolkit(user_id="u9")
    outs = [await tk.add_memory("user prefers bf16 precision for embeddings", "semantic", 0.8),
            await tk.store_skill("search-then-rerank", "For precise retrieval tasks",
                                 ["kb_embedding_search", "kb_rerank"])]
    await tk.store_conversation("what precision?", "bf16 as you prefer")
    ctx = await tk.retrieve_all_context("which precision should embeddings use?")
    stats = await tk.memory_stats()
    assert "bf16" in ctx
    assert "Recent context" in ctx
    st = json.loads(stats)
    assert st["semantic"] == 1 and st["working"] == 1 and st["episodic"] == 1
    return outs, ctx, stats, list(tk._pending_skill_ids), tk.session_id


async def case_skill_extraction_heuristic(side, now, tmp):
    tk = side.toolkit(user_id="u")
    record = {
        "input": "find the latest sales report",
        "tool_calls": [
            {"name": "kb_file_search", "arguments": "{}"},
            {"name": "kb_embedding_search", "arguments": "{}"},
        ],
    }
    out = await tk.extract_skill_from_trajectory(record)
    skills = await tk.search_skills("find a report")
    assert out is not None
    assert "kb_file_search" in skills
    return out, skills


async def case_update_memory_reembeds(side, now, tmp):
    tk = side.toolkit(user_id="u-upd")
    msg = await tk.add_memory("the capital of France is Paris", "semantic", 0.5)
    mid = msg.split()[-1]
    before = await tk.search_memory("volcano eruptions in Iceland", ["semantic"])
    await tk.update_memory(mid, content="Iceland volcano eruptions happen near Grindavik")
    after = await tk.search_memory("volcano eruptions in Iceland", ["semantic"])
    node = tk.store.get(mid)
    assert "Grindavik" in after and "Grindavik" in node.content
    # only one live memory (same id reinserted, old row tombstoned)
    assert tk.store.stats("u-upd")["semantic"] == 1
    assert await tk.store.store.count() == 1
    return msg, before, after


async def case_skill_outcome_loop_gates_failing_skills(side, now, tmp):
    tk = side.toolkit(user_id="u-skill")
    await tk.store_skill("bad-idea", "For any retrieval task", ["wrong_tool"])
    ctxs, counts = [], []
    for _ in range(4):
        ctx = await tk.retrieve_all_context("a retrieval task")
        assert "bad-idea" in ctx or not tk._pending_skill_ids  # surfaced at least once
        ctxs.append(ctx)
        counts.append(await tk.record_skill_outcomes(success=False))
    node = next(m for m in tk.store._nodes.values() if m.memory_type == "procedural")
    ctx_after = await tk.retrieve_all_context("a retrieval task")
    assert node.use_count >= 3 and node.success_count == 0
    assert "Applicable skills" not in ctx_after
    return ctxs, counts, ctx_after, (node.id, node.use_count, node.success_count)


async def case_memory_persistence_roundtrip(side, now, tmp):
    path = str(tmp / f"{side.name}-mem.json")
    tk = side.toolkit(user_id="u-p", persist_path=path)
    await tk.store_skill("roundtrip", "testing persistence", ["step1"])
    await tk.retrieve_all_context("testing persistence task")
    await tk.record_skill_outcomes(success=True)
    tk2 = side.toolkit(user_id="u-p")
    n = await tk2.store.load(path)
    skills = await tk2.search_skills("persistence")
    assert n >= 1
    assert "roundtrip" in skills and "100%" in skills  # usage stats survived
    saved = json.loads((tmp / f"{side.name}-mem.json").read_text())
    for item in saved:  # the wall clock at creation, not the frozen one
        assert item.pop("created_at") >= now
    return n, skills, saved


async def case_schema_and_sql_pattern_memories(side, now, tmp):
    tk = side.toolkit(user_id="u-sql")
    outs = [await tk.store_schema_knowledge(
        "orders",
        ["id: INTEGER", "user_id: INTEGER (FK users.id)", "total: REAL"],
        description="customer orders",
        relationships=["orders.user_id -> users.id"],
    ), await tk.store_sql_pattern(
        "monthly-rollup",
        "SELECT strftime('%Y-%m', date) m, SUM(total) FROM orders GROUP BY m",
        "Aggregate order totals by month",
        examples=["monthly revenue"],
    )]
    schema = await tk.search_schema_knowledge("how do orders join users?")
    patterns = await tk.search_sql_patterns("revenue by month")
    # category partitions don't leak into each other
    only_schema = await tk.search_sql_patterns("orders join users table schema")
    assert "orders.user_id -> users.id" in schema
    assert "monthly-rollup" in patterns
    assert "Relationships" not in only_schema
    return outs, schema, patterns, only_schema


CASES = [case_add_and_search_by_type, case_importance_and_recency_weighting,
         case_working_memory_session_scoped, case_procedural_cleanup,
         case_toolkit_roundtrip_and_context, case_skill_extraction_heuristic,
         case_update_memory_reembeds, case_skill_outcome_loop_gates_failing_skills,
         case_memory_persistence_roundtrip, case_schema_and_sql_pattern_memories]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_memory_case_matches_jax(sides, case, tmp_path):
    jax_side, port_side, now = sides
    want = asyncio.run(case(jax_side, now, tmp_path))
    got = asyncio.run(case(port_side, now, tmp_path))
    assert_same(got, want)


# ---------------------------------------------------------------------------
# a seeded multi-user store: every filter shape of the memory reads
# ---------------------------------------------------------------------------

WORDS = ("alpha bravo charlie delta echo foxtrot golf hotel india juliet kilo lima mike "
         "november oscar papa quebec romeo sierra tango uniform victor whiskey xray").split()
N_USERS = 6
CATEGORIES = (None, "schema", "sql_pattern")


def seeded_nodes(side, now, seed: int = 0):
    """Each user: 4 working memories over 2 sessions, 6 episodic, 6
    semantic (a third with a text2sql category), 4 procedural with use and
    success counts; importance on a 0.05 grid (0.7 among them) and
    created_at over the 30 days before ``now``, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    nodes = []
    for u in range(N_USERS):
        plan = [("working", 4), ("episodic", 6), ("semantic", 6), ("procedural", 4)]
        for mtype, n in plan:
            for i in range(n):
                text = " ".join(rng.choice(WORDS, size=int(rng.integers(4, 10))))
                meta = {}
                if mtype == "semantic" and CATEGORIES[i % 3]:
                    meta["category"] = CATEGORIES[i % 3]
                node = side.mod.MemoryNode(
                    id=f"m-u{u}-{mtype}-{i}", user_id=f"user-{u}", memory_type=mtype,
                    content=f"{mtype} note {i} of user {u}: {text}",
                    importance=round(float(rng.integers(0, 21)) * 0.05, 2),
                    created_at=now - float(rng.uniform(0, 30 * DAY)),
                    session_id=f"s{i % 2}" if mtype == "working" else "",
                    metadata=meta)
                if mtype == "procedural":
                    node.use_count = int(rng.integers(0, 6))
                    node.success_count = int(rng.integers(0, node.use_count + 1))
                nodes.append(node)
    return nodes


READS = [
    ("default", {}),
    ("types", {"memory_types": ["semantic", "procedural"], "top_k": 4}),
    ("min_importance", {"min_importance": 0.7, "top_k": 8}),
    ("category", {"memory_types": ["semantic"], "category": "sql_pattern", "top_k": 3}),
    ("skills", {"memory_types": ["procedural"], "min_success_rate": 0.3, "top_k": 3}),
    ("working", {"memory_types": ["working"], "top_k": 3}),
]


async def seeded_reads(side, now):
    s = side.store(dim=256)
    nodes = seeded_nodes(side, now)
    for node in nodes:
        await s.add(node)
    rng = np.random.default_rng(1)
    out = {}
    for u in range(N_USERS):
        query = " ".join(rng.choice(WORDS, size=4))
        for name, kw in READS:
            found = await s.search_memories(f"user-{u}", query, **kw)
            types_ = kw.get("memory_types") or ["episodic", "semantic", "procedural"]
            for m, _ in found:  # tenant isolation and the asked partitions
                assert m.user_id == f"user-{u}" and m.memory_type in types_
                assert m.importance >= kw.get("min_importance", 0.0)
                if "category" in kw:
                    assert m.metadata.get("category") == kw["category"]
            out[f"user-{u}/{name}"] = hits(found)
        tk = side.toolkit(user_id=f"user-{u}", session_id="s1", store=s)
        out[f"user-{u}/context"] = await tk.retrieve_all_context(query, max_items=8)
        out[f"user-{u}/working"] = [m.id for m in await s.get_working_memory(f"user-{u}", "s1")]
    return out


def test_seeded_multi_user_reads_match_jax(sides):
    jax_side, port_side, now = sides
    want = asyncio.run(seeded_reads(jax_side, now))
    got = asyncio.run(seeded_reads(port_side, now))
    assert_same(got, want)
    assert any(len(v) for k, v in want.items() if k.endswith("/min_importance"))
    assert any(len(v) for k, v in want.items() if k.endswith("/category"))


async def importance_edits(side, now):
    """update() of importance alone is a metadata edit in place: it moves
    nodes across the $gte line of min_importance, keeps the row count, and
    a content edit re-embeds under the same id."""
    s = side.store()
    for i, imp in enumerate((0.69, 0.7, 0.71, 0.5)):
        await s.add(side.mod.MemoryNode(id=f"n{i}", user_id="u", memory_type="semantic",
                                        content=f"the policy fact number {i}", importance=imp,
                                        created_at=now - i * DAY))
    rows = await s.store.count()
    out = [hits(await s.search_memories("u", "policy fact", min_importance=0.7))]
    assert await s.update("n0", importance=0.7) and await s.update("n1", importance=0.6999)
    assert await s.update("n3", importance=1.5)  # clamped to 1.0
    assert await s.store.count() == rows  # no re-insert
    out.append(hits(await s.search_memories("u", "policy fact", min_importance=0.7)))
    assert {h[0] for h in out[-1]} == {"n0", "n2", "n3"}
    assert await s.update("n2", content="grindavik volcano eruptions")
    assert await s.store.count() == rows
    out.append(hits(await s.search_memories("u", "volcano eruptions", min_importance=0.7)))
    assert out[-1][0][0] == "n2"
    assert not await s.update("missing", importance=0.9)
    return out


def test_update_moves_importance_across_gte_as_jax(sides):
    jax_side, port_side, now = sides
    assert_same(asyncio.run(importance_edits(port_side, now)),
                asyncio.run(importance_edits(jax_side, now)))


# float $gte on the store's metadata at 0.7 and next to it: the encoding of
# float columns is the ordered int32 one on both sides
EDGE = [0.7, 0.7 - 1e-9, 0.7 + 1e-9, float(np.nextafter(np.float32(0.7), np.float32(0))),
        float(np.nextafter(np.float32(0.7), np.float32(1))), 0.69, 0.71, 0.0, 1.0, -0.7]


async def store_gte_edges(store, chunk_cls):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((len(EDGE), 32)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    await store.add_chunks([
        chunk_cls(id=f"c{i}", document_id="d", content=f"c{i}", chunk_index=i,
                  metadata={"importance": v, "user_id": "u"}, embedding=x[i].tolist())
        for i, v in enumerate(EDGE)])
    q = x.mean(0).tolist()
    out = []
    for bound in (0.7, float(np.float32(0.7)), 0.7 + 1e-9, 0.0):
        for op in ("$gte", "$gt", "$lte", "$lt"):
            got = await store.search(q, top_k=len(EDGE), filters={"importance": {op: bound}})
            out.append([(c.id, float(s)) for c, s in got])
    # move rows across the line in place: no re-embed, the same row count
    n = await store.update_metadata(["c5", "c0", "missing"],
                                    [{"importance": 0.7, "user_id": "u"},
                                     {"importance": 0.6999999, "user_id": "u"}, {}])
    out.append(n)
    got = await store.search(q, top_k=len(EDGE), filters={"importance": {"$gte": 0.7}})
    out.append([(c.id, float(s)) for c, s in got])
    out.append(await store.count())
    return out


def test_store_update_metadata_and_float_gte_match_jax():
    def cfg(vs_cls, idx_cls):
        return vs_cls(index=idx_cls(min_capacity=64, block_rows=16, max_metadata_columns=8))

    port = TorchVectorStore(cfg(VectorStoreConfig, IndexConfig), device="cpu")
    jax = TpuVectorStore(cfg(JaxVectorStoreConfig, JaxIndexConfig))
    got = asyncio.run(store_gte_edges(port, Chunk))
    want = asyncio.run(store_gte_edges(jax, JaxChunk))
    assert_same(got, want)
    assert got[-3] == 2 and got[-1] == len(EDGE)
    assert "c5" in [i for i, _ in got[-2]] and "c0" not in [i for i, _ in got[-2]]
    assert asyncio.run(TorchVectorStore(device="cpu").update_metadata(["x"], [{}])) == 0


def test_memory_store_defaults_match_jax():
    port = store_mod.MemoryVectorStore(HashEmbedder(64), device="cpu")
    jax = jax_store_mod.MemoryVectorStore(JaxHashEmbedder(64))
    # the one field that differs names the engine: "torch" against "tpu"
    assert ({**port.store.config.model_dump(), "backend": "tpu"}
            == jax.store.config.model_dump())
    assert port.store.device.type == "cpu"
    assert store_mod.MEMORY_TYPES == jax_store_mod.MEMORY_TYPES
    tk = toolkit_mod.VectorMemoryToolkit({"device": "cpu"})
    jtk = jax_toolkit_mod.VectorMemoryToolkit({})
    assert tk.get_tools_in_openai() == jtk.get_tools_in_openai()
    assert tk.store.embedder.dimension == jtk.store.embedder.dimension == 256
    assert tk.store.embedder._use_native and tk.user_id == jtk.user_id == "default"
