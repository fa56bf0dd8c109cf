"""The port's staged ingest path against the JAX package's, on the CPU.

``KnowledgeBase.build_sources`` (the ingest agent, its text, table,
database and QA processors, the table store and the incremental manifest)
runs on the same sources in both packages, with the same hash-embedder
path on both sides (each test says which: the C kernel, bit-equal between
the packages, or the Python path). Reports, chunk ids, contents, metadata,
stored embeddings (bit for bit), manifests, tables and schemas are equal;
so are incremental skips, per-source failures, progress callbacks and
cleanup. The host-only helpers (metadata extraction, HiChunk, OCR, QA
files, the table store) answer as the JAX package's, the remote clients on
one mock HTTP transport."""

import asyncio
import base64
import json
import sqlite3

import httpx
import numpy as np
import pandas as pd
import pytest

import youtu_rag_tpu.ingest.hichunk as jax_hichunk
import youtu_rag_tpu.ingest.metadata_extractor as jax_meta
import youtu_rag_tpu.ingest.ocr as jax_ocr
import youtu_rag_tpu.ingest.qa_file as jax_qa
import youtu_rag_tpu.ingest.tables as jax_tables
import youtu_rag_tpu_torch.ingest.hichunk as hichunk
import youtu_rag_tpu_torch.ingest.metadata_extractor as meta
import youtu_rag_tpu_torch.ingest.ocr as ocr
import youtu_rag_tpu_torch.ingest.qa_file as qa
import youtu_rag_tpu_torch.ingest.tables as tables
from youtu_rag_tpu.core.config import ChunkingConfig as JaxChunkingConfig
from youtu_rag_tpu.core.config import IndexConfig as JaxIndexConfig
from youtu_rag_tpu.core.config import KnowledgeBuilderConfig as JaxKBConfig
from youtu_rag_tpu.core.config import RAGConfig as JaxRAGConfig
from youtu_rag_tpu.core.config import VectorStoreConfig as JaxVectorStoreConfig
from youtu_rag_tpu.core.types import Document as JaxDocument
from youtu_rag_tpu.ingest.agent import BuildRequest as JaxBuildRequest
from youtu_rag_tpu.ingest.agent import KnowledgeBuilderAgent as JaxAgent
from youtu_rag_tpu.ingest.cleanup import KnowledgeCleanupManager as JaxCleanup
from youtu_rag_tpu.ingest.processors import SourceTask as JaxSourceTask
from youtu_rag_tpu.models.embedder import HashEmbedder as JaxHashEmbedder
from youtu_rag_tpu.retrieval.kb import KnowledgeBase as JaxKB
from youtu_rag_tpu.retrieval.store import TpuVectorStore
from youtu_rag_tpu_torch.core.config import (
    ChunkingConfig,
    IndexConfig,
    KnowledgeBuilderConfig,
    RAGConfig,
    VectorStoreConfig,
)
from youtu_rag_tpu_torch.core.types import Document
from youtu_rag_tpu_torch.ingest import __all__ as ingest_exports
from youtu_rag_tpu_torch.ingest.agent import BuildRequest, KnowledgeBuilderAgent
from youtu_rag_tpu_torch.ingest.cleanup import KnowledgeCleanupManager
from youtu_rag_tpu_torch.ingest.processors import SourceTask
from youtu_rag_tpu_torch.models.embedder import HashEmbedder
from youtu_rag_tpu_torch.retrieval.kb import KnowledgeBase
from youtu_rag_tpu_torch.retrieval.store import TorchVectorStore
from torch_native_helpers import jax_lib  # noqa: F401 - a fixture

# stored rows are compared bit for bit, and make_kbs(True) names the C hash
# path on both sides: hold the JAX package to its C path whatever the race
# for its shared build cache did
pytestmark = pytest.mark.usefixtures("jax_lib")

WORDS = ("alpha beta gamma delta epsilon zeta eta theta iota kappa lambda mu nu xi "
         "omicron pi rho sigma tau upsilon phi chi psi omega").split()
PORT = {"SourceTask": SourceTask, "Document": Document}
JAX = {"SourceTask": JaxSourceTask, "Document": JaxDocument}


def prose(rng, n_words: int, fact: str = "") -> str:
    words = rng.choice(WORDS, size=n_words)
    sentences = [" ".join(words[i:i + 12]).capitalize() + "." for i in range(0, n_words, 12)]
    sentences.insert(len(sentences) // 2, fact)
    return " ".join(s for s in sentences if s)


@pytest.fixture
def sources(tmp_path):
    """Files of every kind the staged builder routes, written from a seed."""
    rng = np.random.default_rng(0)
    (tmp_path / "notes.md").write_text(
        "# Notes\n\n" + prose(rng, 600, "The launch code of Vexaril is 4821.") + "\n\n## More\n\n"
        + prose(rng, 300))
    (tmp_path / "guide.txt").write_text(prose(rng, 400, "Tomato seedlings want full sun."))
    pd.DataFrame({
        "city": ["paris", "london", "berlin", "rome", "madrid", "vienna"],
        "country": ["france", "uk", "germany", "italy", "spain", "austria"],
        "population_m": [2.1, 8.8, 3.6, 2.8, 3.2, 1.9],
    }).to_csv(tmp_path / "cities.csv", index=False)
    pd.DataFrame({"item": ["pen", "ink"], "qty": [3, 4]}).to_csv(tmp_path / "small.csv", index=False)
    conn = sqlite3.connect(tmp_path / "shop.sqlite")
    conn.execute("CREATE TABLE orders (id INTEGER, customer TEXT, total REAL)")
    conn.executemany("INSERT INTO orders VALUES (?, ?, ?)",
                     [(i, ["ann", "bob", "cy"][i % 3], i * 1.5) for i in range(12)])
    conn.execute("CREATE TABLE items (sku TEXT, name TEXT)")
    conn.executemany("INSERT INTO items VALUES (?, ?)", [("a1", "widget"), ("b2", "gadget")])
    conn.commit()
    conn.close()
    return tmp_path


QA_PAIRS = [
    {"question": "What is the launch code of Vexaril?", "answer": "4821", "related_file": "notes.md"},
    {"question": "", "answer": "skipped: no question"},
    {"question": "Which city is in austria?", "answer": "vienna"},
]


def tasks(pkg: dict, root) -> list:
    ST, Doc = pkg["SourceTask"], pkg["Document"]
    return [
        ST("notes.md", "text", path=str(root / "notes.md"), metadata={"topic": "codes"}),
        ST("guide.txt", "text", path=str(root / "guide.txt")),
        ST("inline", "text", document=Doc("inline", "# Inline\nAn inline document. " * 40)),
        ST("cities.csv", "table", path=str(root / "cities.csv")),
        ST("small.csv", "text", path=str(root / "small.csv")),
        ST("shop.sqlite", "text", path=str(root / "shop.sqlite")),
        ST("faq", "qa", qa_pairs=[dict(p) for p in QA_PAIRS]),
    ]


def configs(name: str, chunk_size: int = 300):
    chunking = dict(chunk_size=chunk_size, chunk_overlap=30)
    index = dict(min_capacity=256, block_rows=128)
    port = RAGConfig(name=name, vector_store=VectorStoreConfig(index=IndexConfig(**index)))
    port.knowledge_builder.chunking = ChunkingConfig(**chunking)
    jax_ = JaxRAGConfig(name=name, vector_store=JaxVectorStoreConfig(index=JaxIndexConfig(**index)))
    jax_.knowledge_builder.chunking = JaxChunkingConfig(**chunking)
    return port, jax_


def make_kbs(use_native: bool, name: str = "kb"):
    """A port KB on the CPU and a JAX KB, their hash embedders on one path."""
    port_cfg, jax_cfg = configs(name)
    port, jax_kb = KnowledgeBase(name, port_cfg, device="cpu"), JaxKB(name, jax_cfg)
    port.embedder._use_native = jax_kb.embedder._use_native = use_native
    return port, jax_kb


def build(kb, task_list, **kw):
    return asyncio.run(kb.build_sources(task_list, **kw))


def summary(report) -> dict:
    out = report.summary()
    out.pop("duration_s")
    return out


def stored(index) -> dict:
    """chunk id → (document, content, chunk_index, metadata, stored vector as f32)."""
    out = {}
    for c in index.iter_live():
        row = index._id_to_row[c.id]
        vec = index._vectors[row]
        vec = vec.float().numpy() if hasattr(vec, "float") else np.asarray(vec, np.float32)
        out[c.id] = (c.document_id, c.content, c.chunk_index, c.metadata, vec[: index.dim])
    return out


def assert_same_store(port_store, jax_store):
    got, want = stored(port_store._index), stored(jax_store._index)
    assert got.keys() == want.keys()
    for cid, (doc, content, ci, md, vec) in got.items():
        assert (doc, content, ci, md) == want[cid][:4], cid
        np.testing.assert_array_equal(vec, want[cid][4], err_msg=cid)
    for query in ("launch code Vexaril", "city austria", "orders customer total"):
        hits = asyncio.run(port_store.lexical_search_bundle(query, top_k=5))[0]
        ref = asyncio.run(jax_store.lexical_search_bundle(query, top_k=5))[0]
        assert [(c.id, s) for c, s in hits] == [(c.id, s) for c, s in ref]


def table_dump(store, kb: str) -> list:
    out = []
    for row in sorted(store.tables_for_kb(kb), key=lambda r: r["table_name"]):
        name = row["table_name"]
        out.append((row, store.get_schema(name), store.execute_sql(f'SELECT * FROM "{name}"')))
    return out


def assert_same_kb(port, jax_kb):
    assert_same_store(port.store, jax_kb.store)
    assert {s: vars(r) for s, r in port.manifest.sources.items()} == \
        {s: vars(r) for s, r in jax_kb.manifest.sources.items()}
    assert table_dump(port.tables, port.name) == table_dump(jax_kb.tables, jax_kb.name)


def plans(report) -> list:
    return report.analysis["plans"]


# ---------------------------------------------------------------------------
# build_sources
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_build_sources_matches_jax(sources, use_native):
    port, jax_kb = make_kbs(use_native)
    got, want = build(port, tasks(PORT, sources)), build(jax_kb, tasks(JAX, sources))
    assert summary(got) == summary(want)
    assert got.processed == 7 and got.failed == 0 and got.total_chunks > 20
    assert sorted(got.tables) == ["cities_Sheet1", "items", "orders"]
    assert [vars(r) for r in got.results] == [vars(r) for r in want.results]
    assert plans(got) == plans(want)
    state, want_state = got.analysis["storage_state"], want.analysis["storage_state"]
    assert state["vector_store"].pop("backend") == "torch_device_index"
    want_state["vector_store"].pop("backend")
    assert state == want_state
    assert_same_kb(port, jax_kb)
    assert asyncio.run(port.store.count()) == asyncio.run(jax_kb.store.count()) == got.total_chunks
    for doc in ("notes.md", "cities.csv", "shop.sqlite", "faq", "nowhere"):
        assert asyncio.run(port.store.count_by_document(doc)) == \
            asyncio.run(jax_kb.store.count_by_document(doc))
    # the QA source's question vectors answer with their payload
    for kb in (port, jax_kb):
        hits = asyncio.run(kb.search(QA_PAIRS[0]["question"], top_k=1))
        assert hits[0].chunk.metadata["answer"] == "4821"


def test_hash_provider_defaults_to_native(sources):
    kb = KnowledgeBase("kb", configs("kb")[0], device="cpu")
    assert isinstance(kb.embedder, HashEmbedder) and kb.embedder._use_native
    assert kb.builder_agent.ctx.embedder is kb.embedder


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_incremental_skip_and_change(sources, use_native):
    port, jax_kb = make_kbs(use_native)
    for kb, pkg in ((port, PORT), (jax_kb, JAX)):
        build(kb, tasks(pkg, sources))
    # unchanged: every source skipped, nothing re-added
    rows_before = port.store.index.size
    got, want = build(port, tasks(PORT, sources)), build(jax_kb, tasks(JAX, sources))
    assert summary(got) == summary(want) and got.skipped == 7 and got.processed == 0
    assert port.store.index.size == rows_before
    assert {p["reason"] for p in plans(got)} == {"up_to_date"}
    # a changed file, changed metadata and a changed inline document
    (sources / "guide.txt").write_text("Rewritten guide. " * 90)
    t_port, t_jax = tasks(PORT, sources), tasks(JAX, sources)
    for t, Doc in ((t_port, Document), (t_jax, JaxDocument)):
        t[0].metadata = {"topic": "changed"}
        t[2].document = Doc("inline", "# Inline\nA second version. " * 30)
    got, want = build(port, t_port), build(jax_kb, t_jax)
    assert summary(got) == summary(want) and got.processed == 3 and got.skipped == 4
    assert plans(got) == plans(want)
    assert {p["source_id"]: p["reason"] for p in plans(got) if p["action"] != "skip"} == {
        "notes.md": "metadata_changed", "guide.txt": "content_changed", "inline": "content_changed"}
    assert_same_kb(port, jax_kb)
    # rebuild=True processes everything again
    got, want = build(port, t_port, rebuild=True), build(jax_kb, t_jax, rebuild=True)
    assert summary(got) == summary(want) and got.processed == 7
    assert_same_kb(port, jax_kb)


def test_storage_divergence_reprocesses_like_jax(sources):
    port, jax_kb = make_kbs(True)
    for kb, pkg in ((port, PORT), (jax_kb, JAX)):
        build(kb, tasks(pkg, sources))
        asyncio.run(kb.store.clear())
    got, want = build(port, tasks(PORT, sources)), build(jax_kb, tasks(JAX, sources))
    assert plans(got) == plans(want)
    assert {p["reason"] for p in plans(got)} == {"storage_divergence"}
    assert summary(got) == summary(want) and got.processed == 7
    assert_same_kb(port, jax_kb)


def test_per_source_error_isolation(sources):
    (sources / "broken.sqlite").write_text("not a database")
    port, jax_kb = make_kbs(True)
    extra = [("missing.md", "text", "missing.md"), ("bad.xlsx", "table", "missing.xlsx"),
             ("broken.sqlite", "text", "broken.sqlite")]
    got = build(port, tasks(PORT, sources) + [SourceTask(s, k, path=str(sources / p))
                                              for s, k, p in extra])
    want = build(jax_kb, tasks(JAX, sources) + [JaxSourceTask(s, k, path=str(sources / p))
                                                for s, k, p in extra])
    assert summary(got) == summary(want)
    assert got.processed == 7 and got.failed == 3
    assert [vars(r) for r in got.results] == [vars(r) for r in want.results]
    assert_same_kb(port, jax_kb)
    assert set(port.manifest.sources) == {t.source_id for t in tasks(PORT, sources)}


def test_progress_callbacks_in_jax_order(sources):
    port, jax_kb = make_kbs(True)
    events = {"port": [], "jax": []}
    for _ in range(2):  # a first build, then one that skips everything
        for kb, pkg, key in ((port, PORT, "port"), (jax_kb, JAX, "jax")):
            build(kb, tasks(pkg, sources), on_progress=lambda *e, k=key: events[k].append(e))
    assert events["port"] == events["jax"]
    statuses = [e[1] for e in events["port"]]
    assert statuses.count("running") == statuses.count("completed") == statuses.count("skipped") == 7
    assert events["port"][-1][2:] == (7, 7)
    assert port.builder_agent.on_progress is None


def test_cleanup_source_and_kb_like_jax(sources):
    port, jax_kb = make_kbs(True)
    managers = []
    for kb, pkg, Manager in ((port, PORT, KnowledgeCleanupManager), (jax_kb, JAX, JaxCleanup)):
        build(kb, tasks(pkg, sources))
        managers.append(Manager(kb.name, kb.store, kb.tables, kb.manifest))
    mine, theirs = managers

    def both(fn):
        got, want = asyncio.run(fn(mine)), asyncio.run(fn(theirs))
        assert got == want
        assert_same_kb(port, jax_kb)
        return got

    got = both(lambda m: m.cleanup_source("cities.csv"))
    assert got["deleted_chunks"] > 0 and got["dropped_tables"] == ["cities_Sheet1"]
    assert asyncio.run(port.store.count_by_document("cities.csv")) == 0
    assert "cities.csv" not in port.manifest.sources
    # a path-style source id cleans its basename's chunks too
    got = both(lambda m: m.cleanup_source(str(sources / "notes.md")))
    assert got["deleted_chunks"] > 0
    got = both(lambda m: m.cleanup_removed_sources(["guide.txt", "faq"],
                                                   keep=lambda s: s == "inline"))
    assert [r["source"] for r in got] == ["shop.sqlite", "small.csv"]
    got = both(lambda m: m.cleanup_knowledge_base())
    assert got["deleted_chunks"] > 0 and not port.manifest.sources
    assert asyncio.run(port.store.count()) == 0 and port.tables.tables_for_kb("kb") == []


def test_persisted_state_like_jax(sources, tmp_path_factory):
    """attach_persistence: sqlite tables and a manifest on disk, which a
    fresh KB over the same directory reads back (the JAX package's files
    read by the port too)."""
    dirs = {k: tmp_path_factory.mktemp(k) for k in ("port", "jax")}
    port, jax_kb = make_kbs(True)
    port.attach_persistence(dirs["port"])
    jax_kb.attach_persistence(dirs["jax"])
    build(port, tasks(PORT, sources))
    build(jax_kb, tasks(JAX, sources))
    assert json.loads((dirs["port"] / "manifest.json").read_text()) == \
        json.loads((dirs["jax"] / "manifest.json").read_text())
    assert (dirs["port"] / "tables.sqlite").exists()
    for d in dirs.values():
        fresh = KnowledgeBase("kb", configs("kb")[0], device="cpu")
        fresh.attach_persistence(d)
        assert {s: vars(r) for s, r in fresh.manifest.sources.items()} == \
            {s: vars(r) for s, r in port.manifest.sources.items()}
        assert table_dump(fresh.tables, "kb") == table_dump(port.tables, "kb")
        # the vectors live in the KB's own store: an empty one reprocesses
        report = build(fresh, tasks(PORT, sources))
        assert {p["reason"] for p in plans(report)} == {"storage_divergence"}
    (dirs["port"] / "manifest.json").write_text("{not json")
    fresh = KnowledgeBase("kb", configs("kb")[0], device="cpu")
    fresh.attach_persistence(dirs["port"])
    assert fresh.manifest.sources == {}  # a corrupt manifest means a full rebuild


def test_agent_with_its_own_store_like_jax(tmp_path):
    """The builder agent over a store of its own (no KnowledgeBase), and a
    sheet past the full-text and row-document caps."""
    n = 20_000
    pd.DataFrame({"id": np.arange(n), "name": [f"item-{i}" for i in range(n)],
                  "value": np.random.default_rng(0).normal(size=n)}).to_csv(tmp_path / "big.csv",
                                                                          index=False)
    pd.DataFrame({"k": ["a", "b"]}).to_csv(tmp_path / "narrow.csv", index=False)
    kw = dict(max_fulltext_rows=200, max_row_docs=50)
    idx = dict(min_capacity=256, block_rows=128)
    port = KnowledgeBuilderAgent(
        "big", TorchVectorStore(VectorStoreConfig(index=IndexConfig(**idx)), device="cpu"),
        HashEmbedder(64), config=KnowledgeBuilderConfig(
            chunking=ChunkingConfig(chunk_size=800, chunk_overlap=0), **kw))
    jax_agent = JaxAgent(
        "big", TpuVectorStore(JaxVectorStoreConfig(index=JaxIndexConfig(**idx))),
        JaxHashEmbedder(64), config=JaxKBConfig(
            chunking=JaxChunkingConfig(chunk_size=800, chunk_overlap=0), **kw))
    names = ("big.csv", "narrow.csv")
    got = asyncio.run(port.build(BuildRequest(
        "big", [SourceTask(s, "table", path=str(tmp_path / s)) for s in names])))
    want = asyncio.run(jax_agent.build(JaxBuildRequest(
        "big", [JaxSourceTask(s, "table", path=str(tmp_path / s)) for s in names])))
    assert summary(got) == summary(want) and got.processed == 2 and got.total_chunks < 400
    assert_same_store(port.ctx.store, jax_agent.ctx.store)
    assert port.tables.execute_sql('SELECT COUNT(*) FROM "big_Sheet1"')["rows"] == [[n]]


def test_ingest_exports_match_jax():
    import youtu_rag_tpu.ingest as jax_ingest

    assert sorted(ingest_exports) == sorted(jax_ingest.__all__)


# ---------------------------------------------------------------------------
# the host-only helpers
# ---------------------------------------------------------------------------

META_CASES = [
    ("report_2023-05-10.md",
     "Quarterly Report\nAuthor: Jane Smith\nPublished 2023-05-10 covering 2023-01-01 onwards."),
    ("notes.md", "\n\n  First line here\nby John Doe in 2019/07 and 2020/02."),
    ("年报.md", "作者：张三丰\n发布于2021年3月15日，覆盖2020年全年。"),
    ("bad_2023-02-30.md", "No valid full date here, only 1999."),
    ("empty.md", ""),
    ("x.md", "Dates 2099-12-31 and 1899-01-01 and 2150-01-01."),
]
DATES = ["2023-05-10", "2023/05/10", "2023-05", "2023", " 2023 ", "not a date", "2523-01-01",
         "1899-12-31", None, "", "2023-13-01", "2024-02-29", "2023-02-29"]


def test_metadata_extractor_matches_jax():
    assert [meta.validate_date(d) for d in DATES] == [jax_meta.validate_date(d) for d in DATES]
    for name, text in META_CASES:
        got = asyncio.run(meta.MetadataExtractor().extract_metadata(name, text))
        assert got == asyncio.run(jax_meta.MetadataExtractor().extract_metadata(name, text))
        assert meta.metadata_to_device_fields(got) == jax_meta.metadata_to_device_fields(got)
    got = asyncio.run(meta.MetadataExtractor().extract_batch(META_CASES))
    assert got == asyncio.run(jax_meta.MetadataExtractor().extract_batch(META_CASES))
    assert got[0]["publish_date"] == "2023-05-10" and isinstance(
        meta.metadata_to_device_fields(got[0])["publish_ts"], int)


class FakeLLM:
    def __init__(self, reply):
        self.reply, self.prompts = reply, []

    async def run(self, prompt):
        self.prompts.append(prompt)
        if isinstance(self.reply, Exception):
            raise self.reply
        return self.reply


@pytest.mark.parametrize("reply", [
    'Sure: {"publish_date": "2022/01/05", "key_timepoints": ["2021", "bogus"], '
    '"authors": ["A"], "summary": "s"} done',
    '{"publish_date": null}',
    "no json at all",
    RuntimeError("endpoint down"),
], ids=["json", "partial", "garbage", "error"])
def test_metadata_extractor_with_an_llm_matches_jax(reply):
    mine, theirs = FakeLLM(reply), FakeLLM(reply)
    got = asyncio.run(meta.MetadataExtractor(mine).extract_metadata(*META_CASES[0]))
    assert got == asyncio.run(jax_meta.MetadataExtractor(theirs).extract_metadata(*META_CASES[0]))
    assert mine.prompts == theirs.prompts


HICHUNK_TEXTS = [
    "# Title\nIntro sentence one. Intro two!\n## Part A\nBody a. More a?\n## Part B\nBody b.",
    " ".join(f"Sentence number {i} ends here." for i in range(60)),
    "中文句子一。中文句子二！English follows; then more text.\n" * 20,
    "x" * 700 + ". short.",
    "",
]


@pytest.mark.parametrize("window", [4000, 600, 100])
def test_hichunk_heuristic_matches_jax(window):
    for text in HICHUNK_TEXTS:
        assert hichunk.split_sentences(text, 64) == jax_hichunk.split_sentences(text, 64)
        engine = hichunk.HiChunkEngine(window_size=window, line_max_len=128)
        ref = jax_hichunk.HiChunkEngine(window_size=window, line_max_len=128)
        s, p = asyncio.run(engine.chunk_points(text))
        rs, rp = asyncio.run(ref.chunk_points(text))
        assert s == rs and [vars(x) for x in p] == [vars(x) for x in rp]
        assert asyncio.run(engine.to_chunklevel_markdown(text)) == \
            asyncio.run(ref.to_chunklevel_markdown(text))


class FakeFileStore:
    def __init__(self):
        self.objects = {}

    def upload(self, bucket, name, data, metadata=None):
        self.objects[(bucket, name)] = (bytes(data), metadata)

    def download(self, bucket, name):
        return self.objects[(bucket, name)][0]


LAYOUT_PNG = base64.b64encode(b"\x89PNG fake layout").decode()


@pytest.fixture
def fake_service(monkeypatch):
    """Every httpx client of both packages talks to one in-process fake of
    an OCR service and a HiChunk endpoint; returns the request log."""
    log = []

    def handler(request):
        body = json.loads(request.content)
        log.append((request.url.path, body))
        if request.url.path.endswith("/ocr"):
            if body["filename"] == "refused.pdf":
                return httpx.Response(400, json={"error": "bad document"})
            return httpx.Response(200, json={"pages": [
                {"markdown": "Page one text."},
                {"markdown": "Page two text.", "structured": {"cells": [1, 2]},
                 "layout_image": LAYOUT_PNG},
                "a bare page",
            ]})
        return httpx.Response(200, json={"choices": [{"message": {
            "content": "1\t0\n2, 2\nnot a point\n 3 1 \n"}}]})

    real = httpx.AsyncClient

    class Client(real):
        def __init__(self, *args, **kwargs):
            kwargs["transport"] = httpx.MockTransport(handler)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(httpx, "AsyncClient", Client)
    return log


def test_ocr_matches_jax(fake_service, monkeypatch):
    monkeypatch.delenv("YRT_OCR_URL", raising=False)
    monkeypatch.delenv("UTU_OCR_URL", raising=False)
    for name in ("scan.pdf", "photo.JPG", "notes.md", "data.csv", "x.webp"):
        assert ocr.needs_ocr(name) == jax_ocr.needs_ocr(name)
        for fn in ("page_md_name", "page_layout_name", "page_json_name"):
            assert getattr(ocr, fn)(name, 3) == getattr(jax_ocr, fn)(name, 3)
        assert ocr.combined_md_name(name) == jax_ocr.combined_md_name(name)
    for body in ({"markdown": "one"}, {"pages": ["a", {"markdown": "b"}]}, {}):
        pages = ocr.pages_from_response(body)
        assert pages == jax_ocr.pages_from_response(body)
        assert ocr.combine_pages(pages) == jax_ocr.combine_pages(pages)
    # unconfigured: a clear error, and the pipeline does nothing
    assert not ocr.RemoteOCRClient().available
    with pytest.raises(RuntimeError, match="not configured"):
        asyncio.run(ocr.RemoteOCRClient().ocr_to_markdown(b"x", "a.pdf"))
    assert asyncio.run(ocr.process_ocr_to_store(FakeFileStore(), "b", "scan.pdf")) is None
    # configured: the same request, the same markdown and derived files
    stores = []
    for mod in (ocr, jax_ocr):
        client = mod.RemoteOCRClient("http://ocr.test/", max_retries=1)
        md = asyncio.run(client.ocr_to_markdown(b"%PDF fake", "scan.pdf"))
        store = FakeFileStore()
        store.upload("uploads", "scan.pdf", b"%PDF fake")
        store.upload("uploads", "notes.md", b"text")
        derived = asyncio.run(mod.process_ocr_to_store(store, "uploads", "scan.pdf", client))
        assert asyncio.run(mod.process_ocr_to_store(store, "uploads", "notes.md", client)) is None
        stores.append((md, derived, store.objects))
        with pytest.raises(httpx.HTTPStatusError):
            asyncio.run(client.ocr(b"x", "refused.pdf"))
    assert stores[0] == stores[1]
    assert stores[0][1] == "scan_ocr.md" and "# Page 2" in stores[0][0]
    assert fake_service[:3] == fake_service[3:6]


def test_hichunk_remote_matches_jax(fake_service, monkeypatch):
    lines = list(enumerate(["# Title", "First sentence.", "## Part", "Body."]))
    got = asyncio.run(hichunk.RemoteChunkPointModel("http://chunk.test/").infer_async(lines))
    want = asyncio.run(jax_hichunk.RemoteChunkPointModel("http://chunk.test/").infer_async(lines))
    assert [vars(p) for p in got] == [vars(p) for p in want] == [
        {"level": 1, "line": 0}, {"level": 2, "line": 2}, {"level": 3, "line": 1}]
    assert fake_service[0] == fake_service[1]
    assert fake_service[0][0] == "/v1/chat/completions"
    monkeypatch.setenv("YRT_CHUNK_URL", "http://chunk.test")
    engine, ref = hichunk.get_hichunk_engine(max_level=2), jax_hichunk.get_hichunk_engine(max_level=2)
    assert isinstance(engine.model, hichunk.RemoteChunkPointModel)
    text = HICHUNK_TEXTS[0]
    assert asyncio.run(engine.to_chunklevel_markdown(text)) == \
        asyncio.run(ref.to_chunklevel_markdown(text))


def write_qa(path, frame: dict):
    pd.DataFrame(frame).to_csv(path, index=False)
    return str(path)


def test_qa_file_matches_jax(tmp_path):
    files = {
        "en": write_qa(tmp_path / "en.csv", {"Question": ["q1?", "", "q3?"],
                                             "answer": ["a1", "a2", None],
                                             "How To Find": ["doc", "doc", "x"]}),
        "zh": write_qa(tmp_path / "zh.csv", {"问题": ["什么?"], "答案": ["这个"], "查找方式": ["文档"]}),
        "missing": write_qa(tmp_path / "missing.csv", {"question": ["q"], "answer": ["a"]}),
    }
    (tmp_path / "garbage.csv").write_bytes(b"\x00\x01\x02")
    files["garbage"] = str(tmp_path / "garbage.csv")
    files["absent"] = str(tmp_path / "absent.csv")
    for name, path in files.items():
        assert qa.validate_qa_file(path) == jax_qa.validate_qa_file(path), name
        try:
            want = jax_qa.parse_qa_file(path)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                qa.parse_qa_file(path)
            assert str(got.value) == str(e)
        else:
            assert qa.parse_qa_file(path) == want
    assert qa.validate_qa_file(files["en"])["row_count"] == 3
    assert [p["question"] for p in qa.parse_qa_file(files["en"])] == ["q1?", "q3?"]
    assert not qa.validate_qa_file(files["missing"])["valid"]


NAMES = ["My Report 2024.xlsx", "123bad", "销售数据.csv", "kb_tables", "a-b", "a_b", "..x..", "",
         "x" * 100 + ".csv", "ok_name"]


def test_table_store_matches_jax(tmp_path):
    assert [tables.sanitize_table_name(n) for n in NAMES] == \
        [jax_tables.sanitize_table_name(n) for n in NAMES]
    df = pd.DataFrame({"city": ["paris", "rome", "paris"], "n": [1, 2, 3]})
    stores = [tables.TableStore(tmp_path / "port" / "t.sqlite"), jax_tables.TableStore()]
    results = []
    for store in stores:
        out = [store.store_dataframe("kb", "a/sales.csv", "sales.csv", df),
               store.store_dataframe("kb", "b/sales.csv", "sales.csv", df),  # collides
               store.store_dataframe("kb", "a/sales.csv", "sales.csv", df.head(2))]
        out += [store.tables_for_kb("kb"), store.tables_for_source("kb", "a/sales.csv"),
                store.get_schema("sales"), store.column_top_values("sales", "city"),
                store.sample_rows("sales", 2), store.execute_sql('SELECT * FROM "sales"', limit=1),
                store.execute_sql("DELETE FROM sales"),
                store.execute_sql("WITH x AS (SELECT 1) DELETE FROM sales"),
                store.execute_sql("PRAGMA table_info(sales)"),
                store.execute_sql("SELECT nope FROM sales"),
                store.drop_table("kb", "kb_tables"), store.drop_table("kb", "sales"),
                store.tables_for_kb("kb")]
        results.append(out)
        store.close()
    assert results[0] == results[1]
    assert results[0][1] != results[0][0] and results[0][-3] is False and results[0][-2] is True
