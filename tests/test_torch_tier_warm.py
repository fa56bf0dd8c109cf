"""The port's tier warm-up (``reserve``, ``ensure_tier_ready``, next-tier
warming) on the CPU against the JAX package's ``DeviceVectorIndex``.

The same adds and searches on both indexes: ``reserve`` gives the same
capacity; searches record the same signatures (``_seen_sigs``: query
bucket, k asked of the kernel, raw backend) and appends the same buckets;
the warm is scheduled at the same fill (75 %), once per (capacity, item),
in a thread of the same name; ``ensure_tier_ready`` marks the same items
warmed; and a search after it returns JAX's rows with scores within 1e-4
(bf16: both score ``f32(bf16 q) · f32(bf16 x)`` in f32) or 1e-5 (int8 and
int4: exact integer dots, the same f32 epilogue). On the CPU the port's
warm-up builds and launches nothing, and a warm that fails is logged and
leaves every search as it was. The sharded indexes make both methods
no-ops. The warm-up on the card is held against a cold index in
``tests/test_torch_cuda.py``."""

import logging
import threading

import jax
import numpy as np
import pytest

from youtu_rag_tpu.core.config import IndexConfig as JaxIndexConfig
from youtu_rag_tpu.core.types import Chunk as JaxChunk
from youtu_rag_tpu.index.device_index import DeviceVectorIndex as JaxIndex
from youtu_rag_tpu.parallel import sharded_index as jax_sharded
from youtu_rag_tpu.parallel.mesh import get_mesh as jax_get_mesh
from youtu_rag_tpu_torch.core.config import IndexConfig
from youtu_rag_tpu_torch.core.types import Chunk
from youtu_rag_tpu_torch.index import DeviceVectorIndex
from youtu_rag_tpu_torch.ops import _build
from youtu_rag_tpu_torch.ops.topk import topk_int8_pruned, topk_pruned
from youtu_rag_tpu_torch.parallel import ShardedVectorIndex, get_mesh
from torch_native_helpers import jax_tracer_restored  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("jax_tracer_restored")

D = 64
TOL = {"bfloat16": 1e-4, "int8": 1e-5, "int4": 1e-5}


def chunks(cls, n, start=0, doc="doc"):
    return [cls(f"{doc}-{i}", doc, f"content {i}", i, {"source": doc, "idx": i % 5})
            for i in range(start, start + n)]


def unit(seed, n, d=D):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def join_warm_threads(timeout=120.0):
    for t in threading.enumerate():
        if t.name.startswith("yrt-warm-"):
            t.join(timeout)
            assert not t.is_alive(), t.name


class Pair:
    """The same operations on the JAX index and the port's (CPU)."""

    def __init__(self, **cfg):
        self.jax = JaxIndex(D, JaxIndexConfig(**cfg))
        self.port = DeviceVectorIndex(D, IndexConfig(**cfg), device="cpu")
        self.added = 0

    def add(self, n, seed):
        embs = unit(seed, n)
        self.jax.add(chunks(JaxChunk, n, self.added), embs)
        self.port.add(chunks(Chunk, n, self.added), embs)
        self.added += n

    def search(self, queries, **kw):
        return (self.jax.search(queries, **kw), self.port.search(queries, **kw))

    def same(self, *names):
        for name in names:
            assert getattr(self.port, name) == getattr(self.jax, name), name


def record_warms(ix, log):
    """Swap the index's ``_warm_tier`` for a recorder of (thread, capacity,
    items, quiet); JAX's in-process dispatch warm too."""
    lock = threading.Lock()

    def warm(cap, items, quiet=False):
        with lock:
            log.append((threading.current_thread().name, cap, tuple(sorted(items)), quiet))
        for it in items:
            ix._warmed.add((cap, it))

    ix._warm_tier = warm
    if hasattr(ix, "_jit_warm"):
        ix._jit_warm = lambda cap: None


def assert_same_hits(jax_hits, port_hits, tol):
    assert len(jax_hits) == len(port_hits)
    for j, p in zip(jax_hits, port_hits):
        assert [c.id for c, _ in p] == [c.id for c, _ in j]
        np.testing.assert_allclose([s for _, s in p], [s for _, s in j], rtol=0, atol=tol)


@pytest.mark.parametrize("min_capacity,block_rows,total", [
    (256, 128, 1), (256, 128, 256), (256, 128, 257), (4096, 1024, 5000),
    (100, 128, 3000), (4096, 512, 1 << 16),
])
def test_reserve_gives_jax_capacity(min_capacity, block_rows, total):
    p = Pair(min_capacity=min_capacity, block_rows=block_rows)
    p.same("capacity")
    p.jax.reserve(total)
    p.port.reserve(total)
    p.same("capacity", "size")
    assert p.port._vectors.shape[0] == p.port._bias.shape[0] == p.port.capacity
    # appends inside the reserved capacity grow nothing and warm nothing yet
    cap = p.port.capacity
    p.add(min(total, 64), seed=1)
    assert p.port.capacity == cap
    p.same("capacity", "_seen_buckets")


@pytest.mark.parametrize("storage", ["bfloat16", "int8"])
def test_warm_scheduled_at_jax_fill_once_per_item(storage):
    """Appends and searches across the 75 % line and a growth: the same
    (thread, capacity, items) warms on both, each (capacity, item) once."""
    p = Pair(min_capacity=512, block_rows=128, storage_dtype=storage, append_slice_rows=128)
    logs = {"jax": [], "port": []}
    record_warms(p.jax, logs["jax"])
    record_warms(p.port, logs["port"])
    q = unit(7, 3)
    fills = []
    for step, n in enumerate([200, 150, 30, 40, 10]):  # 200, 350, 380 (74 %), 420, 430
        p.add(n, seed=step)
        join_warm_threads()
        fills.append((p.port.size, len(logs["port"])))
        p.search(q, top_k=4)
        p.search(q[:1], top_k=4)  # a second signature
        join_warm_threads()
    p.search(unit(8, 5), top_k=6)  # a new signature past the line: warms alone
    join_warm_threads()
    p.add(150, seed=9)  # 580 rows: a growth to 1024, after ensure_tier_ready
    join_warm_threads()
    p.same("capacity", "size", "_seen_sigs", "_seen_buckets", "_warmed")
    assert sorted(logs["port"]) == sorted(logs["jax"])
    # nothing before 75 % full (384 of 512 rows), then the doubled capacity
    assert [n for size, n in fills if size * 4 < 512 * 3] == [0, 0, 0]
    assert any(cap == 1024 and name == "yrt-warm-1024" for name, cap, _, _ in logs["port"])
    background = [(cap, it) for name, cap, items, _ in logs["port"] if name != "MainThread"
                  for it in items]
    assert len(background) == len(set(background))  # once per (capacity, item)
    # add() warmed the growth's capacity synchronously, every item known
    (ensure,) = [e for e in logs["port"] if e[0] == "MainThread"]
    assert ensure[1] == 1024 and ensure[3] is True
    assert {it for it in ensure[2]} == {("sig", s) for s in p.port._seen_sigs} | {
        ("bucket", b) for b in p.port._seen_buckets}


def test_signatures_match_jax():
    """Query buckets, k as the kernel is asked (int4 over-fetch), raw
    backends, filters, the cap of 8 signatures; append buckets under
    ``append_slice_rows`` and without it."""
    for storage in ("bfloat16", "int4"):
        p = Pair(min_capacity=256, block_rows=128, storage_dtype=storage, append_slice_rows=64)
        for ix in (p.jax, p.port):
            record_warms(ix, [])
        for i, n in enumerate([1, 3, 64, 65, 100, 128, 129, 200, 17]):
            p.add(n, seed=i)
        for n_q, k, kw in [(1, 5, {}), (2, 5, {}), (3, 5, {}), (8, 10, {}),
                           (3, 5, {"filters": {"idx": 2}}), (1, 5, {"backend": "xla"}),
                           (5, 500, {}), (4, 7, {"backend": "pallas_interpret"})]:
            if storage == "int4" and kw.get("backend") == "pallas_interpret":
                continue  # JAX's int4 kernel in interpret mode: slow, and neither records it
            p.search(unit(20 + n_q, n_q), top_k=k, **kw)
        for i in range(12):  # more signatures than the cap of 8
            p.search(unit(40 + i, 1), top_k=11 + i)
        join_warm_threads()
        p.same("_seen_sigs", "_seen_buckets")
        assert len(p.port._seen_sigs) == 8
        assert all(b <= 64 for b in p.port._seen_buckets)
    p = Pair(min_capacity=256, block_rows=128, append_slice_rows=0)
    for ix in (p.jax, p.port):
        record_warms(ix, [])
    for i, n in enumerate([64, 1, 300, 700]):
        p.add(n, seed=i)
    join_warm_threads()
    p.same("_seen_buckets")
    assert p.port._seen_buckets == {64, 512, 1024}


@pytest.mark.parametrize("storage", ["bfloat16", "int8", "int4"])
@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_search_after_ensure_tier_ready_matches_jax(storage, metric):
    p = Pair(min_capacity=256, block_rows=128, storage_dtype=storage, metric=metric)
    p.add(200, seed=1)
    q = unit(5, 3)
    p.search(q, top_k=5)
    p.search(q[:1], top_k=5, filters={"idx": 1})
    for ix in (p.jax, p.port):
        ix.ensure_tier_ready(512)
    p.same("_warmed")
    assert {it for cap, it in p.port._warmed if cap == 512} == set(p.port._warm_items())
    p.add(150, seed=2)  # a growth to 512 (the bucket of 256 rows)
    join_warm_threads()
    p.same("capacity", "size")
    for queries, kw in [(q, {}), (q[:1], {"filters": {"idx": 1}}), (unit(6, 8), {"top_k": 9})]:
        jax_hits, port_hits = p.search(queries, **kw)
        assert_same_hits(jax_hits, port_hits, TOL[storage])


@pytest.fixture
def no_build(monkeypatch):
    """Building or loading a kernel library raises."""
    def refuse(*a, **k):
        raise AssertionError("the CPU warm-up built or loaded a kernel library")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)


def test_cpu_warm_builds_and_launches_nothing(no_build):
    before = (topk_pruned.launches, topk_int8_pruned.launches)
    for storage in ("bfloat16", "int8"):
        ix = DeviceVectorIndex(D, IndexConfig(min_capacity=256, block_rows=128,
                                              storage_dtype=storage), device="cpu")
        ix.add(chunks(Chunk, 230), unit(1, 230))
        ix.search(unit(2, 2), top_k=3)
        ix.ensure_tier_ready(1024)
        ix.add(chunks(Chunk, 100, 230), unit(3, 100))  # a growth: ensure_tier_ready(512)
        join_warm_threads()
        assert ix.capacity == 512
        assert (512, ("sig", (2, 3, "auto"))) in ix._warmed
        assert (1024, ("sig", (2, 3, "auto"))) in ix._warmed
    assert (topk_pruned.launches, topk_int8_pruned.launches) == before


class Messages(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_failed_warm_is_logged_and_changes_no_search():
    cfg = IndexConfig(min_capacity=256, block_rows=128)
    warmed = DeviceVectorIndex(D, cfg, device="cpu")
    cold = DeviceVectorIndex(D, cfg, device="cpu")
    calls = []

    def fail(cap, items, quiet=False):
        calls.append((threading.current_thread().name, cap))
        raise RuntimeError("warm failed on purpose")

    warmed._warm_tier = fail
    cold._maybe_warm_next_tier = lambda: None
    cold.ensure_tier_ready = lambda cap: None
    q = unit(4, 3)
    log, handler = logging.getLogger("youtu_rag_tpu_torch.index.device"), Messages()
    log.addHandler(handler)
    try:
        for ix in (warmed, cold):
            ix.add(chunks(Chunk, 230), unit(1, 230))
            ix.search(q, top_k=4)
            ix.add(chunks(Chunk, 60, 230), unit(2, 60))  # a growth
        join_warm_threads()
    finally:
        log.removeHandler(handler)
    assert ("MainThread", 512) in calls and ("yrt-warm-512", 512) in calls
    assert sum(m == "tier warm failed (capacity 512)" for m in handler.messages) == len(calls)
    assert warmed.capacity == cold.capacity == 512
    for queries in (q, unit(5, 8)):
        got, want = warmed.search(queries, top_k=6), cold.search(queries, top_k=6)
        assert [[(c.id, s) for c, s in h] for h in got] == [[(c.id, s) for c, s in h] for h in want]


@pytest.mark.parametrize("s", [2, 4])
def test_sharded_warm_methods_are_no_ops(s):
    """Both sharded indexes at 100 % full with signatures seen, then a
    growth: nothing scheduled, nothing warmed."""
    cfg = dict(min_capacity=512, block_rows=64)
    jx = jax_sharded.ShardedVectorIndex(D, JaxIndexConfig(**cfg),
                                        mesh=jax_get_mesh({"db": s}, devices=jax.devices()[:s]))
    px = ShardedVectorIndex(D, IndexConfig(**cfg), mesh=get_mesh({"db": s}, devices=["cpu"] * s))
    for ix, cls in ((jx, JaxChunk), (px, Chunk)):
        ix._schedule_warm = lambda cap: pytest.fail("a sharded index scheduled a warm")
        ix._warm_tier = lambda *a, **k: pytest.fail("a sharded index warmed")
        ix.add(chunks(cls, 512), unit(1, 512))
        ix.search(unit(2, 3), top_k=4)
        assert ix.ensure_tier_ready(2048) is None
        assert ix._maybe_warm_next_tier() is None
        ix.add(chunks(cls, 64, 512), unit(3, 64))
        assert ix.capacity == 1024 and not ix._warmed
    assert px._seen_sigs == jx._seen_sigs and px._seen_buckets == jx._seen_buckets


def test_concurrent_searches_schedule_each_item_once():
    """16 threads (more than this host's cores) search a full index with
    their own and shared signatures while a writer appends, under a short
    switch interval: every (capacity, item) is scheduled exactly once, and
    every item seen is warmed."""
    import sys

    ix = DeviceVectorIndex(D, IndexConfig(min_capacity=512, block_rows=128), device="cpu")
    log = []
    record_warms(ix, log)
    ix.add(chunks(Chunk, 440), unit(1, 440))  # 86 % full
    join_warm_threads()
    queries = unit(2, 8)
    errors = []

    def searcher(i):
        try:
            for j in range(6):
                ix.search(queries[: 1 + (i + j) % 4], top_k=1 + (i * 7 + j) % 5)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=searcher, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        ix.add(chunks(Chunk, 20, 440), unit(3, 20))  # a bucket of 64: no growth
        for t in threads:
            t.join(120)
            assert not t.is_alive()
        join_warm_threads()
    finally:
        sys.setswitchinterval(old)
    assert not errors
    scheduled = [(cap, it) for name, cap, items, _ in log if name != "MainThread"
                 for it in items]
    assert len(scheduled) == len(set(scheduled))
    assert set(scheduled) == {(1024, it) for it in ix._warm_items()} == ix._warmed
    assert len(ix._seen_sigs) == 8 and ix.capacity == 512
