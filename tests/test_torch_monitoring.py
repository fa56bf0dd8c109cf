"""The port's storage monitor (``retrieval/monitoring.py``) and result cache
(``utils/cache.py``) against the JAX package's, on the CPU.

- ``StorageMonitor`` over each package's store on the same chunks (the
  port's device index on the CPU, and the numpy backend): health, query
  stats, slow-query alerts with logging off (``tests/ingest/
  test_retrieval_review_fixes.py``), the coalescer's and the BM25 index's
  metrics; ``UnifiedStorageMonitor``'s summary, report and unregister; a
  store whose health raises reports unhealthy;
- the 5 cases of ``tests/core/test_cache.py`` on both packages, and one
  cache directory read by both.

Tolerance: none; health and metrics compare field by field (times and the
index's byte size, which differ by design, left out)."""

import asyncio
import time

import numpy as np
import pytest

import youtu_rag_tpu.utils.cache as jax_cache
import youtu_rag_tpu_torch.utils.cache as cache
from youtu_rag_tpu.core.config import MonitorConfig as JaxMonitorConfig
from youtu_rag_tpu.core.config import VectorStoreConfig as JaxStoreConfig
from youtu_rag_tpu.core.types import Chunk as JaxChunk
from youtu_rag_tpu.retrieval.monitoring import StorageMonitor as JaxMonitor
from youtu_rag_tpu.retrieval.monitoring import UnifiedStorageMonitor as JaxUnified
from youtu_rag_tpu.retrieval.store import TpuVectorStore
from youtu_rag_tpu_torch.core.config import MonitorConfig, VectorStoreConfig
from youtu_rag_tpu_torch.core.types import Chunk
from youtu_rag_tpu_torch.retrieval.monitoring import StorageMonitor, UnifiedStorageMonitor
from youtu_rag_tpu_torch.retrieval.store import TorchVectorStore
from torch_native_helpers import jax_tracer_restored  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("jax_tracer_restored")


def run(coro):
    return asyncio.run(coro)


def chunks(cls, n=24):
    rng = np.random.default_rng(0)
    return [cls(f"c{i}", f"d{i % 4}", f"alpha beta {i} gamma", i,
                embedding=rng.standard_normal(16).astype(np.float32).tolist()) for i in range(n)]


def stores(backend, window=0.0):
    port = TorchVectorStore(VectorStoreConfig(backend=backend, coalesce_window_ms=window),
                            device="cpu")
    jax_store = TpuVectorStore(JaxStoreConfig(backend="tpu" if backend == "torch" else backend,
                                              coalesce_window_ms=window))
    run(port.add_chunks(chunks(Chunk)))
    run(jax_store.add_chunks(chunks(JaxChunk)))
    return port, jax_store


def metrics_view(m):
    return {k: v for k, v in m.items() if k != "index_size_bytes"}


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_check_health_and_metrics_match_jax(backend):
    port, jax_store = stores(backend, window=2.0)

    async def searches(store):
        q = np.random.default_rng(1).standard_normal((6, 16)).astype(np.float32)
        await asyncio.gather(*(store.search(v.tolist(), top_k=3) for v in q))

    run(searches(port))
    run(searches(jax_store))
    mons = [StorageMonitor(port, name="kb"), JaxMonitor(jax_store, name="kb")]
    for m in mons:
        for i, lat in enumerate((5.0, 12.0, 7.5, 2000.0)):
            run(m.log_query(f"q{i}", lat, 3))
        m.log_error()
    got, want = (run(m.collect_metrics()) for m in mons)
    assert metrics_view(got) == metrics_view(want)
    assert got["healthy"] and got["total_chunks"] == 24 and got["alerts"] == 1
    assert got["search_coalescing"]["queries"] == 6 and got["lexical_index"]["documents"] == 24
    health = run(mons[0].check_health())
    want_health = run(mons[1].check_health())
    assert health.is_healthy and want_health.is_healthy and health.backend == backend
    assert health.total_chunks == want_health.total_chunks == 24
    if backend == "torch":
        assert health.index_size_bytes == port.index.nbytes() > 0


def test_alerts_fire_with_logging_disabled():
    out = []
    for mon_cls, cfg_cls in ((StorageMonitor, MonitorConfig), (JaxMonitor, JaxMonitorConfig)):
        mon = mon_cls(None, cfg_cls(enable_query_logging=False, enable_alerts=True,
                                    alert_thresholds={"query_latency_ms": 10.0}), name="kb")
        run(mon.log_query("q", latency_ms=50.0, result_count=1))
        assert len(mon._alerts) == 1 and len(mon._queries) == 0
        out.append([{k: v for k, v in a.items() if k != "time"} for a in mon._alerts])
    assert out[0] == out[1]


def test_health_failure_and_plain_store():
    class Broken:
        async def health(self):
            raise RuntimeError("index lost")

    class Plain:
        async def count(self):
            return 7

    out = []
    for mon_cls in (StorageMonitor, JaxMonitor):
        bad = run(mon_cls(Broken(), name="b").check_health())
        plain = run(mon_cls(Plain(), name="p").check_health())
        out.append(((bad.is_healthy, bad.backend, bad.errors),
                    (plain.is_healthy, plain.backend, plain.collection_name, plain.total_chunks)))
    assert out[0] == out[1] == (((False, "Broken", ["index lost"]), (True, "Plain", "p", 7)))


def test_unified_monitor_matches_jax():
    views = []
    for unified_cls, backend in ((UnifiedStorageMonitor, "torch"), (JaxUnified, "tpu")):
        port, jax_store = stores("torch")
        store = port if unified_cls is UnifiedStorageMonitor else jax_store
        u = unified_cls()
        u.register("a", store)
        u.register("b", store)
        assert u.unregister("b") and not u.unregister("b")
        summary = run(u.summary())
        report = run(u.detailed_report())
        views.append(({k: v for k, v in summary.items() if k != "checked_at"},
                      {n: metrics_view(m) for n, m in report["metrics"].items()}))
    assert views[0] == views[1]
    assert views[0][0] == {"total_backends": 1, "healthy_backends": 1, "overall_healthy": True,
                           "backends": {"a": True}}


def test_query_stats_window():
    out = []
    for mon_cls in (StorageMonitor, JaxMonitor):
        mon = mon_cls(None, name="kb")
        for lat in (1.0, 3.0, 2.0):
            run(mon.log_query("q", lat, 1))
        mon._queries[0].timestamp = time.time() - 3 * 3600  # outside a 2-hour window
        out.append((run(mon.get_query_stats()), run(mon.get_query_stats(time_range_hours=2))))
    assert out[0] == out[1]
    assert out[0][1]["query_count"] == 2


# ---------------------------------------------------------------------------
# tests/core/test_cache.py on both packages
# ---------------------------------------------------------------------------


def case_cache_hits_and_ttl(mod, tmp, monkeypatch):
    calls = {"n": 0}

    @mod.async_file_cache(ttl_seconds=1000, cache_dir=tmp)
    async def expensive(x: int) -> str:
        calls["n"] += 1
        return f"result-{x}"

    async def go():
        return await expensive(1), await expensive(1), await expensive(2)

    a, b, c = run(go())
    assert a == b == "result-1" and c == "result-2" and calls["n"] == 2
    return a, c, calls["n"], sorted(p.name for p in tmp.iterdir())


def case_cache_expiry(mod, tmp, monkeypatch):
    calls = {"n": 0}

    @mod.async_file_cache(ttl_seconds=0.01, cache_dir=tmp)
    async def fn() -> int:
        calls["n"] += 1
        return calls["n"]

    assert run(fn()) == 1
    time.sleep(0.05)
    assert run(fn()) == 2
    return calls["n"]


def case_cache_method_binding(mod, tmp, monkeypatch):
    class Toolkit:
        def __init__(self, label):
            self.label = label

        @mod.async_file_cache(cache_dir=tmp)
        async def lookup(self, q: str) -> str:
            return f"{q}!{self.label}"

    first = run(Toolkit("a").lookup("x"))
    assert run(Toolkit("b").lookup("x")) == first == "x!a"  # self is not in the key
    return first


def case_cache_disabled_env(mod, tmp, monkeypatch):
    calls = {"n": 0}

    @mod.async_file_cache(cache_dir=tmp)
    async def fn() -> int:
        calls["n"] += 1
        return calls["n"]

    monkeypatch.setenv("YRT_NO_RESULT_CACHE", "1")
    run(fn())
    run(fn())
    monkeypatch.delenv("YRT_NO_RESULT_CACHE")
    assert calls["n"] == 2
    return calls["n"], fn.cache_clear()


def case_unserializable_result_passthrough(mod, tmp, monkeypatch):
    @mod.async_file_cache(cache_dir=tmp)
    async def fn():
        return object()

    assert run(fn()) is not None
    return list(tmp.glob("*.json"))


CACHE_CASES = [case_cache_hits_and_ttl, case_cache_expiry, case_cache_method_binding,
               case_cache_disabled_env, case_unserializable_result_passthrough]


@pytest.mark.parametrize("case", CACHE_CASES, ids=[c.__name__[5:] for c in CACHE_CASES])
def test_cache_case_matches_jax(case, tmp_path, monkeypatch):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    assert case(cache, tmp_path / "port", monkeypatch) == case(jax_cache, tmp_path / "jax",
                                                                monkeypatch)


def test_cache_directory_is_shared_across_packages(tmp_path, monkeypatch):
    """One cache directory: a result the JAX package stored, the port reads
    (same key scheme, same file layout), and the default directory lies
    under the caller's home."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("YRT_CACHE_DIR", raising=False)
    assert str(cache._default_cache_dir()).startswith(str(tmp_path / "home"))
    calls = []

    def make(mod):
        @mod.async_file_cache(cache_dir=tmp_path / "shared")
        async def fetch(q: str) -> str:
            calls.append(mod.__name__)
            return f"answer to {q}"
        return fetch

    assert run(make(jax_cache)("q")) == run(make(cache)("q")) == "answer to q"
    assert calls == ["youtu_rag_tpu.utils.cache"]
    assert cache._key("f", ("a",), {"k": 1}) == jax_cache._key("f", ("a",), {"k": 1})
