"""Percentiles and rates over the whole window: every request that
finished inside it, none after; chunks by the time their document was
stored; a traced run's host readings only from the profiler's stop on."""

from types import SimpleNamespace

import pytest
import torch

from portbench.bench import drive, harness, probe, spec

QA = spec.driver(spec.BENCH_DIR, "qa")
INGEST = spec.driver(spec.BENCH_DIR, "ingest")


def window(seconds=10.0):
    w = drive.Window(seconds, 1.0)
    w.start, w.end = 100.0, 100.0 + seconds
    w.host_from = w.start
    return w


def test_qa_metrics_count_the_window_only():
    lat = [(i, 100.0 + i * 0.09, 100.0 + i * 0.09 + 0.001 * (i + 1)) for i in range(100)]
    lat.append((100, 109.9, 110.5))  # finishes after the window: not counted
    raw = {"latencies": lat}
    got = QA.metrics(raw, window())
    assert got["queries_per_s"] == pytest.approx(100 / 10.0)
    # rank 0.95 * 99 = 94.05 between 95 and 96 ms
    assert got["query_p95_ms"] == pytest.approx(95.05)
    assert sorted(QA.finished(raw, window())) == pytest.approx([0.001 * (i + 1)
                                                               for i in range(100)])


def test_ingest_metrics_count_stored_chunks():
    stored = [(100.5, 10), (105.0, 12), (109.99, 3), (110.01, 50)]
    assert INGEST.metrics({"stored": stored}, window())["ingest_chunks_per_s"] == \
        pytest.approx(25 / 10.0)


def test_empty_window_is_an_error():
    with pytest.raises(RuntimeError):
        QA.metrics({"latencies": [(0, 100.0, 111.0)]}, window())


def test_counts_of_a_result():
    class S:
        total_documents, processed_documents = 4, 3

    assert QA.counts({"latencies": [1, 2], "issued": 3}) == (3, 1)
    assert INGEST.counts({"calls": [(0, 0, 0, S()), (1, 0, 0, S())], "per": 4}) == (8, 2)


def test_traced_host_readings_start_after_the_profiler():
    """Spans, timers, latencies and the forwards the whole-step share
    counts are read from ``host_from`` on, over the rest of the window."""
    w = window()
    w.host_from = 106.0
    rec = probe.Record(lambda i: False)
    rec.spans["embedding/embed_queries"] = [(101.0, 900.0), (107.0, 2.0), (108.0, 4.0)]
    rec.rerank_s = [(102.0, 5.0), (107.5, 0.02)]
    rec.embed_calls = [(105.0, 107.0), (108.0, 109.0)]
    rec.forwards = [(101.0, 1, 4, torch.tensor([4.0])), (107.0, 2, 4, torch.tensor([3.0, 4.0]))]
    rec.scans = [(101.5, "brute", 1000, 10, 1, True), (107.0, "brute", 1000, 10, 1, False)]
    raw = {"latencies": [(0, 101.0, 105.0), (1, 106.5, 106.6), (2, 109.0, 111.0)],
           "coalescers": {}}
    seen = {}

    def reader(m):
        seen["m"] = m

    cell = SimpleNamespace(readers={"x": reader})
    fx = SimpleNamespace(cfg={})
    harness.layer_metrics(cell, fx, rec, raw, w)
    m = seen["m"]
    assert m.window_s == pytest.approx(4.0)
    assert m.spans["embedding/embed_queries"] == [2.0, 4.0]
    assert m.rerank_s == [0.02]
    assert m.embed_s == pytest.approx(2.0)
    assert m.latencies == pytest.approx([0.1])
    assert [f[:2] for f in m.forwards] == [(2, 4)] and m.forwards[0][2] == 7.0
    assert m.scans == [("brute", 1000, 10)] and m.profiled_scans == [("brute", 1000, 10)]
