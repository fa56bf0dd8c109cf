"""Every metric file's reading and the yardstick's operation and byte
counts against sums worked by hand."""

from types import SimpleNamespace

import pytest

from portbench.bench import counts, spec

BERT_BASE = {"hidden_size": 768, "intermediate_size": 3072, "num_hidden_layers": 12}


def test_bert_flops_by_hand():
    # one sequence of 512: 12 x (8*512*768^2 + 4*512*768*3072 + 4*512^2*768)
    assert counts.bert_flops(BERT_BASE, 512, 512 * 512) == 12 * (
        2_415_919_104 + 4_831_838_208 + 805_306_368) == 96_636_764_160


def test_attention_bound_by_hand():
    # [128, 12, 512, 64] bf16: 402,915,328 bytes (q, k, v, out and the bias)
    # outweigh 25,769,803,776 operations: 0.1203 ms, the kernel table's bound
    assert counts.attention_bound_s(128, 12, 512, 512, 64, 2) == pytest.approx(
        402_915_328 / 3.35e12)
    # short and wide: operations bound it
    assert counts.attention_bound_s(1, 1, 4096, 4096, 128, 2) == pytest.approx(
        4 * 4096 * 4096 * 128 / 989e12)


def test_scan_bytes_by_hand():
    # the headline bf16 index: 1,048,576 rows of 768 bf16 and an f32 bias: 0.4820 ms
    assert counts.scan_bytes(1 << 20, 2 * 768 + 4) / counts.HBM_BYTES == pytest.approx(
        1_614_807_040 / 3.35e12)


def m(**kw):
    base = dict(spans={}, rerank_s=[], embed_s=0.0, attn=[],
                trace={"by_name": {}, "busy_s": 0.0, "window_s": 2.0},
                coalescers={"embed_dispatches": 0, "embed_items": 0, "search_dispatches": 0,
                            "search_queries": 0},
                window_s=10.0, config={"embedder": BERT_BASE}, forwards=[], scans=[],
                profiled_scans=[], latencies=[])
    base.update(kw)
    return SimpleNamespace(**base)


def read(name):
    return spec.reader(spec.BENCH_DIR, name)


def test_readers_by_hand():
    host = dict(spans={"embedding/embed_queries": [2.0, 4.0],
                       "retrieval/vector_search": [1.0, 2.0, 3.0]},
                rerank_s=[0.010, 0.030], embed_s=2.5, attn=[(16, 12, 512, 512, 64, 2)])
    trace = {"by_name": {"void attention_wgmma::attention_kernel<64, 0>(x)": 0.001,
                         "void ivf_tma_kernel<Int8>(a, b)": 0.004, "nvjet_gemm": 1.0},
             "busy_s": 0.5, "window_s": 2.0}
    co = {"embed_dispatches": 4, "embed_items": 100, "search_dispatches": 5,
          "search_queries": 320}
    fw = [(16, 512, 16 * 300.0, 16 * 300.0 ** 2)]
    sc = [("ivf", 1024 * 100, 776), ("brute", 1 << 20, 1540)]
    x = m(trace=trace, coalescers=co, forwards=fw, scans=sc, profiled_scans=sc[:1], **host)
    assert read("embed_ms.query")(x) == 3.0
    assert read("search_ms.query")(x) == 2.0
    assert read("rerank_ms.query")(x) == pytest.approx(20.0)
    assert read("embed_batch.query")(x) == 25.0
    assert read("search_batch.query")(x) == 64.0
    assert read("embed_share.ingest")(x) == 25.0
    assert read("idle_share.query")(x) == read("idle_share.ingest")(x) == 75.0
    ops = counts.bert_flops(BERT_BASE, 4800, 16 * 90_000)
    nbytes = 1024 * 100 * 776 + (1 << 20) * 1540
    assert read("step_mfu.query")(x) == pytest.approx(
        100 * (ops / 989e12 + nbytes / 3.35e12) / 10.0)
    assert read("step_mfu.ingest")(x) == pytest.approx(100 * ops / 989e12 / 10.0)
    bound = counts.attention_bound_s(16, 12, 512, 512, 64, 2)
    assert read("attn_roofline.rerank")(x) == read("attn_roofline.ingest")(x) == \
        pytest.approx(100 * bound / 0.001)
    # only the profiled scan counts against the scan kernel's time
    assert read("scan_roofline.query")(x) == pytest.approx(
        100 * 1024 * 100 * 776 / 3.35e12 / 0.004)


def test_readers_say_nothing_without_readings():
    for name in ("embed_ms.query", "search_ms.query", "rerank_ms.query",
                 "embed_batch.query",
                 "search_batch.query", "embed_share.ingest", "idle_share.query",
                 "idle_share.ingest", "step_mfu.query", "step_mfu.ingest",
                 "attn_roofline.rerank", "attn_roofline.ingest", "scan_roofline.query"):
        assert read(name)(m()) is None, name
