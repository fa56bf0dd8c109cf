"""The host side of the brute int4 scan on the card, without a card.

``ops/topk.py::topk_int4_pruned`` on a CUDA tensor launches
``csrc/ivf_topk_int4.cu``'s ``topk_pruned_int4`` entry through ``_launch_tma``:
the ring's int4 DMA kernels over the identity plan (no plan tensor, one
block of all n rows), which quantize the queries, scan, select and merge in
one kernel after a memset. Here the CUDA branch runs on CPU tensors against
a stand-in library that records each launch's arguments, so these tests
hold what the wrapper hands the kernel: the entry, the null plan, the block
count, the f32 queries (no quantization on the host), one launch per 64
queries, the launch count, and an error raised, never a fallback. The
kernel itself is held on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import importlib
import types

import pytest
import torch

from youtu_rag_tpu_torch.ops import _build
from youtu_rag_tpu_torch.ops.topk import quantize_rows_int4, topk_int4_pruned

# by its path: youtu_rag_tpu_torch.ops.topk is also the name of a function
T = importlib.import_module("youtu_rag_tpu_torch.ops.topk")
from test_torch_topk_merged import ARG_NAMES, SMS, _FakeRing, _named  # noqa: E402


@pytest.fixture
def card(monkeypatch):
    """The wrapper's CUDA branch on CPU tensors: the stand-in ring library,
    an H100's SM count, no stream, no quantization on the host."""
    fake = _FakeRing()
    monkeypatch.setattr(_build, "load",
                        lambda name: fake if name in T._TMA_LIB.values() else None)
    monkeypatch.setattr(T, "_device_of", lambda name, *tensors: "cuda")
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=SMS))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))

    def refused(*args, **kwargs):
        raise AssertionError("the CUDA branch quantized on the host or ran the plain version")

    for name in ("quantize_rows_int8", "_kernel_queries", "topk_int4_pruned_reference",
                 "_scaled_topk"):
        monkeypatch.setattr(T, name, refused)
    T.scan_plan.cache_clear()
    T._tma_ctas_per_sm.cache_clear()
    fake.before = topk_int4_pruned.launches
    yield fake
    topk_int4_pruned.launches = fake.before
    T.scan_plan.cache_clear()
    T._tma_ctas_per_sm.cache_clear()


def _inputs(qn, n, d, seed=0):
    g = torch.Generator().manual_seed(seed)
    xp, xs = quantize_rows_int4(torch.randn(n, d, generator=g))
    return torch.randn(qn, d, generator=g), xp, xs, torch.zeros(n)


@pytest.mark.parametrize("n", [65536, 4099, 4097, 7, 1])
@pytest.mark.parametrize("qn, launches", [(1, 1), (64, 1), (65, 2), (130, 3)])
def test_int4_wrapper_launches_the_identity_entry_per_64_queries(card, qn, launches, n):
    """One topk_pruned_int4 launch per 64 queries: the plan pointers null,
    one block of all n rows (block_rows = n divides n, odd n included), the
    grid one wave split over the tile's 8-query groups (at most one CTA per
    128 rows: one ring fill), results [q, k]."""
    d, k = 256, min(10, n)
    queries, xp, xs, bias = _inputs(qn, n, d)
    s, i = topk_int4_pruned(queries, xp, xs, bias, k)
    assert topk_int4_pruned.launches - card.before == launches
    assert len(card.launches) == launches
    assert tuple(s.shape) == tuple(i.shape) == (qn, k)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    for t, launch in enumerate(card.launches):
        a = _named(launch)
        tile_q = min(64, qn - 64 * t)
        tiles = -(-tile_q // 8)
        assert launch["entry"] == "topk_pruned_int4"
        assert a["ids"] is None and a["n_valid"] is None
        assert (a["q"], a["n"], a["d"], a["k"]) == (tile_q, n, d, k)
        assert a["block_rows"] == n and n % a["block_rows"] == 0
        assert a["max_blocks"] == n // a["block_rows"] == 1
        assert a["n_cta"] == max(1, min(2 * SMS // tiles, -(-n // T._IDENTITY_ROWS_PER_CTA)))
        assert a["x"] == xp.data_ptr() and a["xscale"] == xs.data_ptr()
        assert a["bias"] == bias.data_ptr()


def test_int4_wrapper_passes_f32_queries_as_given(card):
    """The kernel quantizes the queries: the wrapper hands it each tile's f32
    rows in place (queries_bf16 0), and casts other float types to f32."""
    n, d = 4096, 512
    queries, xp, xs, bias = _inputs(70, n, d)
    topk_int4_pruned(queries, xp, xs, bias, 5)
    first, second = (_named(launch) for launch in card.launches)
    assert first["queries"] == queries.data_ptr()
    assert second["queries"] == queries[64:].data_ptr()
    assert first["queries_bf16"] == second["queries_bf16"] == 0
    for dtype in (torch.float16, torch.bfloat16, torch.float64):
        topk_int4_pruned(queries[:3].to(dtype), xp, xs, bias, 5)
        a = _named(card.launches[-1])
        assert a["queries_bf16"] == 0 and a["queries"] != queries.data_ptr()


def test_int4_wrapper_counts_nothing_without_queries(card):
    """No query: an empty [0, k] result and no launch."""
    _, xp, xs, bias = _inputs(1, 1024, 256)
    s, i = topk_int4_pruned(torch.empty(0, 256), xp, xs, bias, 4)
    assert tuple(s.shape) == tuple(i.shape) == (0, 4)
    assert not card.launches and topk_int4_pruned.launches == card.before


@pytest.mark.parametrize("k", [1, 64, 1024, 2048])
def test_int4_wrapper_takes_the_ring_at_every_k(card, k):
    """Every k up to N goes to the one entry (the ring holds lists in
    registers, shared memory or device memory by k)."""
    n, d = 8192, 256
    queries, xp, xs, bias = _inputs(8, n, d)
    topk_int4_pruned(queries, xp, xs, bias, k)
    (launch,) = card.launches
    assert launch["entry"] == "topk_pruned_int4" and _named(launch)["k"] == k
    cand = T._list_ctas(min(2 * SMS, n // T._IDENTITY_ROWS_PER_CTA), 8, k)
    assert _named(launch)["n_cta"] == cand


def test_int4_wrapper_raises_on_a_launch_error(card):
    """A refused launch raises with the CUDA error's text, counts no launch
    and falls back to nothing (the plain version refuses to run here)."""
    queries, xp, xs, bias = _inputs(3, 4096, 256)
    card.err = 700
    with pytest.raises(RuntimeError, match=r"topk_pruned_int4 failed: CUDA error 700 "
                                           r"\(an injected error\)"):
        topk_int4_pruned(queries, xp, xs, bias, 5)
    assert topk_int4_pruned.launches == card.before


@pytest.mark.parametrize("bad", ["width", "k", "dtype", "scales"])
def test_int4_wrapper_checks_before_it_launches(card, bad):
    """Out-of-contract calls raise before any launch: a packed width that
    is not a multiple of 128, k outside 1..N, a database that is not int8,
    scales of the wrong length."""
    queries, xp, xs, bias = _inputs(2, 512, 256)
    k = 5
    if bad == "width":
        queries, xp = queries[:, :192], xp[:, :96].contiguous()
    elif bad == "k":
        k = 513
    elif bad == "dtype":
        xp = xp.to(torch.int16)
    else:
        xs = xs[:-1]
    with pytest.raises(ValueError):
        topk_int4_pruned(queries, xp, xs, bias, k)
    assert not card.launches


def test_int4_entry_is_typed_with_the_ring(card):
    """The int4 entry is one of the ring library's, typed like the others
    (``test_torch_topk_merged.py::test_ring_library_types_every_entry``)."""
    assert T._TMA_ENTRY["topk_int4_pruned"] == "topk_pruned_int4"
    lib = T._tma_library("topk_pruned_int4")
    assert len(lib.topk_pruned_int4_launch.argtypes) == len(ARG_NAMES)
