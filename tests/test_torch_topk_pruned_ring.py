"""The host side of the brute bf16 and int8 scans on the card, without a card.

``ops/topk.py::topk_pruned`` and ``topk_int8_pruned`` on CUDA tensors
launch the ring's ``topk_pruned_bf16`` (``csrc/ivf_topk_bf16.cu``) and
``topk_pruned_int8`` (``csrc/ivf_topk_int8.cu``) entries through
``_launch_tma``: the DMA kernels over the identity plan (no plan tensor,
one block of all n rows), which cast or quantize the queries, scan, select
and merge in one kernel after a memset. Here the CUDA branch runs on CPU
tensors against a stand-in library that records each launch's arguments,
so these tests hold what the wrapper hands the kernel: the entry, the null
plan, one block of n rows, the queries as the caller gave them (no cast or
quantization on the host), one launch per 64 queries, the launch count, an
error raised, never a fallback, and out-of-contract calls refused before
any launch. The kernels themselves are held on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import importlib
import types

import pytest
import torch

from youtu_rag_tpu_torch.ops import _build
from youtu_rag_tpu_torch.ops.topk import quantize_rows_int8, topk_int8_pruned, topk_pruned

# by its path: youtu_rag_tpu_torch.ops.topk is also the name of a function
T = importlib.import_module("youtu_rag_tpu_torch.ops.topk")
from test_torch_topk_merged import ARG_NAMES, SMS, _FakeRing, _named  # noqa: E402

WRAPPERS = {"bf16": topk_pruned, "int8": topk_int8_pruned}


@pytest.fixture
def card(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors: the stand-in ring library,
    an H100's SM count, no stream, and every host-side query preparation and
    plain version made to raise."""
    fake = _FakeRing()
    monkeypatch.setattr(_build, "load",
                        lambda name: fake if name in T._TMA_LIB.values() else None)
    monkeypatch.setattr(T, "_device_of", lambda name, *tensors: "cuda")
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=SMS))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))

    def refused(*args, **kwargs):
        raise AssertionError("the CUDA branch prepared the queries on the host or ran the "
                             "plain version")

    for name in ("quantize_rows_int8", "_kernel_queries", "topk_pruned_reference",
                 "topk_int8_pruned_reference", "_scaled_topk", "_sorted_topk"):
        monkeypatch.setattr(T, name, refused)
    T.scan_plan.cache_clear()
    T._tma_ctas_per_sm.cache_clear()
    fake.before = {tier: fn.launches for tier, fn in WRAPPERS.items()}
    yield fake
    for tier, fn in WRAPPERS.items():
        fn.launches = fake.before[tier]
    T.scan_plan.cache_clear()
    T._tma_ctas_per_sm.cache_clear()


def _inputs(tier, qn, n, d, seed=0):
    """(queries f32, the stored rows and their scales as the wrapper takes
    them, bias)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g)
    stored = (x.to(torch.bfloat16),) if tier == "bf16" else quantize_rows_int8(x)
    return torch.randn(qn, d, generator=g), stored, torch.zeros(n)


def _launched(card, tier):
    return WRAPPERS[tier].launches - card.before[tier]


@pytest.mark.parametrize("tier", ["bf16", "int8"])
@pytest.mark.parametrize("n", [262144, 4099, 63, 7, 1])
@pytest.mark.parametrize("qn, launches", [(1, 1), (64, 1), (65, 2), (130, 3)])
def test_pruned_wrapper_launches_the_identity_entry_per_64_queries(card, tier, qn, launches,
                                                                    n):
    """One topk_pruned_<tier> launch per 64 queries: the plan pointers null,
    one block of all n rows (block_rows = n divides n, odd n and n below a
    32-row stage included), the grid one wave split over the tile's 8-query
    groups (at most one CTA per 128 rows: one ring fill), results [q, k]."""
    d, k = 256, min(15, n)
    queries, stored, bias = _inputs(tier, qn, n, d)
    s, i = WRAPPERS[tier](queries, *stored, bias, k)
    assert _launched(card, tier) == launches and len(card.launches) == launches
    assert tuple(s.shape) == tuple(i.shape) == (qn, k)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    for t, launch in enumerate(card.launches):
        a = _named(launch)
        tile_q = min(64, qn - 64 * t)
        tiles = -(-tile_q // 8)
        assert launch["entry"] == f"topk_pruned_{tier}"
        assert a["ids"] is None and a["n_valid"] is None
        assert (a["q"], a["n"], a["d"], a["k"]) == (tile_q, n, d, k)
        assert a["block_rows"] == n and a["max_blocks"] == 1
        assert a["n_cta"] == max(1, min(2 * SMS // tiles, -(-n // 128)))
        assert a["x"] == stored[0].data_ptr() and a["bias"] == bias.data_ptr()
        assert a["xscale"] == (None if tier == "bf16" else stored[1].data_ptr())


@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_pruned_wrapper_passes_the_queries_unprepared(card, tier):
    """The kernel casts (bf16) or quantizes (int8) the queries: the wrapper
    hands it each tile's f32 rows in place (queries_bf16 0). The bf16 entry
    also takes bf16 queries as they are (queries_bf16 1); other float types
    are cast to what the entry reads (bf16 entry: bf16, int8 entry: f32),
    and never quantized on the host."""
    n, d = 4096, 512
    queries, stored, bias = _inputs(tier, 70, n, d)
    WRAPPERS[tier](queries, *stored, bias, 5)
    first, second = (_named(launch) for launch in card.launches)
    assert first["queries"] == queries.data_ptr()
    assert second["queries"] == queries[64:].data_ptr()
    assert first["queries_bf16"] == second["queries_bf16"] == 0
    q16 = queries[:3].to(torch.bfloat16)
    WRAPPERS[tier](q16, *stored, bias, 5)
    a = _named(card.launches[-1])
    if tier == "bf16":
        assert a["queries"] == q16.data_ptr() and a["queries_bf16"] == 1
    else:
        assert a["queries"] != q16.data_ptr() and a["queries_bf16"] == 0
    for dtype in (torch.float16, torch.float64):
        WRAPPERS[tier](queries[:3].to(dtype), *stored, bias, 5)
        assert _named(card.launches[-1])["queries_bf16"] == int(tier == "bf16")


@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_pruned_wrapper_counts_nothing_without_queries(card, tier):
    """No query: an empty [0, k] result and no launch."""
    _, stored, bias = _inputs(tier, 1, 1024, 256)
    s, i = WRAPPERS[tier](torch.empty(0, 256), *stored, bias, 4)
    assert tuple(s.shape) == tuple(i.shape) == (0, 4)
    assert not card.launches and _launched(card, tier) == 0


@pytest.mark.parametrize("tier", ["bf16", "int8"])
@pytest.mark.parametrize("k", [1, 32, 64, 128, 1024, 2048, 8192])
def test_pruned_wrapper_takes_the_ring_at_every_k(card, tier, k):
    """Every k up to N goes to the one entry (the ring holds lists in
    registers, shared memory or device memory by k; above k = 1024 fewer
    CTAs bound the device lists)."""
    n, d = 8192, 256
    queries, stored, bias = _inputs(tier, 8, n, d)
    WRAPPERS[tier](queries, *stored, bias, k)
    (launch,) = card.launches
    assert launch["entry"] == f"topk_pruned_{tier}" and _named(launch)["k"] == k
    assert _named(launch)["n_cta"] == T._list_ctas(min(2 * SMS, n // 128), 8, k)


@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_pruned_wrapper_raises_on_a_launch_error(card, tier):
    """A refused launch raises with the CUDA error's text, counts no launch
    and falls back to nothing (the plain versions refuse to run here)."""
    queries, stored, bias = _inputs(tier, 3, 4096, 256)
    card.err = 700
    with pytest.raises(RuntimeError, match=rf"topk_pruned_{tier} failed: CUDA error 700 "
                                           r"\(an injected error\)"):
        WRAPPERS[tier](queries, *stored, bias, 5)
    assert _launched(card, tier) == 0


@pytest.mark.parametrize("tier", ["bf16", "int8"])
@pytest.mark.parametrize("bad", ["width", "k", "k0", "dtype", "queries", "bias", "scales"])
def test_pruned_wrapper_checks_before_it_launches(card, tier, bad):
    """Out-of-contract calls raise before any launch: a width that is not a
    multiple of 128, k outside 1..N, a database of the other tier's type,
    queries of another width, a bias or scales of the wrong length."""
    queries, stored, bias = _inputs(tier, 2, 512, 256)
    k = 5
    if bad == "width":
        queries = queries[:, :192]
        stored = (stored[0][:, :192].contiguous(), *stored[1:])
    elif bad == "k":
        k = 513
    elif bad == "k0":
        k = 0
    elif bad == "dtype":
        stored = ((stored[0].to(torch.int8) if tier == "bf16" else stored[0].to(torch.bfloat16)),
                  *stored[1:])
    elif bad == "queries":
        queries = queries[:, :128]
    elif bad == "bias":
        bias = bias[:-1]
    elif tier == "int8":
        stored = (stored[0], stored[1][:-1])
    else:  # a bf16 index has no scales: a float32 database is refused
        stored = (stored[0].float(),)
    with pytest.raises(ValueError):
        WRAPPERS[tier](queries, *stored, bias, k)
    assert not card.launches


def test_pruned_entries_are_typed_with_their_tiers_rings(card):
    """Each entry is one of its tier's ring library's, typed like the others
    (``test_torch_topk_merged.py::test_ring_library_types_every_entry``)."""
    for tier in ("bf16", "int8"):
        entry = f"topk_pruned_{tier}"
        assert T._TMA_ENTRY[WRAPPERS[tier].__name__] == entry
        assert T._TMA_LIB[entry] == f"ivf_topk_{tier}"
        lib = T._tma_library(entry)
        assert len(getattr(lib, f"{entry}_launch").argtypes) == len(ARG_NAMES)
