"""The host side of the merged per-block calls on the card, without a card.

``ops/topk.py::_launch_tma`` launches an entry of the ring
(``csrc/ivf_topk_<tier>.cu``): the IVF wrappers' with their probe plan,
``topk`` / ``topk_int8`` merged with
the identity plan (no plan tensor: every block, in order). Here the
library is a stand-in that records each launch's arguments, so these tests
hold what the wrapper hands the kernel: the entry, the null plan, the
block count, the grid, the buffers, one launch per 64 queries, the launch
count, and an error raised, never a fallback. The kernels themselves are
held on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import ctypes
import importlib
import types

import pytest
import torch

from youtu_rag_tpu_torch.ops import _build
from youtu_rag_tpu_torch.ops.ivf import ivf_topk_int8
from youtu_rag_tpu_torch.ops.topk import quantize_rows_int8, topk, topk_int8

# by its path: youtu_rag_tpu_torch.ops.topk is also the name of a function
T = importlib.import_module("youtu_rag_tpu_torch.ops.topk")

SMS = 132  # an H100 SXM's


class _Entry:
    """A C entry: ctypes' argtypes and restype are plain attributes."""

    def __init__(self, fn):
        self.fn, self.argtypes, self.restype = fn, None, None

    def __call__(self, *args):
        return self.fn(*args)


class _FakeRing:
    """The ring's libraries as the wrapper sees them: every entry's plan
    (32 rows x 4 stages, lists in shared memory), 2 CTAs an SM, and
    launches recorded as {"entry", "args"}, returning ``self.err``."""

    def __init__(self):
        self.launches, self.err = [], 0
        self.ivf_topk_error_string = _Entry(lambda err: b"an injected error")
        for entry in set(T._TMA_ENTRY.values()):
            setattr(self, f"{entry}_launch", _Entry(
                lambda *a, entry=entry: self.launches.append({"entry": entry, "args": a})
                or self.err))
            setattr(self, f"{entry}_ctas_per_sm", _Entry(lambda d, k: 2))
            setattr(self, f"{entry}_plan", _Entry(self._plan))

    @staticmethod
    def _plan(d, k, out):
        for i, v in enumerate((32, 4, 0, 0)):
            out[i] = v
        return 0


@pytest.fixture
def ring(monkeypatch):
    fake = _FakeRing()
    monkeypatch.setattr(_build, "load",
                        lambda name: fake if name in T._TMA_LIB.values() else None)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=SMS))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    T.scan_plan.cache_clear()
    T._tma_ctas_per_sm.cache_clear()
    counts = (topk.launches, topk_int8.launches, ivf_topk_int8.launches)
    yield fake
    topk.launches, topk_int8.launches, ivf_topk_int8.launches = counts
    T.scan_plan.cache_clear()
    T._tma_ctas_per_sm.cache_clear()


# the launch's arguments, in the ring's entries' order
ARG_NAMES = ("queries", "queries_bf16", "x", "xscale", "bias", "ids", "n_valid", "cand_s",
             "cand_i", "counter", "out_s", "out_i", "q", "n", "d", "k", "max_blocks",
             "block_rows", "n_cta", "stream")


def _named(launch):
    assert len(launch["args"]) == len(ARG_NAMES)
    return dict(zip(ARG_NAMES, launch["args"]))


def _inputs(qn, n, d, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g)
    return torch.randn(qn, d, generator=g), x, torch.zeros(n)


@pytest.mark.parametrize("qn, launches", [(1, 1), (64, 1), (130, 3)])
@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_merged_call_launches_the_identity_entry_per_64_queries(ring, tier, qn, launches):
    """topk / topk_int8 merged: the topk_merged entry once per 64 queries,
    the plan pointers null, max_blocks = N / block_rows, the grid one wave
    split over the tile's 8-query groups (at most one CTA per 128 rows: one
    ring fill; a probe plan's 512),
    the CTAs' lists [tiles, n_cta, 8, k rounded up to 4], results [q, k]."""
    n, d, k, br = 65536, 128, 10, 2048
    queries, x, bias = _inputs(qn, n, d)
    fn = topk if tier == "bf16" else topk_int8
    if tier == "bf16":
        stored, scales = x.to(torch.bfloat16), None
    else:
        stored, scales = quantize_rows_int8(x)
    before = fn.launches
    s, i = T._ring_tiles(fn, queries, stored, scales, bias, k, d, n, br)
    assert fn.launches == before + launches and len(ring.launches) == launches
    assert tuple(s.shape) == tuple(i.shape) == (qn, k)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    for t, launch in enumerate(ring.launches):
        a = _named(launch)
        tile_q = min(64, qn - 64 * t)
        tiles = -(-tile_q // 8)
        assert launch["entry"] == f"topk_merged_{tier}"
        assert a["ids"] is None and a["n_valid"] is None
        assert (a["q"], a["n"], a["d"], a["k"]) == (tile_q, n, d, k)
        assert (a["max_blocks"], a["block_rows"]) == (n // br, br)
        assert a["n_cta"] == min(2 * SMS // tiles, n // T._IDENTITY_ROWS_PER_CTA)
        assert a["queries_bf16"] == 0 and a["x"] == stored.data_ptr()
        assert (a["xscale"] is None) == (tier == "bf16")


def test_merged_call_keeps_bf16_queries_and_casts_others(ring):
    """The bf16 entry takes f32 or bf16 queries as given (the kernel rounds
    f32 ones); f16 queries are cast to bf16 first."""
    n, d = 4096, 128
    queries, x, bias = _inputs(3, n, d)
    xb = x.to(torch.bfloat16)
    for dtype, flag in ((torch.float32, 0), (torch.bfloat16, 1), (torch.float16, 1)):
        T._ring_tiles(topk, queries.to(dtype), xb, None, bias, 5, d, n, 1024)
        assert _named(ring.launches[-1])["queries_bf16"] == flag


def test_probe_plan_call_passes_its_plan(ring):
    """The same launcher for ivf_topk_int8 merged: its entry, the plan's
    pointers and max_blocks = the listed blocks."""
    n, d, br = 4096, 128, 256
    queries, x, bias = _inputs(8, n, d)
    xq, xs = quantize_rows_int8(x)
    ids = torch.tensor([3, 0, 7, 1, 2], dtype=torch.int32)
    nv = torch.tensor([3], dtype=torch.int32)
    T._ring_tiles(ivf_topk_int8, queries, xq, xs, bias, 10, d, n, br, ids, nv)
    a = _named(ring.launches[-1])
    assert ring.launches[-1]["entry"] == "ivf_blocks_int8"
    assert (a["ids"], a["n_valid"], a["max_blocks"]) == (ids.data_ptr(), nv.data_ptr(), 5)
    assert a["n_cta"] == -(-5 * br // 512)


def test_merged_call_raises_on_a_launch_error(ring):
    """A refused launch raises with the CUDA error's text, counts no launch
    and falls back to nothing."""
    n, d = 4096, 128
    queries, x, bias = _inputs(3, n, d)
    ring.err = 1
    before = topk.launches
    with pytest.raises(RuntimeError, match="topk_merged_bf16 failed: CUDA error 1 "
                                           r"\(an injected error\)"):
        T._ring_tiles(topk, queries, x.to(torch.bfloat16), None, bias, 5, d, n, 1024)
    assert topk.launches == before


def test_ring_library_types_every_entry(ring):
    """Every entry's launch takes 20 arguments, pointers as c_void_p (a
    64-bit pointer passed as a C int would be cut), in the library of its
    tier (one source per tier)."""
    assert {"topk_merged_bf16", "topk_merged_int8", "topk_pruned_bf16", "topk_pruned_int8",
            "topk_pruned_int4"} <= set(T._TMA_ENTRY.values())
    for entry in set(T._TMA_ENTRY.values()):
        assert T._TMA_LIB[entry] == "ivf_topk_" + entry.rsplit("_", 1)[1]
        types_ = getattr(T._tma_library(entry), f"{entry}_launch").argtypes
        assert len(types_) == len(ARG_NAMES)
        for name, t in zip(ARG_NAMES, types_):
            want = ctypes.c_int if name in ("queries_bf16", "q", "n", "d", "k", "max_blocks",
                                            "block_rows", "n_cta") else ctypes.c_void_p
            assert t is want, (entry, name)
