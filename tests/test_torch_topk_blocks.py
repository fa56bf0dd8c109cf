"""The port's per-block top-k family, its XLA paths and ``fused_topk``
against the JAX package's, on the CPU.

The same numpy inputs go through the JAX functions (the Pallas kernels in
interpret mode) and through the port's counterparts on CPU tensors, which
run their plain PyTorch versions:

- ``topk`` / ``topk_int8`` / ``ivf_topk`` / ``ivf_topk_int8`` against
  ``pallas_topk`` / ``pallas_topk_int8`` / ``pallas_ivf_topk`` /
  ``pallas_ivf_topk_int8``; ``xla_topk*`` and ``xla_ivf_topk`` against
  theirs; ``fused_topk`` per backend name;
- every slot must hold the same row, the slots no live row fills included:
  they repeat ``_select_topk``'s pick (a block's lowest row scoring
  ``>= NEG_INF``, ``ids[0] * block_rows`` for a plan, ``-inf`` first for a
  block that scores ``-inf`` throughout), in candidate position order;
- bf16 scores within 1e-5 (unit vectors, f32 sums in another order), int8
  bit-equal (exact integer dots, the same op-by-op f32 epilogue).
"""

import importlib
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import youtu_rag_tpu.ops as jax_ops
from youtu_rag_tpu.ops import ivf as jax_ivf
from youtu_rag_tpu.ops import topk as jax_topk
from youtu_rag_tpu_torch import ops as port_ops
from youtu_rag_tpu_torch.ops.ivf import (
    ivf_topk,
    ivf_topk_int8,
    ivf_topk_int8_reference,
    ivf_topk_reference,
    xla_ivf_topk,
)
from youtu_rag_tpu_torch.ops.topk import (
    NEG_INF,
    fused_topk,
    merge_blocks,
    quantize_rows_int4,
    topk,
    topk_int8,
    topk_int8_reference,
    topk_reference,
    xla_topk,
    xla_topk_int4,
    xla_topk_int8,
)

sys.path.insert(0, os.path.dirname(__file__))
from torch_ivf_cases import IVF_CASES, make_inputs  # noqa: E402

TOL = 1e-5


def quantized(x):
    return tuple(np.asarray(a) for a in jax_topk.quantize_rows_int8(jnp.asarray(x)))


def assert_same(got, want, tier):
    gs, gi = (t.numpy() for t in got)
    ws, wi = (np.asarray(a) for a in want)
    assert gs.dtype == np.float32 and gi.dtype == np.int32
    assert gs.shape == ws.shape and gi.shape == wi.shape
    np.testing.assert_array_equal(gi, wi)
    if tier == "int8":
        np.testing.assert_array_equal(gs.view(np.uint32), ws.view(np.uint32))
    else:
        np.testing.assert_allclose(gs, ws, rtol=0, atol=TOL)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def brute_pair(tier, qs, x, bias, k, block_rows):
    """(port, jax) results of the per-block brute kernel of ``tier``."""
    if tier == "bf16":
        got = topk(t(qs), t(x).to(torch.bfloat16), t(bias), k, block_rows=block_rows)
        want = jax_topk.pallas_topk(jnp.asarray(qs), jnp.asarray(x, jnp.bfloat16), jnp.asarray(bias),
                                    k, block_rows=block_rows, interpret=True)
    else:
        xq, xs = quantized(x)
        got = topk_int8(t(qs), t(xq), t(xs), t(bias), k, block_rows=block_rows)
        want = jax_topk.pallas_topk_int8(jnp.asarray(qs), jnp.asarray(xq), jnp.asarray(xs),
                                         jnp.asarray(bias), k, block_rows=block_rows,
                                         interpret=True)
    return got, want


def ivf_pair(tier, qs, x, bias, ids, n_valid, k, block_rows):
    """(port, jax) results of the per-probed-block kernel of ``tier``."""
    tids, tnv = torch.tensor(ids, dtype=torch.int32), torch.tensor(n_valid, dtype=torch.int32)
    jids, jnv = jnp.asarray(ids, jnp.int32), jnp.int32(n_valid)
    if tier == "bf16":
        got = ivf_topk(t(qs), t(x).to(torch.bfloat16), t(bias), tids, tnv, k,
                       block_rows=block_rows)
        want = jax_ivf.pallas_ivf_topk(jnp.asarray(qs), jnp.asarray(x, jnp.bfloat16),
                                       jnp.asarray(bias), jids, jnv, k, block_rows=block_rows,
                                       interpret=True)
    else:
        xq, xs = quantized(x)
        got = ivf_topk_int8(t(qs), t(xq), t(xs), t(bias), tids, tnv, k, block_rows=block_rows)
        want = jax_ivf.pallas_ivf_topk_int8(jnp.asarray(qs), jnp.asarray(xq), jnp.asarray(xs),
                                            jnp.asarray(bias), jids, jnv, k,
                                            block_rows=block_rows, interpret=True)
    return got, want


# ---------------------------------------------------------------------------
# the per-block brute kernels (pallas_topk, pallas_topk_int8)
# ---------------------------------------------------------------------------

# (kind, q, d, n, block_rows, k)
BRUTE_CASES = {
    "mixed-k10": ("mixed", 3, 128, 1024, 256, 10),
    "mixed-k1-default-width": ("mixed", 8, 256, 2048, 1024, 1),
    "mixed-k128": ("mixed", 1, 128, 1024, 256, 128),
    "dead-rows": ("dead", 3, 128, 1024, 256, 10),
    "allinf-block0-k32": ("allinf0", 3, 128, 1024, 256, 32),
    "allinf-block0-k128": ("allinf0", 2, 128, 1024, 256, 128),
    "no-live-row": ("none", 2, 128, 1024, 256, 10),
    "ties-across-blocks": ("ties", 3, 128, 1024, 256, 10),
}


@pytest.mark.parametrize("tier", ["bf16", "int8"])
@pytest.mark.parametrize("case", list(BRUTE_CASES))
def test_brute_blocks_match_pallas(tier, case):
    kind, q, d, n, block_rows, k = BRUTE_CASES[case]
    qs, x, bias = make_inputs(q, d, n, kind, seed=len(case))
    got, want = brute_pair(tier, qs, x, bias, k, block_rows)
    assert_same(got, want, tier)
    gs, gi = (a.numpy() for a in got)
    if kind == "dead":  # block 0's lowest row >= NEG_INF is row 3
        assert (gi[:, 3:] == 3).all() and (gs[:, 3:] == NEG_INF).all()
    if kind == "allinf0":  # block 0 lists (-inf, 0), then (NEG_INF, 0): those come first
        assert (gi[:, 2:] == 0).all() and (gs[:, 2:] == NEG_INF).all()
    if kind == "ties":
        assert gi[0, :5].tolist() == [20, 300, 600, 700, 900]


def test_default_block_rows_are_jax_defaults():
    """topk 1024 and topk_int8 2048, as pallas_topk and pallas_topk_int8."""
    qs, x, bias = make_inputs(2, 128, 4096, "mixed", seed=3)
    xq, xs = quantized(x)
    cand = topk(t(qs), t(x), t(bias), 10, candidates=True)[0]
    cand8 = topk_int8(t(qs), t(xq), t(xs), t(bias), 10, candidates=True)[0]
    assert cand.shape == (4, 2, 128) and cand8.shape == (2, 2, 128)
    assert_same(topk_int8(t(qs), t(xq), t(xs), t(bias), 10),
                jax_topk.pallas_topk_int8(jnp.asarray(qs), jnp.asarray(xq), jnp.asarray(xs),
                                          jnp.asarray(bias), 10, interpret=True), "int8")


@pytest.mark.parametrize("k", [10, 128, 129])
def test_candidates_pad_to_k_pad_and_merge_to_the_result(k):
    qs, x, bias = make_inputs(3, 128, 1024, "dead", seed=k)
    cs, ci = topk_reference(t(qs), t(x), t(bias), k, block_rows=256, candidates=True)
    k_pad = -(-k // 128) * 128
    assert cs.shape == ci.shape == (4, 3, k_pad) and ci.dtype == torch.int32
    assert (cs[..., k:] == NEG_INF).all() and (ci[..., k:] == 0).all()
    # each block's fill is its own lowest row scoring >= NEG_INF
    assert (ci[0, :, :k] == 3).all() and (ci[1, :, 2:k] == 256).all()
    assert (cs[0, :, :k] == NEG_INF).all() and (cs[1, :, 2:k] == NEG_INF).all()
    s, i = merge_blocks(cs, ci, k)
    ws, wi = topk_reference(t(qs), t(x), t(bias), k, block_rows=256)
    assert torch.equal(s, ws) and torch.equal(i, wi)


@pytest.mark.parametrize("k", [32, 128])
def test_a_block_scoring_minus_inf_lists_minus_inf_first(k):
    """Block 0 scores -inf throughout: _select_topk's first pick is
    (-inf, 0), and it overwrites column 0 with NEG_INF, so every later pick
    is (NEG_INF, 0). The merge puts those NEG_INF slots before the -inf."""
    qs, x, bias = make_inputs(2, 128, 1024, "allinf0", seed=k)
    xq, xs = quantized(x)
    for cs, ci in (topk_reference(t(qs), t(x), t(bias), k, block_rows=256, candidates=True),
                   topk_int8_reference(t(qs), t(xq), t(xs), t(bias), k, block_rows=256,
                                       candidates=True)):
        assert np.isneginf(cs[0, :, 0].numpy()).all() and (ci[0, :, :k] == 0).all()
        assert (cs[0, :, 1:] == NEG_INF).all()
        s, i = merge_blocks(cs, ci, k)
        assert (s[:, 2:] == NEG_INF).all() and (i[:, 2:] == 0).all()


# ---------------------------------------------------------------------------
# the per-probed-block IVF kernels (pallas_ivf_topk, pallas_ivf_topk_int8)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tier", ["bf16", "int8"])
@pytest.mark.parametrize("case", list(IVF_CASES))
def test_ivf_blocks_match_pallas(tier, case):
    """The merged result of every case of ``torch_ivf_cases.IVF_CASES``
    (shared with the GPU tests), slot for slot, the tail included."""
    kind, ids, n_valid, block_rows, k, q, n = IVF_CASES[case]
    qs, x, bias = make_inputs(q, 128, n, kind, seed=len(case))
    got, want = ivf_pair(tier, qs, x, bias, ids, n_valid, k, block_rows)
    assert_same(got, want, tier)
    gs, gi = (a.numpy() for a in got)
    if case == "dead-fill-ids0":  # 3 live rows; block 1 listed first: row 1 * 256 fills
        assert (gi[:, 3:] == 256).all() and (gs[:, 3:] == NEG_INF).all()
    if case == "dead-fill-shuffled":  # 2 live rows; block 3 listed first: row 768 fills
        assert (gi[:, 2:] == 768).all() and (gs[:, 2:] == NEG_INF).all()
    if case == "empty-plan":
        assert (gs == NEG_INF).all() and (gi == ids[0] * block_rows).all()
    if kind == "allinf0":  # block 0 lists (-inf, 0), then (NEG_INF, 0): those come first
        assert (gi[:, 2:] == 0).all() and (gs[:, 2:] == NEG_INF).all()
    if case == "ties-probe-order":  # blocks 3, 1, 0, 2: rows 900, 300, 20, 600, 700
        assert gi[0, :5].tolist() == [900, 300, 20, 600, 700]
    if case == "rows4-ties-full":  # the first four tied rows in probe order
        order = sorted((20, 300, 600, 700, 900), key=lambda r: ids.index(r // 4))
        assert gi[0, :4].tolist() == order[:4]
    if case == "duplicates-past-n-valid":  # 3 live rows; block 5 listed first fills
        assert (gi[:, 3:] == 640).all() and (gs[:, 3:] == NEG_INF).all()
    if kind == "allinf0-dead":  # no live row: block 0's (NEG_INF, 0), then the last slot
        assert (gi[:, : k - 1] == 0).all() and (gs[:, : k - 1] == NEG_INF).all()
        last = {"allinf-block0-dead-k128": (NEG_INF, 259),  # position 1 = block 1, column 3
                "allinf-block0-dead-nv1-k128": (NEG_INF, 768),  # position 1 = block 3, unread
                "allinf-block0-dead-single": (-np.inf, 0),  # block 0's own -inf entry
                "allinf-block0-dead-k10": (NEG_INF, 0)}[case]  # the pad
        assert (gs[:, -1] == last[0]).all() and (gi[:, -1] == last[1]).all()


def test_ivf_reference_leaves_blocks_past_n_valid_unread():
    """A position past n_valid is never read: an out-of-range id there
    only shows in its fill, as the kernel's."""
    qs, x, bias = make_inputs(2, 128, 1024, "mixed", seed=1)
    ids = torch.tensor([2, 1 << 20, 5], dtype=torch.int32)
    cs, ci = ivf_topk_reference(t(qs), t(x), t(bias), ids, torch.tensor(1, dtype=torch.int32),
                                10, block_rows=128, candidates=True)
    assert cs.shape == (3, 2, 128)
    assert (cs[1:, :, :10] == NEG_INF).all()
    assert (ci[1, :, :10] == (1 << 20) * 128).all() and (ci[2, :, :10] == 5 * 128).all()
    xq, xs = quantized(x)
    cs8, _ = ivf_topk_int8_reference(t(qs), t(xq), t(xs), t(bias), ids,
                                     torch.tensor(1, dtype=torch.int32), 10, block_rows=128,
                                     candidates=True)
    assert (cs8[1:, :, :10] == NEG_INF).all()


# ---------------------------------------------------------------------------
# the XLA paths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind, k", [("mixed", 10), ("dead", 10), ("ties", 5), ("none", 3)])
def test_xla_topk_matches_jax(kind, k):
    qs, x, bias = make_inputs(4, 128, 1024, kind, seed=k)
    got = xla_topk(t(qs), t(x).to(torch.bfloat16), t(bias), k)
    assert_same(got, jax_topk.xla_topk(jnp.asarray(qs), jnp.asarray(x, jnp.bfloat16),
                                       jnp.asarray(bias), k), "bf16")


@pytest.mark.parametrize("kind, k", [("mixed", 10), ("dead", 10), ("ties", 5)])
def test_xla_topk_int8_matches_jax(kind, k):
    qs, x, bias = make_inputs(4, 128, 1024, kind, seed=k)
    xq, xs = quantized(x)
    got = xla_topk_int8(t(qs), t(xq), t(xs), t(bias), k)
    assert_same(got, jax_topk.xla_topk_int8(jnp.asarray(qs), jnp.asarray(xq), jnp.asarray(xs),
                                            jnp.asarray(bias), k), "int8")


@pytest.mark.parametrize("kind, k", [("mixed", 10), ("dead", 10)])
def test_xla_topk_int4_matches_jax(kind, k):
    qs, x, bias = make_inputs(4, 256, 1024, kind, seed=k)
    xp, xs = (np.asarray(a) for a in jax_topk.quantize_rows_int4(jnp.asarray(x)))
    np.testing.assert_array_equal(quantize_rows_int4(t(x))[0].numpy(), xp)
    got = xla_topk_int4(t(qs), t(xp), t(xs), t(bias), k)
    want = jax_topk.xla_topk_int4(jnp.asarray(qs), jnp.asarray(xp), jnp.asarray(xs),
                                  jnp.asarray(bias), k)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # XLA on the CPU may contract the f32 epilogue into an FMA (1e-5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=TOL)


@pytest.mark.parametrize("kind, ids, n_valid, k", [
    ("mixed", [1, 2, 5, 0, 3, 4, 6, 7], 3, 10), ("dead", [3, 1, 0, 2, 4, 5, 6, 7], 2, 10),
    ("ties", [7, 5, 2, 0, 1, 3, 4, 6], 4, 5), ("mixed", [0, 1, 2, 3, 4, 5, 6, 7], 0, 4)])
def test_xla_ivf_topk_matches_jax(kind, ids, n_valid, k):
    qs, x, bias = make_inputs(3, 128, 1024, kind, seed=n_valid)
    got = xla_ivf_topk(t(qs), t(x).to(torch.bfloat16), t(bias),
                       torch.tensor(ids, dtype=torch.int32), torch.tensor(n_valid, dtype=torch.int32),
                       k, block_rows=128)
    want = jax_ivf.xla_ivf_topk(jnp.asarray(qs), jnp.asarray(x, jnp.bfloat16), jnp.asarray(bias),
                                jnp.asarray(ids, jnp.int32), jnp.int32(n_valid), k, block_rows=128)
    assert_same(got, want, "bf16")


# ---------------------------------------------------------------------------
# fused_topk and the ops surface
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend, q, kind", [
    ("auto", 3, "mixed"), ("xla", 3, "dead"), ("pallas_interpret", 3, "dead"),
    ("pallas_interpret", 70, "mixed"), ("pallas", 3, "ties"), ("pallas", 100, "dead")])
def test_fused_topk_matches_jax_backend(backend, q, kind):
    """Each backend name against JAX's. JAX's "pallas" runs on a TPU only
    (on the CPU it raises); the port's "pallas" runs the kernel on CUDA
    tensors and its plain version on CPU ones, so it is held to JAX's
    "pallas_interpret". q above 64 goes through the 64-query tiling."""
    qs, x, bias = make_inputs(q, 128, 4096, kind, seed=q)
    got = fused_topk(t(qs), t(x).to(torch.bfloat16), t(bias), 10, block_rows=1024, backend=backend)
    args = (jnp.asarray(qs), jnp.asarray(x, jnp.bfloat16), jnp.asarray(bias), 10)
    if backend == "pallas":
        with pytest.raises(ValueError, match="interpret"):
            jax_topk.fused_topk(*args, block_rows=1024, backend="pallas")
        backend = "pallas_interpret"
    assert_same(got, jax_topk.fused_topk(*args, block_rows=1024, backend=backend), "bf16")


def test_fused_topk_auto_takes_xla_on_the_cpu_and_rejects_unknown_backends():
    qs, x, bias = make_inputs(2, 128, 4096, "mixed", seed=0)
    args = (t(qs), t(x).to(torch.bfloat16), t(bias), 10)
    before = topk.launches
    auto, xla = fused_topk(*args, block_rows=256), xla_topk(*args)
    assert torch.equal(auto[0], xla[0]) and torch.equal(auto[1], xla[1])
    assert topk.launches == before  # CPU tensors: plain versions, no launch counted
    with pytest.raises(ValueError, match="unknown backend"):
        fused_topk(*args, backend="triton")
    with pytest.raises(ValueError):
        jax_topk.fused_topk(jnp.asarray(qs), jnp.asarray(x), jnp.asarray(bias), 10,
                            backend="triton")


def test_ops_exports_the_jax_ops_surface():
    """Every name of the JAX ops package has its counterpart (its
    ``pallas_*`` kernels without the prefix)."""
    renamed = {"pallas_topk": "topk", "pallas_topk_pruned": "topk_pruned"}
    for name in jax_ops.__all__:
        port_name = renamed.get(name, name)
        assert port_name in port_ops.__all__, name
        assert callable(getattr(port_ops, port_name)) or port_name == "NEG_INF"
    assert port_ops.NEG_INF == jax_ops.NEG_INF
    assert port_ops.topk is topk  # the function; the module stays importable by its path
    assert importlib.import_module("youtu_rag_tpu_torch.ops.topk").topk is topk


@pytest.mark.parametrize("fn", ["topk", "topk_int8", "ivf_topk", "ivf_topk_int8"])
def test_per_block_wrappers_refuse_what_jax_asserts(fn):
    qs, x, bias = make_inputs(2, 128, 1024, "mixed", seed=0)
    xq, xs = quantized(x)
    ids, nv = torch.tensor([0, 1], dtype=torch.int32), torch.tensor(2, dtype=torch.int32)

    def call(k, block_rows, width=128):
        q, rows = t(qs[:, :width]), (t(x[:, :width]) if "int8" not in fn else t(xq[:, :width]))
        extra = () if "int8" not in fn else (t(xs),)
        plan = (ids, nv) if fn.startswith("ivf") else ()
        f = {"topk": topk, "topk_int8": topk_int8, "ivf_topk": ivf_topk,
             "ivf_topk_int8": ivf_topk_int8}[fn]
        return f(q, rows, *extra, t(bias), *plan, k, block_rows=block_rows)

    call(10, 256)
    for k, block_rows, width in ((300, 256, 128), (10, 300, 128), (10, 256, 64), (0, 256, 128),
                                 (1025, 1024, 128)):
        with pytest.raises(ValueError):
            call(k, block_rows, width)


@pytest.mark.parametrize("backend", ["xla", "pallas", "pallas_interpret"])
def test_fused_topk_takes_zero_queries_as_jax(backend):
    """No query: [0, k] results on every backend (the CPU runs the plain
    versions), as JAX's fused_topk returns."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4096, 128)).astype(np.float32)
    bias = np.zeros(4096, np.float32)
    q0 = np.zeros((0, 128), np.float32)
    s, i = fused_topk(torch.from_numpy(q0), torch.from_numpy(x), torch.from_numpy(bias), 7,
                      block_rows=1024, backend=backend)
    assert tuple(s.shape) == tuple(i.shape) == (0, 7)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    js, ji = jax_ops.fused_topk(jnp.asarray(q0), jnp.asarray(x), jnp.asarray(bias), 7,
                                block_rows=1024, backend="xla")
    assert js.shape == ji.shape == (0, 7)


@pytest.mark.parametrize("qn", [0, 1, 64, 65, 130])
@pytest.mark.parametrize("dim", [0, 1])
def test_query_tiles_split_and_join(qn, dim):
    """The wrappers' shared tiling: tiles of at most MAX_Q queries in
    order, each result joined along its query axis; no query, no launch."""
    from youtu_rag_tpu_torch.ops.topk import MAX_Q, _empty, _query_tiles

    queries = torch.arange(qn, dtype=torch.float32)[:, None].repeat(1, 3)
    tiles = []

    def launch(qt):
        tiles.append(qt.shape[0])
        s = qt[:, :1].repeat(1, 4)  # [q, 4]: each row's query number
        s = s if dim == 0 else s[None].repeat(2, 1, 1)  # candidates [2, q, 4]
        return s, s.to(torch.int32) + 1

    empty = _empty((0, 4) if dim == 0 else (2, 0, 4), "cpu")
    s, i = _query_tiles(launch, queries, empty, dim=dim)
    assert tiles == [min(MAX_Q, qn - j) for j in range(0, qn, MAX_Q)]
    assert s.shape[dim] == qn and i.dtype == torch.int32
    rows = s if dim == 0 else s[1]
    assert torch.equal(rows[:, 0], torch.arange(qn, dtype=torch.float32))
    assert torch.equal(i, s.to(torch.int32) + 1)
