"""The port's IVF (k-means, probe plan, the probed-block top-k and the IVF
half of DeviceVectorIndex) against the JAX package's, on the CPU.

- k-means: Lloyd's iterations from JAX's own init draw give centroids
  within 1e-5 and equal assignments (the port draws its init with numpy,
  a deliberate difference); the fit sample and the plan bound are equal;
- probe_blocks: equal (ids, n_valid), with and without the adaptive margin
  and with a fresh tail;
- the plain versions of the IVF kernels against the interpret-mode Pallas
  DMA kernels: bf16 rows equal with scores within 1e-4, int8/int4 within
  1e-5 (exact integer dots; XLA may contract the f32 epilogue), every slot
  compared, the fill of the slots no live row fills included;
- a JAX IVF index carried by ``index_from_numpy`` answers as JAX's
  ``backend="pallas_interpret"`` through search, fresh-tail appends,
  deletes, filters, the adaptive margin, the residual re-rank, the tuner's
  n_probe steps, the auto-compaction rebuild and ``clear``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youtu_rag_tpu.core.config import IndexConfig as JaxIndexConfig
from youtu_rag_tpu.core.types import Chunk as JaxChunk
from youtu_rag_tpu.index import ivf as jax_ivf
from youtu_rag_tpu.index.device_index import DeviceVectorIndex as JaxIndex
from youtu_rag_tpu.ops import ivf as jax_ops_ivf
from youtu_rag_tpu.ops import kmeans as jax_kmeans
from youtu_rag_tpu.ops.topk import quantize_rows_int4 as jax_quantize_int4
from youtu_rag_tpu.ops.topk import quantize_rows_int8 as jax_quantize_int8
from youtu_rag_tpu_torch.core.config import IndexConfig
from youtu_rag_tpu_torch.core.types import Chunk
from youtu_rag_tpu_torch.index import DeviceVectorIndex, index_from_numpy
from youtu_rag_tpu_torch.index import ivf as port_ivf
from youtu_rag_tpu_torch.ops import kmeans as port_kmeans
from youtu_rag_tpu_torch.ops.ivf import ivf_topk_dma, ivf_topk_int4_dma, ivf_topk_int8_dma
from youtu_rag_tpu_torch.ops.topk import NEG_INF
from torch_native_helpers import jax_tracer_restored  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("jax_tracer_restored")

sys.path.insert(0, os.path.dirname(__file__))
from torch_ivf_cases import make_inputs  # noqa: E402

TOL = 1e-4
QTOL = 1e-5
D = 64


def clustered(rng, n_clusters, per_cluster, d, spread=0.15):
    """tests/index/test_ivf.py's data: unit vectors around unit centers."""
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    vecs = []
    for c in centers:
        pts = c[None] + spread * rng.normal(size=(per_cluster, d)).astype(np.float32)
        vecs.append(pts / np.linalg.norm(pts, axis=1, keepdims=True))
    return np.concatenate(vecs), centers


def jax_init(n, n_clusters, seed):
    """JAX's own init draw (``kmeans_fit``), for Lloyd-iteration parity."""
    return np.array(jax.random.choice(jax.random.PRNGKey(seed), n, (n_clusters,),
                                      replace=n < n_clusters))


@pytest.fixture
def jax_kmeans_init(monkeypatch):
    """The port's k-means starts from JAX's init rows, so a build on both
    sides sorts the rows the same way."""
    monkeypatch.setattr(port_kmeans, "kmeans_init", jax_init)


# ---------------------------------------------------------------------------
# k-means, fit sample, plan bound, probe plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n, n_clusters, seed", [(600, 12, 0), (600, 12, 3), (10, 16, 1)])
def test_lloyd_from_jax_init_matches_kmeans_fit(n, n_clusters, seed):
    x, _ = clustered(np.random.default_rng(seed), 6, -(-n // 6), 32)
    x = x[:n]
    want = np.asarray(jax_kmeans.kmeans_fit(jnp.asarray(x), n_clusters, iters=8, seed=seed))
    init = torch.from_numpy(x[jax_init(n, n_clusters, seed)])
    got = port_kmeans.kmeans_lloyd(torch.from_numpy(x), init, iters=8)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        port_kmeans.kmeans_assign(torch.from_numpy(x), got).numpy(),
        np.asarray(jax_kmeans.kmeans_assign(jnp.asarray(x), jnp.asarray(want))))


def test_port_kmeans_fit_draws_its_init_with_numpy():
    x = torch.from_numpy(clustered(np.random.default_rng(0), 4, 50, 16)[0])
    init = np.random.default_rng(5).choice(200, 8, replace=False)
    assert np.array_equal(port_kmeans.kmeans_init(200, 8, 5), init)
    torch.testing.assert_close(port_kmeans.kmeans_fit(x, 8, iters=3, seed=5),
                               port_kmeans.kmeans_lloyd(x, x[init], 3), rtol=0, atol=0)


@pytest.mark.parametrize("n, cap", [(100, 131072), (5000, 1000), (131073, 131072)])
def test_fit_sample_indices_match_jax(n, cap):
    got, want = port_ivf.fit_sample_indices(n, 7, cap), jax_ivf.fit_sample_indices(n, 7, cap)
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


@pytest.mark.parametrize("qn, n_probe, mcb, frozen, total", [
    (1, 4, 2, 32, 32), (8, 64, 3, 1024, 1024), (64, 64, 40, 900, 1024), (3, 2, 1, 10, 16)])
def test_plan_max_blocks_matches_jax(qn, n_probe, mcb, frozen, total):
    kw = dict(centroids=None, cluster_block_start=None, cluster_block_count=None,
              max_cluster_blocks=mcb, frozen_blocks=frozen, n_lists=64, n_probe=n_probe)
    assert (port_ivf.plan_max_blocks(port_ivf.IVFState(**kw), qn, total)
            == jax_ivf.plan_max_blocks(jax_ivf.IVFState(**kw), qn, total))


PROBE_CASES = {
    "fixed": {},
    "adaptive": {"adaptive_margin": 0.1, "min_probe": 2},
    "adaptive_floor": {"adaptive_margin": 0.0, "min_probe": 3},
}


@pytest.mark.parametrize("frozen", [40, 33], ids=["no_tail", "tail"])
@pytest.mark.parametrize("case", list(PROBE_CASES))
@pytest.mark.parametrize("max_blocks", [8, 64], ids=["short", "long"])
def test_probe_blocks_match_jax(case, frozen, max_blocks):
    rng = np.random.default_rng(len(case) + frozen)
    c, d, total = 10, 32, 40
    cents = clustered(rng, c, 1, d, spread=0.0)[0]
    counts = rng.integers(0, 5, c).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    q = cents[:4] + 0.3 * rng.normal(size=(4, d)).astype(np.float32)
    kw = dict(n_probe=4, max_cluster_blocks=int(counts.max()), total_blocks=total,
              max_blocks=max_blocks)
    extra = PROBE_CASES[case]
    ids, nv = port_ivf.probe_blocks(torch.from_numpy(q), torch.from_numpy(cents),
                                    torch.from_numpy(starts), torch.from_numpy(counts),
                                    frozen_blocks=frozen, **kw, **extra)
    jextra = {}
    if extra:
        jextra = {"adaptive_margin": jnp.float32(extra["adaptive_margin"]),
                  "min_probe": jnp.int32(extra["min_probe"])}
    wids, wnv = jax_ivf.probe_blocks(jnp.asarray(q), jnp.asarray(cents), jnp.asarray(starts),
                                     jnp.asarray(counts), frozen_blocks=jnp.int32(frozen), **kw,
                                     **jextra)
    assert ids.dtype == torch.int32 and nv.dtype == torch.int32 and nv.dim() == 0
    np.testing.assert_array_equal(ids.numpy(), np.asarray(wids))
    assert int(nv) == int(wnv)


# ---------------------------------------------------------------------------
# the plain versions against the interpret-mode DMA kernels
# ---------------------------------------------------------------------------

KN, KD, KBR = 512, 256, 64


def kernel_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((KN, KD)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.standard_normal((3, KD)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    bias = np.zeros(KN, np.float32)
    bias[::5] = NEG_INF
    bias[7::13] = -np.inf
    return x, q, bias


def run_both(tier, x, q, bias, ids, n_valid, k, block_rows=KBR):
    """(port, jax) results of one tier's IVF top-k on the same inputs."""
    tids, tnv = torch.from_numpy(ids), torch.tensor(n_valid, dtype=torch.int32)
    jids, jnv = jnp.asarray(ids), jnp.int32(n_valid)
    kw = dict(block_rows=block_rows)
    tq, tb = torch.from_numpy(q), torch.from_numpy(bias)
    if tier == "bf16":
        got = ivf_topk_dma(tq, torch.from_numpy(x).to(torch.bfloat16), tb, tids, tnv, k, **kw)
        want = jax_ops_ivf.pallas_ivf_topk_dma(jnp.asarray(q), jnp.asarray(x, jnp.bfloat16),
                                               jnp.asarray(bias), jids, jnv, k, interpret=True,
                                               **kw)
    else:
        quant = jax_quantize_int8 if tier == "int8" else jax_quantize_int4
        xq, xs = (np.array(a) for a in quant(jnp.asarray(x)))
        port_fn = ivf_topk_int8_dma if tier == "int8" else ivf_topk_int4_dma
        jax_fn = (jax_ops_ivf.pallas_ivf_topk_int8_dma if tier == "int8"
                  else jax_ops_ivf.pallas_ivf_topk_int4_dma)
        got = port_fn(tq, torch.from_numpy(xq), torch.from_numpy(xs), tb, tids, tnv, k, **kw)
        want = jax_fn(jnp.asarray(q), jnp.asarray(xq), jnp.asarray(xs), jnp.asarray(bias), jids,
                      jnv, k, interpret=True, **kw)
    return tuple(t.numpy() for t in got), tuple(np.asarray(a) for a in want)


@pytest.mark.parametrize("tier", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("n_valid, k, ordered",
                         [(3, 10, True), (8, 5, True), (1, 50, True), (0, 5, True),
                          (5, 20, False), (8, 40, False)],
                         ids=["partial", "all", "fewer_rows_than_k", "empty", "unordered",
                              "all_unordered"])
def test_plain_versions_match_pallas_dma_kernels(tier, n_valid, k, ordered):
    """A plan lists its selected blocks ascending; the unordered cases walk
    them in another order, and both rank by (score, probe position, row in
    block). Every slot is compared, the fill of the empty ones included."""
    x, q, bias = kernel_inputs(seed=n_valid + k)
    ids = np.asarray([1, 2, 5, 0, 3, 4, 6, 7], np.int32)
    if ordered:
        ids[:n_valid] = np.sort(ids[:n_valid])
    (gs, gi), (ws, wi) = run_both(tier, x, q, bias, ids, n_valid, k)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=TOL if tier == "bf16" else QTOL)
    assert ((gs > NEG_INF) | (gs == NEG_INF)).all()  # empty slots score NEG_INF
    if n_valid == 0:
        assert (gs == NEG_INF).all()


# Fewer live rows than k over many blocks: the slots no live row fills
# hold JAX's fill (NEG_INF, r), r the running list's top row when the last
# block with a live row was merged. name → (queries (the kernel pads them
# to 8), live rows, n_valid, ids order, -inf rows)
FILL_CASES = {
    "one-query-shuffled": (1, 9, 12, "shuffled", False),
    "three-queries-sorted": (3, 5, 10, "sorted", True),
    "seven-queries-shuffled": (7, 13, 12, "shuffled", True),
    "nine-queries-two-tiles": (9, 4, 8, "shuffled", False),
    "live-in-one-block": (2, 1, 12, "shuffled", False),
    "no-live-row": (4, 0, 12, "shuffled", True),
}


@pytest.mark.parametrize("tier", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("case", list(FILL_CASES))
def test_dma_fill_matches_pallas_dma_kernels(tier, case):
    """12 blocks of 16 rows, k = 10: every slot of the plain versions
    equals the interpret-mode DMA kernel's (rows exactly, scores as in
    ``test_plain_versions_match_pallas_dma_kernels``), the fill rows of the
    empty slots included."""
    qn, n_live, n_valid, order, neg_inf_rows = FILL_CASES[case]
    rng = np.random.default_rng(len(case) + qn)
    br, nb, d, k = 16, 12, 256, 10
    x = rng.standard_normal((nb * br, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.standard_normal((qn, d)).astype(np.float32)
    bias = np.full(nb * br, NEG_INF, np.float32)
    bias[rng.choice(nb * br, n_live, replace=False)] = 0.0
    if neg_inf_rows:
        bias[rng.choice(np.flatnonzero(bias < 0), 5, replace=False)] = -np.inf
    ids = rng.permutation(nb).astype(np.int32)
    if order == "sorted":
        ids[:n_valid] = np.sort(ids[:n_valid])
    (gs, gi), (ws, wi) = run_both(tier, x, q, bias, ids, n_valid, k, block_rows=br)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=TOL if tier == "bf16" else QTOL)
    np.testing.assert_array_equal(gs <= NEG_INF, ws <= NEG_INF)


# The inputs the int4 ring kernel must answer (csrc/ivf_scan_tma.cuh,
# Int4): name → (d, n, block_rows, n_valid, k, bias kind, ids order). A
# 32-row stage spans blocks of 4 and 12 rows; 66 starts runs off 4-row
# boundaries; ids past n_valid are garbage (never read); "ties" holds exact
# ties across blocks, in ascending ids (the probe plan's order, in which
# the DMA kernels' row order and JAX's probe-order walk agree).
INT4_DMA_CASES = {
    "rows4-shuffled-k10": (256, 1024, 4, 48, 10, "mixed", "shuffled"),
    "rows12-k64": (256, 1020, 12, 30, 64, "mixed", "shuffled"),
    "rows66-d512-k64": (512, 1056, 66, 8, 64, "mixed", "shuffled"),
    "empty-plan": (256, 1024, 64, 0, 10, "mixed", "sorted"),
    "k-above-probed-rows": (256, 1024, 4, 5, 64, "mixed", "shuffled"),
    "ties-d512-k64": (512, 1024, 64, 16, 64, "ties", "sorted"),
    "ties-rows4": (256, 1024, 4, 256, 10, "ties", "sorted"),
    "dead-d512": (512, 1024, 64, 16, 10, "dead", "sorted"),
}


@pytest.mark.parametrize("case", list(INT4_DMA_CASES))
def test_int4_plain_version_matches_pallas_dma_kernel_on_ring_inputs(case):
    """The port's plain int4 IVF top-k against ``pallas_ivf_topk_int4_dma``
    in interpret mode: the same live slots (score > NEG_INF), rows equal
    and scores bit-equal (tolerance: none), and NEG_INF in every other slot
    of both, whose rows (JAX's fill: the running list's top row once a
    block after one with a live row was merged) are equal too."""
    d, n, br, n_valid, k, kind, order = INT4_DMA_CASES[case]
    qs, x, bias = make_inputs(4, d, n, kind, seed=d + br + k)
    rng = np.random.default_rng(n_valid + k)
    ids = np.full(n // br, 10**8, np.int32)  # garbage past n_valid
    chosen = rng.permutation(n // br)[:n_valid]
    ids[:n_valid] = chosen if order == "shuffled" else np.sort(chosen)
    xq, xs = (np.array(a) for a in jax_quantize_int4(jnp.asarray(x)))
    tnv = torch.tensor(n_valid, dtype=torch.int32)
    gs, gi = ivf_topk_int4_dma(torch.from_numpy(qs), torch.from_numpy(xq), torch.from_numpy(xs),
                               torch.from_numpy(bias), torch.from_numpy(ids), tnv, k,
                               block_rows=br)
    ws, wi = jax_ops_ivf.pallas_ivf_topk_int4_dma(
        jnp.asarray(qs), jnp.asarray(xq), jnp.asarray(xs), jnp.asarray(bias), jnp.asarray(ids),
        jnp.int32(n_valid), k, block_rows=br, interpret=True)
    gs, gi, ws, wi = gs.numpy(), gi.numpy(), np.asarray(ws), np.asarray(wi)
    live = ws > NEG_INF
    np.testing.assert_array_equal(gs > NEG_INF, live)
    np.testing.assert_array_equal(gi, wi)  # every slot, the fill included
    np.testing.assert_array_equal(gs.view(np.uint32), ws.view(np.uint32))  # NEG_INF past live
    if kind == "ties":  # query 0 is row 700: its copies tie at the top, in row order
        assert gi[0, :5].tolist() == [r for r in (20, 300, 600, 700, 900)
                                      if r // br in set(ids[:n_valid].tolist())][:5]
    if n_valid == 0:
        assert (gs == NEG_INF).all() and (gi == 0).all()


def int4_ring_steps(d, quarter, t):
    """Int4::dots' steps for lane t of ``quarter`` (csrc/ivf_scan_tma.cuh):
    the byte offset of the packed word each mma step takes, in the row and
    in the query's low half (its high half at d/2 + offset). Rounds of 16
    chunks: chunk 16r + 4 quarter + t, its four words; then, where
    d % 512 == 256, the last 8 chunks as 16 halves: half 4 quarter + t, its
    two words."""
    rounds = d // 512
    steps = [16 * (16 * r + 4 * quarter + t) + 4 * w for r in range(rounds) for w in range(4)]
    if d % 512:
        steps += [256 * rounds + 8 * (4 * quarter + t) + 4 * w for w in range(2)]
    return steps


@pytest.mark.parametrize("d", [256, 512, 768, 1024, 1280, 2048, 3072, 4096, 8192])
def test_int4_ring_column_mapping_is_exact_and_balanced(d):
    """An emulation of the int4 ring's scoring, lane by lane and mma step by
    step: per step, lane (g, t) gives A its word's biased low nibbles (k
    4t..4t+3) and high nibbles (k 16 + 4t..) of rows g and g + 8, and B
    query g's bytes of the same offsets in its low and high halves;
    mma.sync m16n8k32 sums A @ B. The four quarters' sums, less 8 sum(q) in
    quarter 0, equal ``unpack_int4(x) @ q`` exactly (tolerance: none), each
    packed byte is taken once, and every quarter takes d/128 steps."""
    from youtu_rag_tpu.ops.topk import unpack_int4 as jax_unpack_int4

    rng = np.random.default_rng(d)
    xp = rng.integers(-128, 128, (16, d // 2), dtype=np.int64).astype(np.int8)  # every nibble
    q = rng.integers(-127, 128, (8, d), dtype=np.int64)
    steps = [[int4_ring_steps(d, quarter, t) for t in range(4)] for quarter in range(4)]
    taken = sorted(off for quarter in steps for lane in quarter for off in lane)
    assert taken == list(range(0, d // 2, 4))
    assert {len(lane) for quarter in steps for lane in quarter} == {d // 128}
    u = xp.view(np.uint8).astype(np.int64) ^ 0x88  # biased: x + 8, in [0, 15]
    lo, hi = u & 0x0F, u >> 4
    acc = np.zeros((16, 8), np.int64)
    for quarter in range(4):
        for s in range(d // 128):
            a = np.zeros((16, 32), np.int64)
            b = np.zeros((32, 8), np.int64)
            for t in range(4):
                off = steps[quarter][t][s]
                cols = slice(off, off + 4)
                a[:, 4 * t : 4 * t + 4] = lo[:, cols]  # rows g and g + 8 alike
                a[:, 16 + 4 * t : 20 + 4 * t] = hi[:, cols]
                b[4 * t : 4 * t + 4] = q[:, off : off + 4].T
                b[16 + 4 * t : 20 + 4 * t] = q[:, d // 2 + off : d // 2 + off + 4].T
            acc += a @ b
        if quarter == 0:
            acc -= 8 * q.sum(axis=1)[None, :]
    want = np.asarray(jax_unpack_int4(jnp.asarray(xp))).astype(np.int64) @ q.T
    np.testing.assert_array_equal(acc, want)


# ---------------------------------------------------------------------------
# a JAX IVF index and its carried twin
# ---------------------------------------------------------------------------


def chunks(cls, n, doc="docA", start=0):
    return [cls(id=f"{doc}-{i}", document_id=doc, content=f"content {doc} {i}", chunk_index=i,
                metadata={"source": doc, "idx": i, "tag": ["red", "blue", "green"][i % 3]})
            for i in range(start, start + n)]


def carried_state(index: JaxIndex) -> dict:
    """What a JAX index holder exports for ``index_from_numpy``, its IVF
    state included."""
    st = index._ivf
    state = {
        "dim": index.dim, "config": index.config.model_dump(),
        "bias": np.asarray(index._bias), "cols": np.asarray(index._cols),
        "chunks": list(index._chunks), "size": index.size, "live_count": index.live_count,
        "capacity": index.capacity, "schema": index.schema.to_dict(),
        "ivf": None if st is None else {
            "centroids": np.asarray(st.centroids),
            "cluster_block_start": np.asarray(st.cluster_block_start),
            "cluster_block_count": np.asarray(st.cluster_block_count),
            "max_cluster_blocks": st.max_cluster_blocks, "frozen_blocks": st.frozen_blocks,
            "n_lists": st.n_lists, "n_probe": st.n_probe},
    }
    if index._quant:
        state.update(vectors=np.asarray(index._vectors), scales=np.asarray(index._scales))
        if index._host_q8 is not None:
            state.update(host_q8=index._host_q8, host_s8=index._host_s8)
    else:
        state["vectors"] = np.asarray(index._vectors).astype(np.float32)
    return state


def assert_same_hits(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=0, atol=tol)
        for (gc, gs), (wc, ws) in zip(g, w):
            assert gc.id == wc.id or abs(gs - ws) <= tol  # near-ties may swap


# (metric, storage_dtype, int4_rerank_multiplier): every metric, every tier
INDEX_CASES = [("cosine", "int8", 4.0), ("l2", "int4", 0.0), ("ip", "int4", 4.0),
               ("cosine", "bfloat16", 4.0)]
INDEX_IDS = ["cosine-int8", "l2-int4-raw", "ip-int4-rerank", "cosine-bf16"]


@pytest.mark.parametrize("metric, storage_dtype, mult", INDEX_CASES, ids=INDEX_IDS)
def test_carried_ivf_index_answers_like_jax_pallas(jax_kmeans_init, metric, storage_dtype, mult):
    rng = np.random.default_rng(1)
    vecs, centers = clustered(rng, 8, 64, D)  # 512 rows in 8 blocks of 64
    vecs = vecs[rng.permutation(len(vecs))]
    cfg = dict(metric=metric, storage_dtype=storage_dtype, int4_rerank_multiplier=mult,
               min_capacity=512, block_rows=64, n_lists=8, n_probe=2, kmeans_iters=5,
               ivf_adaptive_margin=0.05, ivf_min_probe=1, ivf_rerank_multiplier=2.0,
               ivf_recall_target=0.99, ivf_tune_interval=2, auto_compact_ratio=0.5)
    jax_ix = JaxIndex(D, JaxIndexConfig(**cfg))
    jax_ix.add(chunks(JaxChunk, len(vecs)), vecs)
    jax_ix.build_ivf()
    port = index_from_numpy(carried_state(jax_ix), device="cpu")
    assert port.config.model_dump() == jax_ix.config.model_dump()
    tol = TOL if storage_dtype == "bfloat16" else QTOL
    q = centers[:4] + 0.1 * rng.normal(size=(4, D)).astype(np.float32)
    between = clustered(rng, 4, 1, D, spread=0.0)[0]  # queries between the clusters

    def check(queries, top_k=10, filters=None):
        got = port.search(queries, top_k=top_k, filters=filters)
        assert_same_hits(got, jax_ix.search(queries, top_k=top_k, filters=filters,
                                             backend="pallas_interpret"), tol)
        assert port._ivf.n_probe == jax_ix._ivf.n_probe  # the tuner took the same steps
        return got

    probes = []
    for _ in range(4):  # the tuner's shadow runs every second batch
        check(between)
        probes.append(port._ivf.n_probe)
    assert probes[-1] > 2, probes  # recall below 0.99 at n_probe 2 grew it
    check(q, filters={"tag": {"$in": ["red", "green"]}})
    # a fresh-tail append past the freeze: its block is always probed
    novel = clustered(rng, 1, 1, D, spread=0.0)[0]
    jax_ix.add(chunks(JaxChunk, 1, "new"), novel)
    port.add(chunks(Chunk, 1, "new"), novel)
    assert check(np.repeat(novel, 4, axis=0))[0][0][0].id == "new-0"
    dead = [f"docA-{i}" for i in range(0, 512, 3)]
    jax_ix.delete(dead)
    port.delete(dead)
    check(q)
    # deleting past auto_compact_ratio compacts and builds IVF again on both
    more = [f"docA-{i}" for i in range(1, 512, 3)]
    jax_ix.delete(more)
    port.delete(more)
    assert port.size == jax_ix.size == port.count() and port._ivf is not None
    np.testing.assert_array_equal(port._ivf.cluster_block_start.numpy(),
                                  np.asarray(jax_ix._ivf.cluster_block_start))
    check(q)
    port.clear()
    jax_ix.clear()
    assert port._ivf is None and port.search(q, 5) == [[] for _ in range(4)]


def test_carried_config_moves_the_compaction_threshold_like_jax():
    """Repair: index_from_numpy keeps the JAX index's block_rows (128 here,
    not the default 1024), so both auto-compact at the same delete."""
    kw = dict(min_capacity=512, block_rows=128, auto_compact_ratio=0.5)
    jax_ix = JaxIndex(D, JaxIndexConfig(**kw))
    vecs = clustered(np.random.default_rng(2), 4, 150, D)[0]
    jax_ix.add(chunks(JaxChunk, 600), vecs)
    port = index_from_numpy(carried_state(jax_ix), device="cpu")
    assert port.config.block_rows == 128 and port._ivf is None
    dead = [f"docA-{i}" for i in range(310)]
    jax_ix.delete(dead)
    port.delete(dead)
    assert port.size == jax_ix.size == 290


# ---------------------------------------------------------------------------
# the port's own build, reorder and staging
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("storage_dtype", ["bfloat16", "int8", "int4"])
def test_port_build_ivf_recall_at_10(storage_dtype):
    """tests/index/test_ivf.py's data and settings, with the port's own
    k-means init: recall@10 against brute force >= 0.95."""
    rng = np.random.default_rng(7)
    vecs, centers = clustered(rng, 16, 128, D)
    cfg = IndexConfig(min_capacity=2048, block_rows=64, n_lists=16, n_probe=4, kmeans_iters=8,
                      storage_dtype=storage_dtype)
    idx = DeviceVectorIndex(D, cfg, device="cpu")
    idx.add(chunks(Chunk, len(vecs)), vecs)
    queries = centers[:8] + 0.05 * rng.normal(size=(8, D)).astype(np.float32)
    brute = [[c.id for c, _ in h] for h in idx.search(queries, top_k=10)]
    idx.build_ivf()
    assert idx._ivf.n_lists == 16 and idx._ivf.n_probe == 4
    got = [[c.id for c, _ in h] for h in idx.search(queries, top_k=10)]
    recalls = [len(set(a) & set(b)) / 10 for a, b in zip(got, brute)]
    assert np.mean(recalls) >= 0.95, recalls


def test_reorder_keeps_every_lookup():
    idx = DeviceVectorIndex(32, IndexConfig(min_capacity=128, block_rows=64,
                                            storage_dtype="int4"), device="cpu")
    vecs = clustered(np.random.default_rng(0), 3, 20, 32)[0]
    idx.add([Chunk(f"c{i}", f"d{i % 3}", f"t{i}", i, {"i": i}) for i in range(60)], vecs)
    before = idx.search(vecs[:3], top_k=3)
    shadow = idx._host_q8.copy()
    perm = np.random.default_rng(0).permutation(idx.size)
    idx.reorder(perm)
    after = idx.search(vecs[:3], top_k=3)
    for b, a in zip(before, after):
        assert [(c.id, s) for c, s in b] == [(c.id, s) for c, s in a]
    np.testing.assert_array_equal(idx._host_q8[:60], shadow[perm])
    assert idx.get_by_id("c5").content == "t5"
    assert all(idx._chunks[r].id == cid for cid, r in idx._id_to_row.items())
    assert idx.delete_by_document_id("d0") == 20
    with pytest.raises(ValueError, match="permutation"):
        idx.reorder(np.arange(5))


@pytest.mark.parametrize("storage_dtype", ["bfloat16", "int8", "int4"])
def test_host_staged_reorder_equals_device_reorder(monkeypatch, storage_dtype):
    cfg = IndexConfig(min_capacity=128, block_rows=64, storage_dtype=storage_dtype)
    vecs = clustered(np.random.default_rng(1), 3, 20, 32)[0]
    perm = np.random.default_rng(1).permutation(60)
    dev, host = (DeviceVectorIndex(32, cfg, device="cpu") for _ in range(2))
    for ix in (dev, host):
        ix.add([Chunk(f"c{i}", "d", f"t{i}", i, {"i": i}) for i in range(60)], vecs)
    assert dev._should_stage_reorder() is False  # a CPU index never stages
    dev.reorder(perm)
    monkeypatch.setattr(host, "_should_stage_reorder", lambda: True)
    host.reorder(perm)
    for name in ("_vectors", "_cols", "_bias") + (("_scales",) if dev._quant else ()):
        assert torch.equal(getattr(host, name), getattr(dev, name)), name
    assert host._id_to_row == dev._id_to_row
    host.build_ivf(n_lists=3)
    assert host.search(vecs[:1], top_k=1)[0][0][0].id == "c0"


@pytest.mark.parametrize("storage_dtype", ["bfloat16", "int8"])
def test_residual_rerank_draws_jax_k2_above_1024(monkeypatch, storage_dtype):
    """ivf_rerank_multiplier 4 at top_k 300: both indexes probe for
    k2 = pow2(1200) = 2048 candidates (no cap at 1024) and re-rank them to
    the same hits."""
    import youtu_rag_tpu.ops.ivf as jax_ivf_ops
    import youtu_rag_tpu_torch.index.device_index as port_device_index

    asked = {"jax": [], "port": []}
    for side, module, name in (("jax", jax_ivf_ops, "xla_ivf_topk"),
                               ("port", port_device_index, "ivf_topk_dma"),
                               ("port", port_device_index, "ivf_topk_int8_dma")):
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _r=real, _s=side, **kw: asked[_s].append(a[-1])
                            or _r(*a, **kw))
    rng = np.random.default_rng(5)
    # 16384 rows in 256 blocks of 64; a plan of 2 of 32 lists per query
    # lists fewer than all blocks (JAX's XLA path searches brute force when
    # the plan's bound covers them all)
    vecs, centers = clustered(rng, 32, 512, D)
    cfg = dict(metric="cosine", storage_dtype=storage_dtype, min_capacity=16384, block_rows=64,
               n_lists=32, n_probe=2, kmeans_iters=3, ivf_adaptive_margin=0.0,
               ivf_rerank_multiplier=4.0, ivf_recall_target=0.0)
    jax_ix = JaxIndex(D, JaxIndexConfig(**cfg))
    jax_ix.add(chunks(JaxChunk, len(vecs)), vecs)
    jax_ix.build_ivf()
    port = index_from_numpy(carried_state(jax_ix), device="cpu")
    q = centers[:2] + 0.1 * rng.normal(size=(2, D)).astype(np.float32)
    got = port.search(q, top_k=300)
    assert_same_hits(got, jax_ix.search(q, top_k=300, backend="xla"), TOL)
    assert [len(h) for h in got] == [300, 300]
    assert asked["port"] == asked["jax"] == [2048]
