"""The port's ``ShardedVectorIndex`` on a local mesh (S shards on the CPU)
against the JAX package's on S of the 8 host devices, S in {2, 4, 8}: the
cases of ``tests/parallel/test_sharded_index.py`` on both packages.

Tolerances: the same rows in the same order; bf16 and f32 scores within
1e-5 (both score ``f32(bf16 q) · f32(bf16 x)`` in f32, 1.2e-7 apart seen);
int8 and int4 scores bit-equal (exact integer dots, the same f32
epilogue). JAX's brute searches take its XLA path (``backend="xla"``, the
arithmetic of the kernels' plain versions); its IVF searches take the
Pallas DMA kernels in interpret mode (``jax_pallas_interpret``), since its
XLA IVF path scores dequantized rows. Both sides start k-means from JAX's
init draw (``jax_kmeans_init``), so both sort the rows alike."""

import functools

import jax
import numpy as np
import pytest
import torch

from youtu_rag_tpu.core.config import IndexConfig as JaxIndexConfig
from youtu_rag_tpu.core.types import Chunk as JaxChunk
from youtu_rag_tpu.ops import ivf as jax_ops_ivf
from youtu_rag_tpu.ops import topk as jax_ops_topk
from youtu_rag_tpu.parallel import sharded_index as jax_sharded
from youtu_rag_tpu.parallel.mesh import get_hybrid_mesh as jax_hybrid_mesh
from youtu_rag_tpu.parallel.mesh import get_mesh as jax_get_mesh
from youtu_rag_tpu_torch.core.config import IndexConfig
from youtu_rag_tpu_torch.core.types import Chunk
from youtu_rag_tpu_torch.index.device_index import DeviceVectorIndex
from youtu_rag_tpu_torch.ops import kmeans as port_kmeans
from youtu_rag_tpu_torch.parallel import ShardedVectorIndex, get_hybrid_mesh, get_mesh
from youtu_rag_tpu_torch.parallel import make_sharded_topk
from torch_native_helpers import jax_tracer_restored  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("jax_tracer_restored")

TOL = 1e-5
SHARDS = [2, 4, 8]
TIERS = ["bfloat16", "float32", "int8", "int4"]


def jax_init(n, n_clusters, seed):
    """JAX's own k-means init draw (``kmeans_fit``)."""
    return np.array(jax.random.choice(jax.random.PRNGKey(seed), n, (n_clusters,),
                                      replace=n < n_clusters))


@pytest.fixture
def jax_kmeans_init(monkeypatch):
    monkeypatch.setattr(port_kmeans, "kmeans_init", jax_init)


@pytest.fixture
def jax_pallas_interpret(monkeypatch):
    """JAX's sharded index with ``backend="pallas"`` runs its Pallas kernels
    in interpret mode on the CPU (the kernels' own tests run them so)."""
    for name in ("pallas_topk_pruned", "pallas_topk_int8_pruned", "pallas_topk_int4_pruned"):
        monkeypatch.setattr(jax_sharded, name,
                            functools.partial(getattr(jax_ops_topk, name), interpret=True))
    for name in ("pallas_ivf_topk_dma", "pallas_ivf_topk_int8_dma", "pallas_ivf_topk_int4_dma"):
        monkeypatch.setattr(jax_ops_ivf, name,
                            functools.partial(getattr(jax_ops_ivf, name), interpret=True))


def chunks(cls, n, doc="doc", start=0):
    return [cls(f"{doc}-{i}", doc, f"content {i}", i, {"source": doc, "idx": i})
            for i in range(start, start + n)]


def unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def pair(s: int, d: int, axis="db", **cfg):
    """(JAX index on S host devices, the port's on a local mesh of S)."""
    jm = jax_get_mesh({axis: s}, devices=jax.devices()[:s])
    pm = get_mesh({axis: s}, devices=["cpu"] * s)
    return (jax_sharded.ShardedVectorIndex(d, JaxIndexConfig(**cfg), mesh=jm, axis=axis),
            ShardedVectorIndex(d, IndexConfig(**cfg), mesh=pm, axis=axis))


def add_both(jx, px, n, embs, doc="doc", start=0):
    jx.add(chunks(JaxChunk, n, doc, start), embs)
    px.add(chunks(Chunk, n, doc, start), embs)


def assert_same(got, want, exact: bool):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [c.id for c, _ in g] == [c.id for c, _ in w]
        gs, ws = np.asarray([s for _, s in g]), np.asarray([s for _, s in w])
        if exact:
            np.testing.assert_array_equal(gs, ws)
        else:
            np.testing.assert_allclose(gs, ws, rtol=0, atol=TOL)


def stored(jx, px):
    """Both indexes' stored rows, bias and scales (bf16 widened)."""
    pv = px._vectors.float() if px._vectors.dtype == torch.bfloat16 else px._vectors
    jv = np.asarray(jx._vectors).astype(np.float32 if px._vectors.is_floating_point() else np.int8)
    return (pv.numpy(), jv), (px._bias.numpy(), np.asarray(jx._bias))


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("tier", TIERS)
def test_brute_filtered_and_delete_match_jax(tier, s):
    rng = np.random.default_rng(1)
    jx, px = pair(s, 64, min_capacity=1024, block_rows=64, storage_dtype=tier)
    assert px.capacity == jx.capacity and px.capacity % (s * 64) == 0 and px.n_shards == s
    add_both(jx, px, 900, unit(rng, 900, 64))
    for a, b in stored(jx, px):
        np.testing.assert_array_equal(a, b)
    exact = tier in ("int8", "int4")
    q = rng.normal(size=(6, 64)).astype(np.float32)
    assert_same(px.search(q, top_k=10), jx.search(q, top_k=10, backend="xla"), exact)
    f = {"idx": {"$gte": 100, "$lt": 200}}
    got = px.search(q[:2], top_k=5, filters=f)
    assert_same(got, jx.search(q[:2], top_k=5, filters=f, backend="xla"), exact)
    assert all(100 <= c.metadata["idx"] < 200 for h in got for c, _ in h)
    victim = got[0][0][0].id
    assert px.delete([victim]) == jx.delete([victim]) == 1
    after = px.search(q[:1], top_k=3)
    assert victim not in [c.id for c, _ in after[0]]
    assert_same(after, jx.search(q[:1], top_k=3, backend="xla"), exact)


@pytest.mark.parametrize("s", SHARDS)
def test_sharded_topk_merges_like_jax(s):
    """``make_sharded_topk`` on raw tensors: per-shard top-k, global rows,
    the stable merge; ties (a duplicated row) go to the lower position."""
    rng = np.random.default_rng(s)
    n, d = 128 * s, 128
    x = unit(rng, n, d)
    x[n - 1] = x[3]  # a tie across shards
    bias = np.where(rng.random(n) < 0.2, np.finfo(np.float32).min, 0).astype(np.float32)
    bias[3] = bias[n - 1] = 0.0
    q = np.concatenate([x[3:4], rng.normal(size=(3, d)).astype(np.float32)])
    jm = jax_get_mesh({"db": s}, devices=jax.devices()[:s])
    js, ji = jax_sharded.make_sharded_topk(jm)(jax.numpy.asarray(q),
                                               jax.numpy.asarray(x, jax.numpy.bfloat16),
                                               jax.numpy.asarray(bias), 12, "xla")
    ps, pi = make_sharded_topk(get_mesh({"db": s}, devices=["cpu"] * s))(
        torch.from_numpy(q), torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(bias), 12)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=0, atol=TOL)
    assert pi[0, 0] == 3 and pi[0, 1] == n - 1


# JAX's sharded IVF compiles its shard_map at every search, and the int8 and
# int4 cases run its Pallas kernels interpreted: those two take S 2 and 8
IVF_CASES = [("bfloat16", 2), ("bfloat16", 4), ("bfloat16", 8), ("int8", 2), ("int8", 8),
             ("int4", 2), ("int4", 8)]


@pytest.mark.parametrize("tier, s", IVF_CASES)
def test_ivf_recall_filter_and_tail_match_jax(jax_kmeans_init, jax_pallas_interpret, tier, s):
    """``tests/parallel/test_sharded_index.py``'s IVF case: recall against
    brute, a filtered IVF search, a fresh-tail append found. JAX's bf16 IVF
    takes its XLA path (the same scores as its DMA kernel)."""
    rng = np.random.default_rng(9)
    d = 64
    centers = unit(rng, 8, d)
    parts = [c[None] + 0.05 * rng.normal(size=(96, d)).astype(np.float32) for c in centers]
    vecs = np.concatenate([p / np.linalg.norm(p, axis=1, keepdims=True) for p in parts])
    vecs = vecs[rng.permutation(len(vecs))]
    jx, px = pair(s, d, min_capacity=1024, block_rows=64, n_lists=8, n_probe=3, kmeans_iters=8,
                  storage_dtype=tier)
    add_both(jx, px, len(vecs), vecs)
    q = centers[:4] + 0.03 * rng.normal(size=(4, d)).astype(np.float32)
    brute = [[c.id for c, _ in h] for h in px.search(q, top_k=10)]
    jx.build_ivf()
    px.build_ivf()
    assert px._ivf_frozen_min == jx._ivf_frozen_min
    np.testing.assert_array_equal(px._ivf.cluster_block_start.numpy(),
                                  np.asarray(jx._ivf.cluster_block_start))
    np.testing.assert_array_equal(px._ivf.cluster_block_count.numpy(),
                                  np.asarray(jx._ivf.cluster_block_count))
    exact, backend = tier != "bfloat16", "xla" if tier == "bfloat16" else "pallas"
    got = px.search(q, top_k=10)
    recall = np.mean([len(set(a) & {c.id for c, _ in h}) / 10 for a, h in zip(brute, got)])
    assert recall >= 0.9, recall
    f = {"idx": {"$lt": 400}}
    hits = px.search(q, top_k=10, filters=f)
    assert hits[0] and all(c.metadata["idx"] < 400 for h in hits for c, _ in h)
    assert_same(hits, jx.search(q, top_k=10, filters=f, backend=backend), exact)
    novel = unit(rng, 1, d)
    add_both(jx, px, 1, novel, doc="novel")
    top = px.search(np.concatenate([novel, q[:3]]), top_k=10)
    assert top[0][0][0].id == "novel-0"
    assert_same(top, jx.search(np.concatenate([novel, q[:3]]), top_k=10, backend=backend), exact)


@pytest.mark.parametrize("s", SHARDS)
def test_ivf_uneven_tail_not_truncated_like_jax(jax_kmeans_init, s):
    """Rows all in shard 0 at the freeze: the plan budgets the least-filled
    shard's tail, so a row appended deep in another shard's tail is found."""
    rng = np.random.default_rng(11)
    d = 32
    jx, px = pair(s, d, min_capacity=16 * 64 * s, block_rows=64, n_lists=8, n_probe=1,
                  kmeans_iters=4)
    first = 64 * 10  # 10 of shard 0's 16 blocks
    add_both(jx, px, first, unit(rng, first, d), doc="base")
    jx.build_ivf()
    px.build_ivf()
    assert px._ivf_frozen_min == jx._ivf_frozen_min == 0
    add_both(jx, px, 64 * 12, unit(rng, 64 * 12, d), doc="tail")  # into shard 1's tail
    novel = unit(rng, 1, d)
    add_both(jx, px, 1, novel, doc="novel")
    top = px.search(novel, top_k=3)
    assert top[0][0][0].id == "novel-0"
    assert_same(top, jx.search(novel, top_k=3), exact=False)


@pytest.mark.parametrize("s", SHARDS)
def test_growth_across_doublings_and_compaction_match_jax(s):
    """Appends past two capacity doublings (JAX's rows change shard; the
    port's views move with the capacity), deletes, ``compact`` (the base
    rebuild on a local mesh: the capacity shrinks back, as JAX's), clear:
    the hits stay JAX's and the mesh stays."""
    rng = np.random.default_rng(3)
    d = 32
    jx, px = pair(s, d, axis="rows", min_capacity=64, block_rows=32, storage_dtype="int8",
                  auto_compact_ratio=0.0)
    mesh, lock = px.mesh, px._lock
    cap0 = px.capacity
    add_both(jx, px, cap0 // 2, unit(rng, cap0 // 2, d), doc="a")
    add_both(jx, px, 3 * cap0, unit(rng, 3 * cap0, d), doc="b")
    assert px.capacity == jx.capacity >= 4 * cap0
    for a, b in stored(jx, px):
        np.testing.assert_array_equal(a, b)
    q = unit(rng, 5, d)
    assert_same(px.search(q, top_k=8), jx.search(q, top_k=8, backend="xla"), exact=True)
    dead = [f"b-{i}" for i in range(0, 3 * cap0, 2)]
    px.delete(dead)
    jx.delete(dead)
    px.compact()
    jx.compact()
    assert px.capacity == jx.capacity and px.size == jx.size == px.count()
    assert px.mesh is mesh and px.axis == "rows" and px._lock is lock
    assert_same(px.search(q, top_k=8), jx.search(q, top_k=8, backend="xla"), exact=True)
    px.clear()
    assert px.mesh is mesh and px.n_shards == s and px.count() == 0


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_cross_shard_permutation_matches_jax_ring(dtype, s):
    """An arbitrary permutation across shards: the local mesh's gather
    gives what JAX's ppermute ring gives (the port's ring, for a process
    group, is held in ``test_torch_sharded_multiproc*.py``)."""
    rng = np.random.default_rng(9)
    jx, px = pair(s, 32, min_capacity=256, block_rows=32, storage_dtype=dtype)
    add_both(jx, px, 200, unit(rng, 200, 32), doc="docR")
    perm = rng.permutation(px.capacity).astype(np.int64)
    jv, _, jb, js = jx._permute_global_ring(perm)
    px._apply_permutation(perm)
    got_v = px._vectors.float() if dtype == "bfloat16" else px._vectors
    want_v = np.asarray(jv).astype(np.float32 if dtype == "bfloat16" else np.int8)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(px._bias.numpy(), np.asarray(jb))
    if dtype == "int8":
        np.testing.assert_array_equal(px._scales.numpy(), np.asarray(js))


@pytest.mark.parametrize("s", SHARDS)
def test_compaction_by_permutation_keeps_the_hits(s):
    """JAX's multi-process compaction body on one process: live rows to the
    global front by a cross-shard permutation; the hits do not change and
    stay JAX's."""
    rng = np.random.default_rng(10)
    jx, px = pair(s, 32, min_capacity=256, block_rows=32, auto_compact_ratio=0.0)
    embs = unit(rng, 200, 32)
    add_both(jx, px, 200, embs, doc="docC")
    dead = [f"docC-{i}" for i in range(0, 100, 2)]
    px.delete(dead)
    jx.delete(dead)
    before = px.search(embs[:4], top_k=5)
    live = [r for r, c in enumerate(px._chunks) if c is not None]
    perm = np.asarray(live + [r for r, c in enumerate(px._chunks) if c is None], np.int64)
    px._apply_permutation(np.concatenate([perm, np.arange(px.size, px.capacity)]))
    px._chunks = [px._chunks[o] for o in perm[: len(live)]]
    px._rebuild_host_maps()
    px.size = px.live_count = len(live)
    after = px.search(embs[:4], top_k=5)
    assert [[c.id for c, _ in h] for h in after] == [[c.id for c, _ in h] for h in before]
    assert_same(after, jx.search(embs[:4], top_k=5, backend="xla"), exact=False)


@pytest.mark.parametrize("s", SHARDS)
def test_int4_two_stage_matches_jax(jax_kmeans_init, s):
    """int4-packed shards: the per-shard kernel, the merge, the host int8
    re-rank; IVF over packed shards (its parity with JAX is the IVF case's);
    compaction keeps the shadow aligned."""
    rng = np.random.default_rng(9)
    jx, px = pair(s, 64, storage_dtype="int4", min_capacity=1024, block_rows=128)
    embs = unit(rng, 900, 64)
    add_both(jx, px, 900, embs, doc="doc4")
    assert px._vectors.shape[1] == px.d_pad // 2 and px._host_q8 is not None
    np.testing.assert_array_equal(px._host_q8, jx._host_q8)
    hits = px.search(embs[:8], top_k=10)
    assert_same(hits, jx.search(embs[:8], top_k=10, backend="xla"), exact=True)
    assert hits[0][0][0].id == "doc4-0" and hits[0][0][1] > 0.98
    px.delete(["doc4-0"])
    jx.delete(["doc4-0"])
    px.build_ivf(n_lists=4)
    jx.build_ivf(n_lists=4)
    got = px.search(embs[5:6], top_k=3)
    assert got[0][0][0].id == "doc4-5"
    px.compact()
    jx.compact()
    np.testing.assert_array_equal(px._host_q8[: px.size], jx._host_q8[: jx.size])
    got = px.search(embs[5:6], top_k=3)
    assert got[0][0][0].id == "doc4-5" and got[0][0][1] > 0.98
    assert_same(got, jx.search(embs[5:6], top_k=3, backend="xla"), exact=True)


@pytest.mark.parametrize("s", SHARDS)
def test_sharded_matches_one_device(s):
    """The same data on S shards and on one device: the same hits."""
    rng = np.random.default_rng(2)
    cfg = IndexConfig(min_capacity=512, block_rows=64)
    single = DeviceVectorIndex(32, cfg, device="cpu")
    multi = ShardedVectorIndex(32, cfg, mesh=get_mesh({"db": s}, devices=["cpu"] * s))
    embs = rng.normal(size=(500, 32)).astype(np.float32)
    single.add(chunks(Chunk, 500, "docP"), embs)
    multi.add(chunks(Chunk, 500, "docP"), embs)
    q = rng.normal(size=(4, 32)).astype(np.float32)
    assert_same(multi.search(q, top_k=7), single.search(q, top_k=7), exact=True)
    assert multi.nbytes() == single.nbytes()


def test_hybrid_mesh_index_matches_jax():
    """Rows sharded jointly over ("dcn", "ici") on one process (2 x 4)."""
    rng = np.random.default_rng(7)
    jm = jax_hybrid_mesh({"ici": 4}, {"dcn": 2})
    pm = get_hybrid_mesh({"ici": 4}, {"dcn": 2}, devices=["cpu"] * 8)
    cfg = dict(min_capacity=1024, block_rows=64)
    jx = jax_sharded.ShardedVectorIndex(32, JaxIndexConfig(**cfg), mesh=jm, axis=("dcn", "ici"))
    px = ShardedVectorIndex(32, IndexConfig(**cfg), mesh=pm, axis=("dcn", "ici"))
    assert px.n_shards == jx.n_shards == 8
    embs = unit(rng, 300, 32)
    add_both(jx, px, 300, embs, doc="h")
    q = rng.normal(size=(4, 32)).astype(np.float32)
    f = {"idx": {"$lt": 200}}
    assert_same(px.search(q, top_k=8, filters=f), jx.search(q, top_k=8, filters=f, backend="xla"),
                exact=False)


def test_the_index_takes_the_card_unless_given_a_mesh(monkeypatch):
    """No fallback: without a mesh the index takes the card
    (``default_index_mesh``) and raises on a host without one; tuple axes need a mesh; a process's
    shards must share a device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedVectorIndex(32)
    with pytest.raises(ValueError, match="explicit mesh"):
        ShardedVectorIndex(32, axis=("dcn", "ici"))
    with pytest.raises(ValueError, match="one device"):
        ShardedVectorIndex(32, mesh=get_mesh({"db": 2}, devices=["cpu:0", "cpu:1"]))


def test_the_default_mesh_is_one_shard_on_the_card(monkeypatch):
    """``ShardedVectorIndex``'s default mesh on a host with several cards is
    one shard on the first card (one process cannot span cards), where
    ``get_mesh``'s default spans them all; the mesh allocates nothing, so no
    card is needed here."""
    from youtu_rag_tpu_torch.parallel.sharded_index import ShardLayout, default_index_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert get_mesh({"db": -1}).shape == {"db": 2}
    mesh = default_index_mesh()
    assert mesh.shape == {"db": 1} and not mesh.distributed
    layout = ShardLayout(mesh)
    assert layout.n_shards == 1 and layout.device == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_index_mesh()
