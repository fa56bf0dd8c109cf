"""The port's DeviceVectorIndex (on the CPU) against the JAX package's
DeviceVectorIndex (xla backend) and NumpyVectorIndex.

Both bf16 device indexes score ``f32(bf16 q) · f32(bf16 x)`` in f32, so
their hits agree in order with scores within 1e-4; the numpy reference
keeps its queries in f32 and agrees to bf16 precision (as the JAX tests
hold it). The int8 and int4 tiers store byte-equal arrays (vectors, scales
and the int4 host shadow) after the same operations and return the same
chunks with scores within 1e-5 (exact integer dots; XLA may contract the
f32 epilogue into an FMA).
"""

import sys
import threading

import numpy as np
import pytest
import torch

from youtu_rag_tpu.core.config import IndexConfig as JaxIndexConfig
from youtu_rag_tpu.core.types import Chunk as JaxChunk
from youtu_rag_tpu.index.device_index import DeviceVectorIndex as JaxIndex
from youtu_rag_tpu.index.filters import compile_filter as jax_compile_filter
from youtu_rag_tpu.index.metadata import MetadataSchema as JaxSchema
from youtu_rag_tpu.index.numpy_ref import NumpyVectorIndex
from youtu_rag_tpu_torch.core.config import IndexConfig
from youtu_rag_tpu_torch.core.types import Chunk
from youtu_rag_tpu_torch.index import DeviceVectorIndex, index_from_numpy
from youtu_rag_tpu_torch.index.filters import compile_filter
from youtu_rag_tpu_torch.index.metadata import MetadataSchema

TOL = 1e-4
D = 64
METRICS = ["cosine", "l2", "ip"]


def chunks(cls, n, doc="docA", start=0):
    return [
        cls(id=f"{doc}-{i}", document_id=doc, content=f"content {doc} {i}", chunk_index=i,
            metadata={"source": doc, "idx": i, "ts": 1000 + i, "tag": ["red", "blue", "green"][i % 3]})
        for i in range(start, start + n)
    ]


def vectors(seed, n, d=D):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


class Trio:
    """The same operations on the JAX index, the port's and numpy's."""

    def __init__(self, metric, **cfg):
        kw = dict(metric=metric, min_capacity=256, block_rows=128, **cfg)
        self.jax = JaxIndex(D, JaxIndexConfig(**kw))
        self.port = DeviceVectorIndex(D, IndexConfig(**kw), device="cpu")
        self.ref = NumpyVectorIndex(D, JaxIndexConfig(**kw), quantize_bf16=True)

    def add(self, n, seed, doc="docA", start=0):
        embs = vectors(seed, n)
        self.jax.add(chunks(JaxChunk, n, doc, start), embs)
        self.ref.add(chunks(JaxChunk, n, doc, start), embs)
        return self.port.add(chunks(Chunk, n, doc, start), embs)

    def call(self, name, *args):
        out = [getattr(ix, name)(*args) for ix in (self.jax, self.port, self.ref)]
        assert out[0] == out[1], (name, out)
        return out[1]

    def check(self, queries, top_k=10, filters=None):
        got = self.port.search(queries, top_k=top_k, filters=filters)
        assert_same_hits(got, self.jax.search(queries, top_k=top_k, filters=filters, backend="xla"))
        want = self.ref.search(queries, top_k=top_k, filters=filters)
        for g, w in zip(got, want):
            assert len(g) == len(w)
            if w:
                overlap = len({c.id for c, _ in g} & {c.id for c, _ in w}) / len(w)
                assert overlap >= 0.9
            np.testing.assert_allclose([s for _, s in g], [s for _, s in w], atol=3e-2)
        return got


def assert_same_hits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], atol=TOL)
        for (gc, gs), (wc, ws) in zip(g, w):
            # a different chunk at one rank is only allowed for a near-tie
            assert gc.id == wc.id or abs(gs - ws) <= TOL


@pytest.mark.parametrize("metric", METRICS)
def test_add_and_search(metric):
    t = Trio(metric)
    rows = t.add(300, seed=1)
    assert rows == list(range(300))
    t.check(vectors(2, 5))
    t.check(vectors(3, 1)[0])  # a single 1-D query
    t.check(vectors(4, 3), top_k=50)


@pytest.mark.parametrize("metric", METRICS)
def test_readd_delete_and_update_metadata(metric):
    t = Trio(metric)
    t.add(300, seed=1)
    t.add(40, seed=5, start=10)  # re-add ids docA-10..49 with new vectors
    assert t.call("count") == 300
    q = vectors(6, 4)
    t.check(q)
    ids = [f"docA-{i}" for i in range(0, 300, 3)]
    t.call("delete", ids)
    t.call("delete", ids)  # deleting twice is a no-op
    assert t.call("count") == 200
    t.check(q)
    t.call("delete_by_document_id", "docA")
    assert t.call("count") == 0
    t.add(50, seed=7, doc="docB")
    metas = [{"source": "docB", "idx": 1000 + i, "tag": "moved"} for i in range(10)]
    ids = [f"docB-{i}" for i in range(10)]
    n_jax = t.jax.update_metadata(ids, metas)
    assert t.port.update_metadata(ids, metas) == n_jax == 10
    for c in t.ref._chunks:
        if c is not None and c.id in ids:
            c.metadata = metas[ids.index(c.id)]
    t.check(q, filters={"tag": "moved"})
    t.check(q, filters={"idx": {"$gte": 1000}})


FILTERS = [
    {"source": "docA"},
    {"idx": {"$gte": 100}},
    {"idx": {"$gt": 50, "$lte": 120}},
    {"tag": {"$in": ["red", "green"]}},
    {"tag": {"$nin": ["red"]}},
    {"tag": {"$ne": "blue"}},
    {"$or": [{"idx": {"$lt": 20}}, {"tag": "green"}]},
    {"$and": [{"ts": {"$gte": 1100}}, {"tag": {"$eq": "red"}}]},
    {"missing_key": 1},  # host fallback: no device column
    {"source": {"$regex": "^doc"}},  # host fallback: operator not compiled
]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("filters", FILTERS, ids=[str(i) for i in range(len(FILTERS))])
def test_filters(metric, filters):
    t = Trio(metric)
    t.add(300, seed=1)
    t.call("delete", [f"docA-{i}" for i in range(0, 300, 7)])
    t.check(vectors(8, 4), filters=filters)


@pytest.mark.parametrize("filters", FILTERS[:8], ids=[str(i) for i in range(8)])
def test_compiled_masks_match_jax(filters):
    metas = [c.metadata for c in chunks(Chunk, 200)] + [{}, {"idx": None}, {"tag": 3}]
    schema, jschema = MetadataSchema(), JaxSchema()
    cols = np.asarray([schema.encode_row(m) for m in metas], np.int32)
    jcols = np.asarray([jschema.encode_row(m) for m in metas], np.int32)
    np.testing.assert_array_equal(cols, jcols)
    got = compile_filter(filters, schema)
    want = jax_compile_filter(filters, jschema)
    assert got.signature() == want.signature()
    np.testing.assert_array_equal(got.consts, want.consts)
    np.testing.assert_array_equal(got.mask(torch.from_numpy(cols)).numpy(),
                                  np.asarray(want.mask(jcols)))


@pytest.mark.parametrize("metric", METRICS)
def test_growth_compact_and_clear(metric):
    t = Trio(metric, auto_compact_ratio=0.0)
    t.add(200, seed=1)
    assert t.port.capacity == t.jax.capacity == 256
    t.add(700, seed=2, doc="docB")  # a 1024-row bucket: one jump past 256 rows
    assert t.port.capacity == t.jax.capacity == 2048
    assert t.port.size == t.jax.size == 900
    q = vectors(3, 6)
    t.check(q)
    t.call("delete", [f"docB-{i}" for i in range(0, 700, 2)])
    t.jax.compact()
    t.port.compact()
    assert t.port.size == t.jax.size == 550 and t.port.count() == 550
    assert_same_hits(t.port.search(q, 10), t.jax.search(q, 10, backend="xla"))
    assert t.port.count_by_document("docB") == t.jax.count_by_document("docB") == 350
    assert t.port.get_by_id("docB-1").content == "content docB 1"
    assert t.port.get_by_id("docB-0") is None
    assert t.port.nbytes() == t.port.capacity * (t.port.d_pad * 2 + 16 * 4 + 4)
    t.port.clear()
    t.jax.clear()
    assert t.port.count() == 0 and t.port.search(q, 5) == [[] for _ in range(6)]


def test_auto_compact_matches_jax():
    t = Trio("cosine", auto_compact_ratio=0.5)
    t.add(600, seed=1)
    t.call("delete", [f"docA-{i}" for i in range(350)])
    assert t.port.size == t.jax.size == 250  # both compacted at the same delete
    t.check(vectors(9, 3))


def jax_state(index: JaxIndex) -> dict:
    """What a JAX index holder exports for ``index_from_numpy``."""
    return {
        "dim": index.dim,
        "config": index.config.model_dump(),
        "vectors": np.asarray(index._vectors).astype(np.float32),
        "bias": np.asarray(index._bias),
        "cols": np.asarray(index._cols),
        "chunks": list(index._chunks),
        "size": index.size,
        "live_count": index.live_count,
        "capacity": index.capacity,
        "schema": index.schema.to_dict(),
    }


@pytest.mark.parametrize("metric", METRICS)
def test_index_from_numpy_answers_like_the_jax_index(metric):
    t = Trio(metric)
    t.add(300, seed=1)
    t.call("delete", [f"docA-{i}" for i in range(0, 300, 4)])
    port = index_from_numpy(jax_state(t.jax), device="cpu")
    assert (port.capacity, port.size, port.count()) == (t.jax.capacity, t.jax.size, t.jax.count())
    assert port.config.model_dump() == t.jax.config.model_dump()  # block_rows 128 included
    q = vectors(11, 5)
    for filters in (None, {"idx": {"$lt": 150}}, {"source": {"$regex": "A$"}}):
        assert_same_hits(port.search(q, 10, filters), t.jax.search(q, 10, filters, backend="xla"))
    # both keep working the same after the import
    port.add(chunks(Chunk, 20, "docC"), vectors(12, 20))
    t.jax.add(chunks(JaxChunk, 20, "docC"), vectors(12, 20))
    port.delete(["docC-3", "docA-1"])
    t.jax.delete(["docC-3", "docA-1"])
    assert port.count() == t.jax.count()
    assert_same_hits(port.search(q, 10), t.jax.search(q, 10, backend="xla"))


def test_threads_add_delete_and_search_keep_the_index_whole():
    """Writers append and delete while readers search, under a short switch
    interval: no search returns a duplicate or a non-finite score, and
    after the joins every live row is counted and finds itself."""
    idx = DeviceVectorIndex(D, IndexConfig(min_capacity=128, block_rows=64), device="cpu")
    embs = vectors(0, 420)
    idx.add(chunks(Chunk, 20, "seed"), embs[:20])
    errors = []

    def writer(w):
        for b in range(20):  # 100 rows per writer, in small appends
            lo = 20 + (w * 20 + b) * 5
            idx.add(chunks(Chunk, 5, f"w{w}", start=lo), embs[lo : lo + 5])
        if w % 2:
            idx.delete_by_document_id(f"w{w}")

    def reader(seed):
        q = vectors(100 + seed, 2)
        for _ in range(30):
            for hits in idx.search(q, 10):
                ids = [c.id for c, _ in hits]
                if len(set(ids)) != len(ids) or not all(np.isfinite(s) for _, s in hits):
                    errors.append(ids)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=writer, args=(w,)) for w in range(4)]
        threads += [threading.Thread(target=reader, args=(r,)) for r in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    live = [c.id for c in idx.iter_live()]
    assert idx.count() == len(live) == 20 + 2 * 100
    own = embs[[int(cid.rsplit("-", 1)[1]) for cid in live]]  # ids end in their row of embs
    assert [hits[0][0].id for hits in idx.search(own, 1)] == live


def test_top_k_at_the_kernel_limit_matches_jax():
    t = Trio("cosine")
    t.add(1100, seed=1)
    t.check(vectors(2, 3), top_k=1024)


@pytest.mark.parametrize("storage_dtype", ["bfloat16", "int8", "int4"])
def test_top_k_1024_answers(storage_dtype):
    idx = DeviceVectorIndex(D, IndexConfig(min_capacity=2048, storage_dtype=storage_dtype),
                            device="cpu")
    idx.add(chunks(Chunk, 1100), vectors(1, 1100))
    hits = idx.search(vectors(2, 2), top_k=1024)
    assert [len(h) for h in hits] == [1024, 1024]
    assert all(len({c.id for c, _ in h}) == 1024 for h in hits)


@pytest.mark.parametrize("top_k", [0, -1, -2000])
def test_top_k_outside_the_kernel_range_raises_on_the_cpu_too(top_k):
    """A CPU index refuses the k a CUDA index's kernel cannot take: below 1
    (above the live count a search answers the live rows, as in JAX)."""
    idx = DeviceVectorIndex(D, IndexConfig(min_capacity=256), device="cpu")
    idx.add(chunks(Chunk, 300), vectors(1, 300))
    with pytest.raises(ValueError, match="top_k"):
        idx.search(vectors(2, 2), top_k=top_k)


@pytest.mark.parametrize("backend", ["auto", "pallas", "pallas_interpret", "xla"])
def test_search_backend_names_match_jax_xla(backend):
    """A CPU index runs the plain version under each of JAX's four names,
    with JAX's xla backend's hits."""
    t = Trio("cosine")
    t.add(300, seed=1)
    q = vectors(2, 4)
    got = t.port.search(q, 10, backend=backend)
    want = t.jax.search(q, 10, backend="xla")
    for g, w in zip(got, want):
        assert [c.id for c, _ in g] == [c.id for c, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], atol=TOL)


def test_search_unknown_backend_raises():
    idx = DeviceVectorIndex(D, IndexConfig(min_capacity=256), device="cpu")
    idx.add(chunks(Chunk, 10), vectors(1, 10))
    with pytest.raises(ValueError, match="unknown backend"):
        idx.search(vectors(2, 1), 3, backend="triton")


def test_ivf_kind_builds_the_flat_index_jax_builds():
    """``kind`` is not read, as in the JAX index: "ivf" serves brute force
    until ``build_ivf()``."""
    t = Trio("cosine", kind="ivf")
    t.add(300, seed=1)
    assert t.port._ivf is None and t.jax._ivf is None
    t.check(vectors(2, 4))


def test_float32_storage_searches_in_bf16():
    t = Trio("cosine", storage_dtype="float32")
    t.add(300, seed=1)
    assert t.port._vectors.dtype == torch.float32
    t.check(vectors(2, 4))


# ---------------------------------------------------------------------------
# int8 / int4 storage tiers
# ---------------------------------------------------------------------------

QTOL = 1e-5
# (storage_dtype, int4_rerank_multiplier): int4 with and without the host re-rank
QUANT_TIERS = [("int8", 4.0), ("int4", 4.0), ("int4", 0.0)]
QUANT_IDS = ["int8", "int4-rerank", "int4-raw"]


def assert_same_quant_hits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=0, atol=QTOL)
        for (gc, gs), (wc, ws) in zip(g, w):
            assert gc.id == wc.id or abs(gs - ws) <= QTOL


class QuantDuo:
    """The same operations on a quantized JAX index and the port's."""

    def __init__(self, metric, storage_dtype, mult, **cfg):
        kw = dict(metric=metric, min_capacity=256, block_rows=128, storage_dtype=storage_dtype,
                  int4_rerank_multiplier=mult, **cfg)
        self.jax = JaxIndex(D, JaxIndexConfig(**kw))
        self.port = DeviceVectorIndex(D, IndexConfig(**kw), device="cpu")

    def add(self, n, seed, doc="docA", start=0):
        embs = vectors(seed, n)
        self.jax.add(chunks(JaxChunk, n, doc, start), embs)
        rows = self.port.add(chunks(Chunk, n, doc, start), embs)
        self.assert_same_state()
        return rows

    def call(self, name, *args):
        out = [getattr(ix, name)(*args) for ix in (self.jax, self.port)]
        assert out[0] == out[1], (name, out)
        self.assert_same_state()
        return out[1]

    def assert_same_state(self):
        j, p = self.jax, self.port
        assert (p.capacity, p.size, p.live_count, p.d_pad) == (j.capacity, j.size, j.live_count, j.d_pad)
        np.testing.assert_array_equal(p._vectors.numpy(), np.asarray(j._vectors))
        np.testing.assert_array_equal(p._scales.numpy().view(np.uint32),
                                      np.asarray(j._scales).view(np.uint32))
        np.testing.assert_array_equal(p._bias.numpy(), np.asarray(j._bias))
        assert (p._host_q8 is None) == (j._host_q8 is None)
        if j._host_q8 is not None:
            np.testing.assert_array_equal(p._host_q8, j._host_q8)
            np.testing.assert_array_equal(p._host_s8.view(np.uint32), j._host_s8.view(np.uint32))

    def check(self, queries, top_k=10, filters=None):
        got = self.port.search(queries, top_k=top_k, filters=filters)
        assert_same_quant_hits(got, self.jax.search(queries, top_k=top_k, filters=filters,
                                                    backend="xla"))
        return got


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("tier", QUANT_TIERS, ids=QUANT_IDS)
def test_quantized_tier_matches_jax(metric, tier):
    """add, re-add, delete, filters, growth, compact and clear."""
    t = QuantDuo(metric, *tier, auto_compact_ratio=0.0)
    assert t.port._vectors.dtype == torch.int8
    # int8 pads d = 64 to 128; int4 pads it to 256 and packs it into 128 bytes
    assert t.port._vectors.shape[1] == t.jax._vec_cols == 128
    assert t.port.d_pad == (128 if tier[0] == "int8" else 256)
    assert t.add(200, seed=1) == list(range(200))
    q = vectors(3, 6)
    t.check(q)
    t.check(q[0])  # a single 1-D query
    t.check(q, top_k=50)
    t.add(40, seed=5, start=10)  # re-add ids docA-10..49 with new vectors
    assert t.call("count") == 200
    t.check(q)
    t.call("delete", [f"docA-{i}" for i in range(0, 200, 3)])
    for filters in ({"idx": {"$gte": 100}}, {"tag": {"$in": ["red", "green"]}},
                    {"source": {"$regex": "^doc"}}):
        t.check(q, filters=filters)
    t.add(700, seed=2, doc="docB")  # a 1024-row bucket: growth past 256 rows
    assert t.port.capacity == t.jax.capacity == 2048
    t.check(q, top_k=20)
    t.call("delete", [f"docB-{i}" for i in range(0, 700, 2)])
    t.jax.compact()
    t.port.compact()
    t.assert_same_state()
    assert t.port.size == t.jax.size
    t.check(q)
    t.call("clear")
    assert t.port.count() == 0 and t.port.search(q, 5) == [[] for _ in range(6)]


@pytest.mark.parametrize("tier", QUANT_TIERS, ids=QUANT_IDS)
def test_quantized_dequantized_views_match_jax(tier):
    t = QuantDuo("cosine", *tier)
    t.add(300, seed=1)
    np.testing.assert_array_equal(t.port.dequantized_vectors().numpy(),
                                  np.asarray(t.jax.dequantized_vectors()))
    np.testing.assert_array_equal(t.port.dequantized_rows(10, 64).numpy(),
                                  np.asarray(t.jax.dequantized_rows(10, 64)))
    rows = np.asarray([5, 0, 299, 17])
    np.testing.assert_array_equal(t.port.dequantize_take(rows).numpy(),
                                  np.asarray(t.jax.dequantize_take(rows)))
    got, n = t.port.dequantize_take_padded(rows)
    want, n_jax = t.jax.dequantize_take_padded(rows)
    assert n == n_jax == 4 and got.shape == want.shape == (4096, t.port.d_pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # nbytes leaves out the scales, as the JAX index counts
    assert t.port.nbytes() == t.jax.nbytes() == t.port.capacity * (t.port._vec_cols + 16 * 4 + 4)


def quant_state(index: JaxIndex) -> dict:
    """What a quantized JAX index holder exports for ``index_from_numpy``."""
    state = jax_state(index)
    state.update(
        vectors=np.asarray(index._vectors),
        scales=np.asarray(index._scales),
    )
    if index._host_q8 is not None:
        state.update(host_q8=index._host_q8, host_s8=index._host_s8)
    return state


@pytest.mark.parametrize("tier", QUANT_TIERS, ids=QUANT_IDS)
def test_index_from_numpy_carries_the_quantized_tiers(tier):
    t = QuantDuo("cosine", *tier)
    t.add(300, seed=1)
    t.call("delete", [f"docA-{i}" for i in range(0, 300, 4)])
    port = index_from_numpy(quant_state(t.jax), device="cpu")
    t.port = port
    t.assert_same_state()
    q = vectors(11, 5)
    for filters in (None, {"idx": {"$lt": 150}}):
        t.check(q, filters=filters)
    t.add(20, seed=12, doc="docC")
    t.check(q)


@pytest.mark.parametrize("storage_dtype", ["bfloat16", "int8", "int4"])
def test_top_k_2000_matches_jax(monkeypatch, storage_dtype):
    """top_k above the old 1024 cap answers as the JAX index does, on each
    tier; the int4 host re-rank draws JAX's candidate count (pow2 of 4 x
    2000 = 8192, cut to the largest power of two <= the 2100 live rows)."""
    import youtu_rag_tpu.index.device_index as jax_device_index
    import youtu_rag_tpu_torch.index.device_index as port_device_index

    asked = {"jax": [], "port": []}
    for side, module, name in (("jax", jax_device_index, "xla_topk_int4"),
                               ("port", port_device_index, "topk_int4_pruned")):
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _r=real, _s=side: asked[_s].append(a[-1])
                            or _r(*a))
    kw = dict(min_capacity=4096, storage_dtype=storage_dtype)
    jax_ix = JaxIndex(D, JaxIndexConfig(**kw))
    port = DeviceVectorIndex(D, IndexConfig(**kw), device="cpu")
    jax_ix.add(chunks(JaxChunk, 2100), vectors(1, 2100))
    port.add(chunks(Chunk, 2100), vectors(1, 2100))
    q = vectors(2, 3)
    got = port.search(q, top_k=2000)
    assert [len(h) for h in got] == [2000] * 3
    assert_same_hits(got, jax_ix.search(q, top_k=2000, backend="xla"))
    if storage_dtype == "int4":
        assert asked["port"] == asked["jax"] == [2048]
    # above the live count a search answers every live row, as in JAX
    assert [len(h) for h in port.search(q[:1], top_k=5000)] == [2100]
