"""The port's serving path on a mesh against the JAX package's on the CPU:
the store, ``KnowledgeBase`` (built, reloaded with ``load``),
``load_index(mesh=...)`` and ``ApiState(mesh=...)`` over a 4-shard ``db``
mesh (JAX: 4 of its 8 host devices; the port: a local mesh of 4 CPU
shards), snapshots crossing between the packages both ways, and the
data-parallel embedder (``TorchEmbedder(mesh=...)``, the JAX package's
``tests/parallel/test_sharded_index.py:329-380`` cases).

Tolerances: KB answers the same chunks in the same order with scores
within 1e-5 (bf16 rows; int8 exact integer dots, also within 1e-5 after a
fusion's f32 sums); the data-parallel embedder bit-equal to the
undistributed one when its shards share a device, within 2e-5 when they
run apart (another batch size per GEMM) and against JAX's dp embedder
(JAX's own test's tolerance)."""

import asyncio

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from youtu_rag_tpu.api.state import ApiState as JaxApiState
from youtu_rag_tpu.core.config import IndexConfig as JaxIndexConfig
from youtu_rag_tpu.core.config import RAGConfig as JaxRAGConfig
from youtu_rag_tpu.core.config import VectorStoreConfig as JaxVectorStoreConfig
from youtu_rag_tpu.core.types import Document as JaxDocument
from youtu_rag_tpu.index.persistence import load_index as jax_load_index
from youtu_rag_tpu.models.embedder import TpuEmbedder
from youtu_rag_tpu.models.encoder import EncoderConfig as JaxEncoderConfig
from youtu_rag_tpu.parallel.mesh import get_mesh as jax_get_mesh
from youtu_rag_tpu.parallel.sharded_index import ShardedVectorIndex as JaxSharded
from youtu_rag_tpu.retrieval.kb import KnowledgeBase as JaxKB
from youtu_rag_tpu_torch.api.state import ApiState
from youtu_rag_tpu_torch.core.config import (EmbeddingConfig, IndexConfig, RAGConfig,
                                              VectorStoreConfig)
from youtu_rag_tpu_torch.core.types import Document
from youtu_rag_tpu_torch.index.persistence import load_index
from youtu_rag_tpu_torch.models.convert import encoder_params_from_numpy
from youtu_rag_tpu_torch.models.embedder import EmbedderFactory, TorchEmbedder
from youtu_rag_tpu_torch.models.encoder import EncoderConfig
from youtu_rag_tpu_torch.parallel import Mesh, ShardedVectorIndex, get_mesh
from youtu_rag_tpu_torch.retrieval.kb import KBRegistry, KnowledgeBase
from youtu_rag_tpu_torch.retrieval.store import TorchVectorStore
from torch_api_helpers import port_registry  # noqa: F401 - a fixture
from torch_native_helpers import jax_tracer_restored  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("jax_tracer_restored", "port_registry")

TOL = 1e-5
EMB_TOL = 2e-5
S = 4
TOPICS = ["pasta boils in salted water", "Jupiter's moon Ganymede", "tomato seedlings want sun",
          "road bike tyres at eighty psi", "sourdough starter of wild yeast",
          "HBM bandwidth of the accelerator", "chess openings and endgames",
          "volcanoes erupt basalt lava"]
DOCS = [(f"d{i}", f"{TOPICS[i % 8]}. note {i} about {TOPICS[(3 * i) % 8]} and item {i * 7}.")
        for i in range(96)]
QUERIES = ["how long should pasta boil", "largest moon of Jupiter", "bike tyre pressure",
           "wild yeast bread", "note 17 about volcanoes"]


def port_mesh() -> Mesh:
    return get_mesh({"db": S}, devices=["cpu"] * S)


def jax_mesh():
    return jax_get_mesh({"db": S}, devices=jax.devices()[:S])


def rag(pkg_config, tier="bfloat16"):
    rc, vc, ic = pkg_config
    return rc(vector_store=vc(index=ic(min_capacity=256, block_rows=32, storage_dtype=tier)))


PORT_CFG = (RAGConfig, VectorStoreConfig, IndexConfig)
JAX_CFG = (JaxRAGConfig, JaxVectorStoreConfig, JaxIndexConfig)


async def answers(kb, hybrid=False):
    r = kb.hybrid_retriever if hybrid else kb.retriever
    return [[(x.chunk.id, x.score) for x in await r.retrieve(q, top_k=5)] for q in QUERIES]


def assert_same(got, want):
    for g, w in zip(got, want, strict=True):
        assert [c for c, _ in g] == [c for c, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=0, atol=TOL)


def build(kb, doc_cls):
    asyncio.run(kb.build_documents([doc_cls(i, t, {"n": k}) for k, (i, t) in enumerate(DOCS)]))
    return kb


@pytest.fixture(scope="module", params=["bfloat16", "int8"])
def kbs(request):
    port = build(KnowledgeBase("port", rag(PORT_CFG, request.param), mesh=port_mesh()), Document)
    jax_kb = build(JaxKB("jax", rag(JAX_CFG, request.param), mesh=jax_mesh()), JaxDocument)
    return port, jax_kb


def test_kb_on_a_mesh_shards_its_store(kbs):
    port, jax_kb = kbs
    idx = port.store._index
    assert isinstance(idx, ShardedVectorIndex) and idx.n_shards == S
    assert isinstance(jax_kb.store._index, JaxSharded)
    jidx = jax_kb.store._index
    assert idx.capacity == jidx.capacity and idx.count() == jidx.count()
    assert port.store._mesh.shape == {"db": S} and port.device == torch.device("cpu")


@pytest.mark.parametrize("hybrid", [False, True])
def test_kb_on_a_mesh_answers_like_jax(kbs, hybrid):
    port, jax_kb = kbs
    assert_same(asyncio.run(answers(port, hybrid)), asyncio.run(answers(jax_kb, hybrid)))
    got = asyncio.run(port.search("bike tyre pressure", top_k=4, filters={"n": {"$lt": 40}}))
    want = asyncio.run(jax_kb.search("bike tyre pressure", top_k=4, filters={"n": {"$lt": 40}}))
    assert [r.chunk.id for r in got] == [r.chunk.id for r in want]


@pytest.mark.parametrize("source", ["port", "jax"])
def test_snapshots_reload_onto_the_mesh_both_ways(kbs, tmp_path, source):
    """A snapshot of either package's sharded KB reloads onto either's mesh
    (``KnowledgeBase.load`` and ``load_index(mesh=...)``), sharded."""
    port, jax_kb = kbs
    (port if source == "port" else jax_kb).save(str(tmp_path / "snap"))
    tier = port.config.vector_store.index.storage_dtype
    p2 = KnowledgeBase("p2", rag(PORT_CFG, tier), mesh=port_mesh())
    j2 = JaxKB("j2", rag(JAX_CFG, tier), mesh=jax_mesh())
    p2.load(str(tmp_path / "snap"))
    j2.load(str(tmp_path / "snap"))
    assert isinstance(p2.store._index, ShardedVectorIndex) and p2.store._index.n_shards == S
    assert_same(asyncio.run(answers(p2)), asyncio.run(answers(j2)))
    if tier == "bfloat16":  # a quantized reload re-quantizes its dequantized rows, as JAX's
        assert_same(asyncio.run(answers(p2)), asyncio.run(answers(port)))
    idx = load_index(tmp_path / "snap" / "index", mesh=port_mesh())
    jidx = jax_load_index(tmp_path / "snap" / "index", mesh=jax_mesh())
    q = np.asarray(asyncio.run(port.embedder.embed_texts(QUERIES)), np.float32)
    for g, w in zip(idx.search(q, 5), jidx.search(q, 5)):
        assert [c.id for c, _ in g] == [c.id for c, _ in w]


def test_store_and_registry_take_a_mesh():
    mesh = port_mesh()
    store = TorchVectorStore(VectorStoreConfig(index=IndexConfig(min_capacity=256, block_rows=32)),
                             dim=16, mesh=mesh)
    assert isinstance(store.index, ShardedVectorIndex) and store.device == torch.device("cpu")
    with pytest.raises(ValueError, match="not the mesh's"):
        TorchVectorStore(dim=16, mesh=mesh, device="cuda")
    reg = KBRegistry()
    kb = reg.get_or_create("r", rag(PORT_CFG), mesh=mesh)
    assert reg.get_or_create("r") is kb and kb.store._mesh is mesh


def test_api_state_on_a_mesh_matches_jax_and_restarts_sharded(tmp_path):
    """Every KB an ``ApiState(mesh=...)`` creates shards over the mesh; its
    snapshot comes back sharded after a restart."""
    port = ApiState(data_dir=tmp_path / "p", rag_config=rag(PORT_CFG), mesh=port_mesh())
    jstate = JaxApiState(data_dir=tmp_path / "j", rag_config=rag(JAX_CFG), mesh=jax_mesh())
    assert port.mesh.shape == {"db": S} and port.device == torch.device("cpu")
    pk, jk = port.get_or_create_kb("facts"), jstate.get_or_create_kb("facts")
    build(pk, Document)
    build(jk, JaxDocument)
    assert isinstance(pk.store._index, ShardedVectorIndex)
    assert_same(asyncio.run(answers(pk, hybrid=True)), asyncio.run(answers(jk, hybrid=True)))
    pk.save(str(tmp_path / "p" / "snapshots" / "facts"))
    again = ApiState(data_dir=tmp_path / "p", rag_config=rag(PORT_CFG), mesh=port_mesh())
    kb = again.kbs.get("facts")
    assert isinstance(kb.store._index, ShardedVectorIndex) and kb.store._index.n_shards == S
    assert_same(asyncio.run(answers(kb)), asyncio.run(answers(jk)))


# ---------------------------------------------------------------------------
# the data-parallel embedder
# ---------------------------------------------------------------------------

KW = dict(d_model=64, n_layers=2, n_heads=2, d_ff=128, out_dim=64, vocab_size=512, max_len=64,
          attention_impl="xla")
TEXTS = [f"sample text number {i} about topic {i % 3}" for i in range(11)]


def twins(n_layers: int = 2):
    jcfg = JaxEncoderConfig(**{**KW, "n_layers": n_layers}, dtype=jax.numpy.float32)
    plain = TpuEmbedder(config=jcfg, batch_size=16, seed=3)
    tcfg = EncoderConfig(**{**KW, "n_layers": n_layers, "dtype": torch.float32})
    params = encoder_params_from_numpy(jax.tree.map(np.asarray, plain.params), tcfg)
    return jcfg, plain, tcfg, params


@pytest.mark.parametrize("dp", [2, 8])
def test_dp_embedder_matches_undistributed_and_jax(dp):
    jcfg, plain, tcfg, params = twins()
    jax_dp = TpuEmbedder(config=jcfg, params=plain.params, batch_size=16,
                         mesh=JaxMesh(np.array(jax.devices()[:dp]), ("dp",)))
    one = TorchEmbedder(config=tcfg, params=params, batch_size=16, device="cpu")
    same = TorchEmbedder(config=tcfg, params=params, batch_size=16,
                         mesh=Mesh(np.array(["cpu"] * dp, dtype=object), ("dp",)))
    apart = TorchEmbedder(config=tcfg, params=params, batch_size=16,
                          mesh=Mesh([torch.device("cpu", i) for i in range(dp)], ("dp",)))
    assert same._dp == apart._dp == jax_dp._dp == dp
    want = one.embed_batch(TEXTS)
    np.testing.assert_array_equal(same.embed_batch(TEXTS), want)  # one forward, one device
    np.testing.assert_allclose(apart.embed_batch(TEXTS), want, rtol=0, atol=EMB_TOL)
    np.testing.assert_allclose(want, jax_dp.embed_batch(TEXTS), rtol=0, atol=EMB_TOL)


def test_dp_embedder_non_pow2_device_count():
    """Batch buckets are multiples of dp: 6 devices take a bucket of 12."""
    jcfg, plain, tcfg, params = twins(n_layers=1)
    jax_dp = TpuEmbedder(config=jcfg, params=plain.params, batch_size=16,
                         mesh=JaxMesh(np.array(jax.devices()[:6]), ("dp",)))
    emb = TorchEmbedder(config=tcfg, params=params, batch_size=16,
                        mesh=Mesh([torch.device("cpu", i) for i in range(6)], ("dp",)))
    seen = []
    real = emb._forward
    emb._forward = lambda ids, mask: seen.append(ids.shape[0]) or real(ids, mask)
    out = emb.embed_batch(["alpha beta", "gamma", "delta epsilon zeta"])
    assert out.shape == (3, 64) and np.all(np.isfinite(out)) and seen == [12]
    np.testing.assert_allclose(out, jax_dp.embed_batch(["alpha beta", "gamma",
                                                        "delta epsilon zeta"]),
                               rtol=0, atol=EMB_TOL)


def test_kb_on_a_local_mesh_embeds_data_parallel():
    """The encoder provider on a local mesh: a dp embedder over the mesh's
    devices (a group mesh gets none, as in JAX); the hash provider ignores
    the mesh."""
    cfg = rag(PORT_CFG)
    cfg.knowledge_builder.embedding = EmbeddingConfig(provider="tpu")
    kb = KnowledgeBase("enc", cfg, mesh=port_mesh())
    assert isinstance(kb.embedder, TorchEmbedder) and kb.embedder._dp == S
    assert kb.store._mesh.shape == {"db": S}
    hashed = KnowledgeBase("hash", rag(PORT_CFG), mesh=port_mesh())
    assert type(hashed.embedder).__name__ == "HashEmbedder"
    emb = EmbedderFactory.create(EmbeddingConfig(provider="tpu"), device="cpu",
                                 mesh=Mesh(["cpu"] * 2, ("dp",)))
    assert emb._dp == 2
    with pytest.raises(ValueError, match="local mesh"):
        TorchEmbedder(config=EncoderConfig(**KW), mesh=Mesh(["cpu"] * 2, ("dp",),
                                                            distributed=True))
