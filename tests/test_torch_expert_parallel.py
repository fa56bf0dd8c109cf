"""The port's expert-parallel MoE encoder (``make_ep_encoder``,
``make_ep_encoder_a2a``, ``shard_params_ep``) against the JAX package's and
the unsharded ``moe_encode_tokens``, on the CPU: the cases of
``tests/parallel/test_expert_parallel.py`` on a local mesh of ``cpu``
slots (and of distinct ``cpu:i`` devices), JAX on its host devices, the
same numpy parameters (``moe_params_from_numpy``).

Tolerances are JAX's: 2e-5 on the embeddings, 2e-4 on the CLS state (f32).
Where tokens overflow a capacity, the port drops the same tokens as JAX
(the same slots, in the same order) and the outputs agree to the same
tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youtu_rag_tpu.models.encoder import EncoderConfig as JaxConfig
from youtu_rag_tpu.parallel import expert_parallel as jax_ep
from youtu_rag_tpu.parallel.mesh import get_mesh as jax_mesh
from youtu_rag_tpu_torch.models.convert import moe_params_from_numpy
from youtu_rag_tpu_torch.models.encoder import EncoderConfig
from youtu_rag_tpu_torch.parallel import expert_parallel as ep_mod
from youtu_rag_tpu_torch.parallel.mesh import Mesh
from torch_native_helpers import jax_tracer_restored  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("jax_tracer_restored")

EMB_TOL, CLS_TOL = 2e-5, 2e-4
KW = dict(vocab_size=256, d_model=32, n_layers=2, n_heads=4, d_ff=64, max_len=64, out_dim=16)
E = 8


@pytest.fixture(scope="module")
def twins():
    jcfg = JaxConfig(**KW, dtype=jnp.float32)
    tcfg = EncoderConfig(**KW, dtype=torch.float32)
    jparams = jax_ep.init_moe_params(jcfg, n_experts=E, seed=0)
    tparams = moe_params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, E)
    return jcfg, jparams, tcfg, tparams


def _batch(rng, b, t):
    ids = rng.integers(4, 256, size=(b, t)).astype(np.int32)
    mask = np.ones((b, t), np.float32)
    mask[:, t - 3:] = 0.0
    ids[mask == 0] = 0
    return ids, mask


def local_mesh(ep: int, apart: bool = False) -> Mesh:
    devs = [torch.device("cpu", i) for i in range(ep)] if apart else ["cpu"] * ep
    return Mesh(np.array(devs, dtype=object), ("ep",))


def port(fn, tparams, mesh, ids, mask):
    emb, cls = fn(ep_mod.shard_params_ep(tparams, mesh), torch.from_numpy(ids),
                  torch.from_numpy(mask))
    return emb.numpy(), cls.numpy()


def unsharded(tcfg, tparams, ids, mask):
    emb, cls = ep_mod.moe_encode_tokens(tparams, torch.from_numpy(ids), torch.from_numpy(mask),
                                        tcfg, E)
    return emb.numpy(), cls.numpy()


def assert_pair(got, want):
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=0, atol=EMB_TOL)
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=0, atol=CLS_TOL)


@pytest.mark.parametrize("ep", [2, 4, 8])
def test_ep_matches_unsharded_and_jax(twins, ep):
    jcfg, jparams, tcfg, tparams = twins
    ids, mask = _batch(np.random.default_rng(ep), b=3, t=24)
    got = port(ep_mod.make_ep_encoder(tcfg, local_mesh(ep), E), tparams, local_mesh(ep), ids,
               mask)
    assert_pair(got, unsharded(tcfg, tparams, ids, mask))
    mesh = jax_mesh({"ep": ep})
    assert_pair(got, jax_ep.make_ep_encoder(jcfg, mesh, n_experts=E)(
        jax_ep.shard_params_ep(jparams, mesh), ids, mask))


def test_ep_on_distinct_devices(twins):
    _, _, tcfg, tparams = twins
    ids, mask = _batch(np.random.default_rng(5), b=3, t=24)
    mesh = local_mesh(4, apart=True)
    assert_pair(port(ep_mod.make_ep_encoder(tcfg, mesh, E), tparams, mesh, ids, mask),
                unsharded(tcfg, tparams, ids, mask))


def test_expert_placement(twins):
    _, _, _, tparams = twins
    placed = ep_mod.shard_params_ep(tparams, local_mesh(4))
    (tree,) = placed
    shards = tree["layers"]["ew1"]
    assert len(shards) == 4 and shards[0].shape[1] == E // 4  # the expert dim split
    assert torch.equal(torch.cat(shards, dim=1), tparams["layers"]["ew1"])
    assert torch.equal(tree["layers"]["router"], tparams["layers"]["router"])  # replicated
    assert torch.equal(placed.gather()["layers"]["eb2"], tparams["layers"]["eb2"])


def test_routing_uses_multiple_experts(twins):
    _, _, _, tparams = twins
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 32, KW["d_model"]))
                         .astype(np.float32))
    idx, p, _ = ep_mod._route(x, tparams["layers"]["router"][0])
    assert len(torch.unique(idx)) > 1  # not a collapsed router
    assert float(p.min()) >= 1.0 / E  # top-1 probability at least uniform


@pytest.mark.parametrize("ep", [2, 4])
def test_a2a_dispatch_matches_unsharded_and_jax_when_dropless(twins, ep):
    """Capacity covering every token at both hops (cf = ep, ecf = E)."""
    jcfg, jparams, tcfg, tparams = twins
    ids, mask = _batch(np.random.default_rng(10 + ep), b=ep * 2, t=16)
    mesh = local_mesh(ep)
    fn = ep_mod.make_ep_encoder_a2a(tcfg, mesh, E, capacity_factor=float(ep),
                                    expert_capacity_factor=float(E))
    got = port(fn, tparams, mesh, ids, mask)
    assert_pair(got, unsharded(tcfg, tparams, ids, mask))
    jmesh = jax_mesh({"ep": ep})
    assert_pair(got, jax_ep.make_ep_encoder_a2a(
        jcfg, jmesh, n_experts=E, capacity_factor=float(ep), expert_capacity_factor=float(E))(
        jax_ep.shard_params_ep(jparams, jmesh), ids, mask))


@pytest.mark.parametrize("cf,ecf", [(0.1, 2.0), (1.0, 0.5)], ids=["dest-cap", "expert-cap"])
def test_a2a_overflow_drops_as_jax_does(twins, cf, ecf):
    """A capacity too small at the first hop (per destination) or the second
    (per expert): the outputs differ from the dropless ones, stay finite and
    unit-norm, and equal JAX's, which drops the same tokens."""
    jcfg, jparams, tcfg, tparams = twins
    ids, mask = _batch(np.random.default_rng(20), b=4, t=16)
    mesh = local_mesh(4)
    got = port(ep_mod.make_ep_encoder_a2a(tcfg, mesh, E, capacity_factor=cf,
                                          expert_capacity_factor=ecf), tparams, mesh, ids, mask)
    assert np.isfinite(got[0]).all()
    np.testing.assert_allclose(np.linalg.norm(got[0], axis=1), 1.0, atol=1e-5)
    full = port(ep_mod.make_ep_encoder_a2a(tcfg, mesh, E, capacity_factor=4.0,
                                           expert_capacity_factor=float(E)),
                tparams, mesh, ids, mask)
    assert np.abs(got[0] - full[0]).max() > 1e-6
    jmesh = jax_mesh({"ep": 4})
    assert_pair(got, jax_ep.make_ep_encoder_a2a(
        jcfg, jmesh, n_experts=E, capacity_factor=cf, expert_capacity_factor=ecf)(
        jax_ep.shard_params_ep(jparams, jmesh), ids, mask))


def test_a2a_needs_the_batch_to_split_and_experts_to_divide(twins):
    _, _, tcfg, tparams = twins
    mesh = local_mesh(4)
    fn = ep_mod.make_ep_encoder_a2a(tcfg, mesh, E)
    with pytest.raises(ValueError, match="batch 3 does not split over ep = 4"):
        fn(ep_mod.shard_params_ep(tparams, mesh), torch.ones((3, 8), dtype=torch.long),
           torch.ones((3, 8)))
    with pytest.raises(ValueError, match="8 experts do not split over ep = 3"):
        ep_mod.make_ep_encoder(tcfg, local_mesh(3), E)
