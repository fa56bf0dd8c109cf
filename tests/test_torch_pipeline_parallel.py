"""The port's pipeline-parallel encoder (``parallel/pipeline_parallel.py``)
against the JAX package's ``make_pp_encoder`` and the unsharded forward, on
the CPU: the cases of ``tests/parallel/test_pipeline_parallel.py`` on a
local mesh of ``cpu`` slots (and of distinct ``cpu:i`` devices, where each
hop is a copy), JAX on its 8 host devices, the same numpy parameters
(``encoder_params_from_numpy``). Tolerances are JAX's: 2e-5 on the
embeddings, 2e-4 on the CLS state (f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youtu_rag_tpu.models.encoder import EncoderConfig as JaxConfig
from youtu_rag_tpu.models.encoder import init_encoder_params as jax_init
from youtu_rag_tpu.parallel.mesh import get_mesh as jax_mesh
from youtu_rag_tpu.parallel.pipeline_parallel import make_pp_encoder as jax_pp
from youtu_rag_tpu.parallel.pipeline_parallel import shard_params_pp as jax_shard
from youtu_rag_tpu_torch.models.convert import encoder_params_from_numpy
from youtu_rag_tpu_torch.models.encoder import EncoderConfig, encode_tokens
from youtu_rag_tpu_torch.parallel.mesh import Mesh
from youtu_rag_tpu_torch.parallel.pipeline_parallel import make_pp_encoder, shard_params_pp
from torch_native_helpers import jax_tracer_restored  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("jax_tracer_restored")

EMB_TOL, CLS_TOL = 2e-5, 2e-4
KW = dict(vocab_size=256, d_model=32, n_layers=4, n_heads=4, d_ff=64, max_len=64, out_dim=16)


@pytest.fixture(scope="module")
def twins():
    jcfg = JaxConfig(**KW, dtype=jnp.float32)
    tcfg = EncoderConfig(**KW, dtype=torch.float32)
    jparams = jax_init(jcfg, seed=0)
    return jcfg, jparams, tcfg, encoder_params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)


def _batch(rng, b, t):
    ids = rng.integers(4, 256, size=(b, t)).astype(np.int32)
    mask = np.ones((b, t), np.float32)
    for i in range(b):
        mask[i, t - rng.integers(0, t // 4 + 1):] = 0.0
    ids[mask == 0] = 0
    return ids, mask


def local_mesh(stages: int, apart: bool = False) -> Mesh:
    devs = [torch.device("cpu", i) for i in range(stages)] if apart else ["cpu"] * stages
    return Mesh(np.array(devs, dtype=object), ("pp",))


def run_port(tcfg, tparams, mesh, ids, mask, n_micro=None):
    emb, cls = make_pp_encoder(tcfg, mesh, n_micro=n_micro)(
        shard_params_pp(tparams, mesh), torch.from_numpy(ids), torch.from_numpy(mask))
    return emb.numpy(), cls.numpy()


@pytest.mark.parametrize("apart", [False, True], ids=["one-device", "cpu-i"])
@pytest.mark.parametrize("stages", [2, 4])
def test_pp_matches_unsharded_and_jax(twins, stages, apart):
    jcfg, jparams, tcfg, tparams = twins
    ids, mask = _batch(np.random.default_rng(stages), b=8, t=32)
    emb, cls = run_port(tcfg, tparams, local_mesh(stages, apart), ids, mask)
    ref = encode_tokens(tparams, torch.from_numpy(ids), torch.from_numpy(mask), tcfg)
    np.testing.assert_allclose(emb, ref[0].numpy(), rtol=0, atol=EMB_TOL)
    np.testing.assert_allclose(cls, ref[1].numpy(), rtol=0, atol=CLS_TOL)
    mesh = jax_mesh({"pp": stages})
    want = jax_pp(jcfg, mesh)(jax_shard(jparams, mesh), ids, mask)
    np.testing.assert_allclose(emb, np.asarray(want[0]), rtol=0, atol=EMB_TOL)
    np.testing.assert_allclose(cls, np.asarray(want[1]), rtol=0, atol=CLS_TOL)


def test_pp_more_microbatches(twins):
    jcfg, jparams, tcfg, tparams = twins
    ids, mask = _batch(np.random.default_rng(9), b=8, t=16)
    emb, _ = run_port(tcfg, tparams, local_mesh(2), ids, mask, n_micro=4)
    mesh = jax_mesh({"pp": 2})
    want = jax_pp(jcfg, mesh, n_micro=4)(jax_shard(jparams, mesh), ids, mask)
    np.testing.assert_allclose(emb, np.asarray(want[0]), rtol=0, atol=EMB_TOL)


def test_pp_schedule_runs_each_stage_once_per_microbatch(twins, monkeypatch):
    """The fill-drain ticks: stage s takes microbatch t - s at tick t, so
    every (stage, microbatch) pair runs once and the layers run M·L times."""
    import youtu_rag_tpu_torch.parallel.pipeline_parallel as pp

    _, _, tcfg, tparams = twins
    seen = []
    real = pp._preln_layer
    monkeypatch.setattr(pp, "_preln_layer", lambda *a: seen.append(a[0].shape) or real(*a))
    ids, mask = _batch(np.random.default_rng(3), b=8, t=16)
    run_port(tcfg, tparams, local_mesh(4), ids, mask, n_micro=4)
    assert len(seen) == 4 * tcfg.n_layers and all(s == (2, 16, 32) for s in seen)


def test_pp_param_placement(twins):
    """Each stage holds n_layers / S layers on its device; the rest is
    replicated."""
    _, _, _, tparams = twins
    placed = shard_params_pp(tparams, local_mesh(4, apart=True))
    assert len(placed["layers"]) == 4
    assert all(stage["wq"].shape[0] == KW["n_layers"] // 4 for stage in placed["layers"])
    for s, stage in enumerate(placed["layers"]):
        assert torch.equal(stage["wq"], tparams["layers"]["wq"][s : s + 1])
    assert torch.equal(placed["tok_emb"], tparams["tok_emb"])


def test_pp_batch_must_divide(twins):
    _, _, tcfg, tparams = twins
    mesh = local_mesh(4)
    fn = make_pp_encoder(tcfg, mesh)
    with pytest.raises(ValueError, match="must divide into 4 microbatches"):
        fn(shard_params_pp(tparams, mesh), torch.ones((3, 16), dtype=torch.long),
           torch.ones((3, 16)))
    with pytest.raises(ValueError, match="do not split into 3 stages"):
        make_pp_encoder(tcfg, local_mesh(3))
