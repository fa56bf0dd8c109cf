"""The port's sequence-parallel encoder (``youtu_rag_tpu_torch.parallel``)
against the JAX package's ``make_sp_encoder`` and the port's unsharded
``encode_tokens``, on the CPU.

The cases of ``tests/parallel/test_sequence_parallel.py`` but the two
tensor-parallel ones, with the ring as an int S (the shards on one
device); JAX runs on its 8 virtual CPU devices, the flash hop in interpret
mode. The same parameters go to both packages (numpy through
``encoder_params_from_numpy``). Tolerances are JAX's own: 2e-5 on the
embeddings, 2e-4 on the CLS state (f32; sums in another order).

The group ring (a ``torch.distributed`` process group, one shard per
rank) runs on gloo in 4 spawned CPU processes that meet through a
``FileStore`` under ``tmp_path``; each spawn has its own deadline.
"""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from youtu_rag_tpu.models.encoder import EncoderConfig as JaxConfig
from youtu_rag_tpu.models.encoder import init_encoder_params as jax_init
from youtu_rag_tpu.parallel.mesh import get_mesh
from youtu_rag_tpu.parallel.sequence_parallel import make_sp_encoder as jax_sp
from youtu_rag_tpu.parallel.sequence_parallel import pad_to_multiple as jax_pad
from youtu_rag_tpu_torch.models.convert import encoder_params_from_numpy
from youtu_rag_tpu_torch.models.encoder import EncoderConfig, encode_tokens
from youtu_rag_tpu_torch.parallel import make_sp_encoder, pad_to_multiple

sys.path.insert(0, os.path.dirname(__file__))
import torch_sp_workers  # noqa: E402

EMB_TOL, CLS_TOL = 2e-5, 2e-4
SMALL = dict(vocab_size=256, d_model=32, n_layers=2, n_heads=4, d_ff=64, max_len=128, out_dim=16)
FLASH = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=2, d_ff=128, max_len=1024,
             out_dim=16)
SPAWN_TIMEOUT_S = 60


def _batch(rng, b, t, frac_pad=0.25):
    """JAX's test batch: random ids, ragged padding tails."""
    ids = rng.integers(4, 256, size=(b, t)).astype(np.int32)
    mask = np.ones((b, t), np.float32)
    for i in range(b):
        cut = t - rng.integers(0, int(t * frac_pad) + 1)
        mask[i, cut:] = 0.0
        ids[i, cut:] = 0
    return ids, mask


def configs(kw, impl="xla", seed=0):
    """The same f32 encoder in both packages: (jax cfg, jax params, port
    cfg, port params)."""
    jcfg = JaxConfig(**kw, dtype=jnp.float32, attention_impl=impl)
    tcfg = EncoderConfig(**kw, dtype=torch.float32, attention_impl=impl)
    jparams = jax_init(jcfg, seed=seed)
    return jcfg, jparams, tcfg, encoder_params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)


def port_sp(tcfg, tparams, sp, ids, mask):
    emb, cls = make_sp_encoder(tcfg, sp)(tparams, torch.from_numpy(ids), torch.from_numpy(mask))
    return emb.numpy(), cls.numpy()


def unsharded(tcfg, tparams, ids, mask):
    emb, cls = encode_tokens(tparams, torch.from_numpy(ids), torch.from_numpy(mask), tcfg)
    return emb.numpy(), cls.numpy()


def assert_pair(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=EMB_TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=CLS_TOL)


@pytest.fixture(scope="module")
def small():
    return configs(SMALL)


def test_sp_matches_unsharded_and_jax(small):
    jcfg, jparams, tcfg, tparams = small
    ids, mask = _batch(np.random.default_rng(0), b=3, t=64)
    got = port_sp(tcfg, tparams, 4, ids, mask)
    assert_pair(got, unsharded(tcfg, tparams, ids, mask))
    want = jax_sp(jcfg, get_mesh({"sp": 4}))(jparams, ids, mask)
    assert_pair(got, tuple(np.asarray(x) for x in want))


def test_sp_with_dp_split_matches_jax_dp_axis(small):
    """dp × sp is the caller's: each half of the batch through its own ring
    equals JAX's dp 2 × sp 4 mesh and the unsharded forward."""
    jcfg, jparams, tcfg, tparams = small
    ids, mask = _batch(np.random.default_rng(1), b=4, t=32)
    halves = [port_sp(tcfg, tparams, 4, ids[s], mask[s]) for s in (slice(0, 2), slice(2, 4))]
    got = np.concatenate([h[0] for h in halves])
    np.testing.assert_allclose(got, unsharded(tcfg, tparams, ids, mask)[0], atol=EMB_TOL)
    want, _ = jax_sp(jcfg, get_mesh({"dp": 2, "sp": 4}), dp_axis="dp")(jparams, ids, mask)
    np.testing.assert_allclose(got, np.asarray(want), atol=EMB_TOL)


def test_sp_ring_sees_all_shards(small):
    """A token changed in the last shard moves the embedding, as in JAX:
    the ring carries K/V, not only local attention."""
    jcfg, jparams, tcfg, tparams = small
    ids, mask = _batch(np.random.default_rng(2), b=1, t=64, frac_pad=0.0)
    ids2 = ids.copy()
    ids2[0, -1] = (ids2[0, -1] + 7) % 256
    base, pert = (port_sp(tcfg, tparams, 4, x, mask)[0] for x in (ids, ids2))
    assert np.abs(base - pert).max() > 1e-6
    jfn = jax_sp(jcfg, get_mesh({"sp": 4}))
    np.testing.assert_allclose(pert, np.asarray(jfn(jparams, ids2, mask)[0]), atol=EMB_TOL)


def test_pad_to_multiple_parity(small):
    """Padding to the ring multiple (sp 8) changes nothing."""
    jcfg, jparams, tcfg, tparams = small
    ids, mask = _batch(np.random.default_rng(3), b=2, t=24, frac_pad=0.0)
    pid, pmask = pad_to_multiple(ids, mask, 32)
    jid, jmask = jax_pad(ids, mask, 32)
    assert pid.shape == (2, 32)
    np.testing.assert_array_equal(pid, jid)
    np.testing.assert_array_equal(pmask, jmask)
    got = port_sp(tcfg, tparams, 8, pid, pmask)
    np.testing.assert_allclose(got[0], unsharded(tcfg, tparams, ids, mask)[0], atol=EMB_TOL)
    want = jax_sp(jcfg, get_mesh({"sp": 8}))(jparams, pid, pmask)
    assert_pair(got, tuple(np.asarray(x) for x in want))


def test_sp_flash_hop_matches_xla_ring_and_jax():
    """The flash hop ("pallas_interpret": flash_attention_stats' plain
    version, Tl = 256 on sp 4) against the plain ring, the unsharded
    forward and JAX's flash hop in interpret mode."""
    jx, jparams, tx, tparams = configs(FLASH, "xla", seed=7)
    jf = JaxConfig(**FLASH, dtype=jnp.float32, attention_impl="pallas_interpret")
    tf = EncoderConfig(**FLASH, dtype=torch.float32, attention_impl="pallas_interpret")
    ids, mask = _batch(np.random.default_rng(7), b=2, t=1024)
    got = port_sp(tf, tparams, 4, ids, mask)
    assert_pair(got, port_sp(tx, tparams, 4, ids, mask))
    np.testing.assert_allclose(got[0], unsharded(tx, tparams, ids, mask)[0], atol=EMB_TOL)
    want = jax_sp(jf, get_mesh({"sp": 4}))(jparams, ids, mask)
    assert_pair(got, tuple(np.asarray(x) for x in want))


def test_sp_flash_hop_takes_the_stats_wrapper(monkeypatch):
    """"pallas" takes flash_attention_stats once per hop per layer, and
    only where Tl >= 256 (shorter shards take the plain ring)."""
    import youtu_rag_tpu_torch.parallel.sequence_parallel as sp

    calls = []
    real = sp.flash_attention_stats
    monkeypatch.setattr(sp, "flash_attention_stats", lambda *a: calls.append(a) or real(*a))
    _, _, tcfg, tparams = configs(FLASH, "pallas", seed=7)
    ids, mask = _batch(np.random.default_rng(8), b=1, t=1024)
    port_sp(tcfg, tparams, 4, ids, mask)
    assert len(calls) == tcfg.n_layers * 4
    assert tuple(calls[0][0].shape) == (4, 2, 256, 64)  # the 4 shards folded into the batch
    calls.clear()
    port_sp(tcfg, tparams, 4, ids[:, :512], mask[:, :512])  # Tl = 128
    assert not calls


def test_sp_single_device_ring(small):
    jcfg, jparams, tcfg, tparams = small
    ids, mask = _batch(np.random.default_rng(4), b=2, t=16)
    got = port_sp(tcfg, tparams, 1, ids, mask)
    np.testing.assert_allclose(got[0], unsharded(tcfg, tparams, ids, mask)[0], atol=EMB_TOL)
    want = jax_sp(jcfg, get_mesh({"sp": 1}, devices=jax.devices()[:1]))(jparams, ids, mask)
    assert_pair(got, tuple(np.asarray(x) for x in want))


def test_tp_axis_raises_not_implemented(small):
    with pytest.raises(NotImplementedError, match="Queue A 8"):
        make_sp_encoder(small[2], 4, tp_axis="tp")


def test_rope_offset_matches_the_unsharded_positions():
    """``_rope`` with a shard's start equals the slice of the unsharded
    rotation, in f32 and bf16, for a number and a per-row tensor offset."""
    from youtu_rag_tpu_torch.models.encoder import _rope

    x = torch.randn(2, 3, 64, 16)
    for dt in (torch.float32, torch.bfloat16):
        full = _rope(x.to(dt), 10000.0)
        assert torch.equal(_rope(x[:, :, 48:].to(dt), 10000.0, 48), full[:, :, 48:])
        off = torch.tensor([0.0, 32.0]).view(2, 1, 1, 1)
        parts = _rope(torch.stack([x[0, :, :32], x[1, :, 32:]]).to(dt), 10000.0, off)
        assert torch.equal(parts[0], full[0, :, :32]) and torch.equal(parts[1], full[1, :, 32:])


def spawn_ranks(mode: str, tmp_path, world: int = 4) -> list[dict]:
    """Run ``torch_sp_workers.run`` in ``world`` spawned processes on gloo;
    fail after SPAWN_TIMEOUT_S. Returns each rank's saved arrays."""
    store = str(tmp_path / f"store-{mode}")
    ctx = mp.start_processes(torch_sp_workers.run, args=(world, store, mode, str(tmp_path)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                pytest.fail(f"{mode}: the {world} gloo processes did not finish in "
                            f"{SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [dict(np.load(tmp_path / f"{mode}-{r}.npz")) for r in range(world)]


@pytest.mark.parametrize("mode", ["sp4", "sp4_flash"])
def test_group_ring_on_gloo_equals_the_local_ring(mode, tmp_path):
    """sp 4 over 4 gloo processes: every rank returns what the ring of 4
    shards on one device returns, and the unsharded forward."""
    cfg, params, ids, mask = torch_sp_workers.inputs(mode)
    local = make_sp_encoder(cfg, 4)(params, ids, mask)
    ref, _ = encode_tokens(params, ids, mask, EncoderConfig(**{**torch_sp_workers.CASES[mode][0],
                                                              "attention_impl": "xla"}))
    for out in spawn_ranks(mode, tmp_path):
        np.testing.assert_allclose(out["emb"], local[0].numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(out["cls"], local[1].numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(out["emb"], ref.numpy(), rtol=0, atol=EMB_TOL)


def test_dp2_sp2_on_gloo_equals_the_unsharded_forward(tmp_path):
    """Two sp groups of 2 ranks, each given half the batch (dp 2 × sp 2)."""
    cfg, params, ids, mask = torch_sp_workers.inputs("dp2_sp2")
    emb, cls = encode_tokens(params, ids, mask, cfg)
    outs = spawn_ranks("dp2_sp2", tmp_path)
    for out in outs:
        rows = out["rows"]
        np.testing.assert_allclose(out["emb"], emb.numpy()[rows], rtol=0, atol=EMB_TOL)
        np.testing.assert_allclose(out["cls"], cls.numpy()[rows], rtol=0, atol=CLS_TOL)
    assert sorted({int(r) for out in outs for r in out["rows"]}) == list(range(ids.shape[0]))
