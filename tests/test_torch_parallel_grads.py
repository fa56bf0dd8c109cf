"""Gradients through the port's parallel forwards, on the CPU: the cases of
``tests/parallel/test_parallel_grads.py``. A shared scalar loss is
differentiated through the ring (sp 4), the ring with Megatron TP inside
(sp 2 × tp 2 on a local mesh) and the expert-parallel forward (ep 4), and
the parameters' gradients match the unsharded forward's (the split
experts' gradients gathered from their shards), and JAX's through its own
sharded forwards, within JAX's atol 5e-4 (f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youtu_rag_tpu.models.encoder import EncoderConfig as JaxConfig
from youtu_rag_tpu.models.encoder import init_encoder_params as jax_init
from youtu_rag_tpu.parallel import expert_parallel as jax_ep
from youtu_rag_tpu.parallel.mesh import get_mesh as jax_mesh
from youtu_rag_tpu.parallel.sequence_parallel import make_sp_encoder as jax_sp
from youtu_rag_tpu_torch.models.convert import encoder_params_from_numpy, moe_params_from_numpy
from youtu_rag_tpu_torch.models.encoder import EncoderConfig, encode_tokens
from youtu_rag_tpu_torch.models.train import leaves
from youtu_rag_tpu_torch.parallel import expert_parallel as port_ep
from youtu_rag_tpu_torch.parallel.mesh import Mesh
from youtu_rag_tpu_torch.parallel.sequence_parallel import make_sp_encoder
from torch_native_helpers import jax_tracer_restored  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("jax_tracer_restored")

ATOL = 5e-4
KW = dict(vocab_size=256, d_model=32, n_layers=2, n_heads=4, d_ff=64, max_len=64, out_dim=16)


@pytest.fixture(scope="module")
def cfgs():
    return JaxConfig(**KW, dtype=jnp.float32), EncoderConfig(**KW, dtype=torch.float32)


def _batch(rng, b, t):
    ids = rng.integers(4, 256, size=(b, t)).astype(np.int32)
    mask = np.ones((b, t), np.float32)
    mask[:, -2:] = 0.0
    return ids, mask


def port_grads(fwd, params, ids, mask, target) -> list[torch.Tensor]:
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    emb, _ = fwd(params, torch.from_numpy(ids), torch.from_numpy(mask))
    loss = torch.sum((emb.float() - torch.from_numpy(target)) ** 2)
    grads = torch.autograd.grad(loss, ps, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(ps, grads)]  # unused: 0


def jax_grads(fwd, params, ids, mask, target):
    def loss(p):
        emb, _ = fwd(p, ids, mask)
        return jnp.sum((emb.astype(jnp.float32) - target) ** 2)

    return jax.grad(loss)(params)


def assert_close(got: list, want: list):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=ATOL,
                                   err_msg=str(i))


def jax_leaves(tree: dict, like: dict) -> list:
    """JAX's gradient tree in the order of the port's ``leaves(like)``."""
    out = []
    for k, v in like.items():
        out.extend(jax_leaves(tree[k], v) if isinstance(v, dict) else [tree[k]])
    return out


def test_grads_through_ring_attention(cfgs):
    jcfg, tcfg = cfgs
    rng = np.random.default_rng(0)
    ids, mask = _batch(rng, b=2, t=32)
    target = rng.normal(size=(2, 16)).astype(np.float32)
    jparams = jax_init(jcfg, seed=0)
    tree = jax.tree.map(np.asarray, jparams)
    got = port_grads(make_sp_encoder(tcfg, 4), encoder_params_from_numpy(tree, tcfg), ids, mask,
                     target)
    ref = port_grads(lambda p, i, m: encode_tokens(p, i, m, tcfg),
                     encoder_params_from_numpy(tree, tcfg), ids, mask, target)
    assert_close(got, [r.numpy() for r in ref])
    want = jax_grads(jax_sp(jcfg, jax_mesh({"sp": 4})), jparams, ids, mask, target)
    assert_close(got, jax_leaves(want, encoder_params_from_numpy(tree, tcfg)))


def test_grads_through_sp_tp(cfgs):
    jcfg, tcfg = cfgs
    rng = np.random.default_rng(1)
    ids, mask = _batch(rng, b=2, t=16)
    target = rng.normal(size=(2, 16)).astype(np.float32)
    jparams = jax_init(jcfg, seed=0)
    tree = jax.tree.map(np.asarray, jparams)
    mesh = Mesh(np.array(["cpu"] * 4, dtype=object).reshape(2, 2), ("sp", "tp"))
    got = port_grads(make_sp_encoder(tcfg, mesh, tp_axis="tp"),
                     encoder_params_from_numpy(tree, tcfg), ids, mask, target)
    ref = port_grads(lambda p, i, m: encode_tokens(p, i, m, tcfg),
                     encoder_params_from_numpy(tree, tcfg), ids, mask, target)
    assert_close(got, [r.numpy() for r in ref])
    want = jax_grads(jax_sp(jcfg, jax_mesh({"sp": 2, "tp": 2}), tp_axis="tp"), jparams, ids,
                     mask, target)
    assert_close(got, jax_leaves(want, encoder_params_from_numpy(tree, tcfg)))


def _rebuild(tree, grads: list):
    """``tree``'s structure (dicts and lists) with its tensors replaced by
    ``grads`` in ``leaves`` order."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, grads) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, grads) for v in tree]
    return grads.pop(0)


def test_grads_through_expert_parallel(cfgs):
    jcfg, tcfg = cfgs
    rng = np.random.default_rng(2)
    ids, mask = _batch(rng, b=2, t=16)
    target = rng.normal(size=(2, 16)).astype(np.float32)
    jparams = jax_ep.init_moe_params(jcfg, n_experts=4, seed=0)
    tree = jax.tree.map(np.asarray, jparams)
    mesh = Mesh(np.array(["cpu"] * 4, dtype=object), ("ep",))
    placed = port_ep.shard_params_ep(moe_params_from_numpy(tree, tcfg, 4), mesh)
    grads = port_grads(port_ep.make_ep_encoder(tcfg, mesh, 4), placed, ids, mask, target)
    full = placed.placement.gather([_rebuild(placed[0], grads)])
    ref_params = moe_params_from_numpy(tree, tcfg, 4)
    ref = port_grads(lambda p, i, m: port_ep.moe_encode_tokens(p, i, m, tcfg, 4), ref_params,
                     ids, mask, target)
    got = leaves(full)
    assert_close(got, [r.numpy() for r in ref])
    want = jax_grads(jax_ep.make_ep_encoder(jcfg, jax_mesh({"ep": 4}), n_experts=4),
                     jax_ep.shard_params_ep(jparams, jax_mesh({"ep": 4})), ids, mask, target)
    assert_close(got, jax_leaves(want, ref_params))
