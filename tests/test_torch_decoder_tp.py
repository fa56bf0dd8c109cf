"""Tensor-parallel decoding on a ('dp', 'tp') mesh (``shard_decoder``,
``tp_generate``, ``tp_prefill``, ``tp_decode_step`` in
``youtu_rag_tpu_torch/models/decoder.py``) against the replicated run and
the JAX package's TP ``generate`` (``decoder_sharding_spec`` placed on a
('dp', 'tp') mesh of its host devices, ``__graft_entry__.py``'s check), on
the CPU at f32.

Tolerances: greedy tokens and lengths equal (TP sums the heads' and the
FFN's partial products in another order, ~1e-7 at f32); prefill logits
within 1e-5 of the replicated run's; the int8 KV cache a TP prefill writes
against the replicated cache's slice of its heads: scales within 1e-6
relative and values within one step (a shard's q/k/v GEMM is narrower, so
f32 k and v differ by an ulp, as ``tests/test_torch_decoder.py`` states
between the packages)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from youtu_rag_tpu.models import decoder as jd
from youtu_rag_tpu.parallel.mesh import get_mesh as jax_get_mesh
from youtu_rag_tpu_torch.models import decoder as td
from youtu_rag_tpu_torch.models.convert import decoder_params_from_numpy
from youtu_rag_tpu_torch.parallel import get_mesh
from torch_native_helpers import jax_tracer_restored  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("jax_tracer_restored")

LOGIT_TOL = 1e-5
# name → (arch, n_kv_heads, tie_embeddings, qkv_bias)
ARCHS = {
    "gpt2": ("gpt2", 4, True, False),
    "llama-gqa-tied": ("llama", 2, True, False),
    "qwen2-untied-bias": ("llama", 2, False, True),
}
PROMPTS = [[3, 1, 4, 1], [5, 9, 2], [6, 5, 3, 5, 8], [9, 7]]


def configs(name, kv="native"):
    arch, n_kv, tie, bias = ARCHS[name]
    kw = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=n_kv, d_ff=128,
              max_len=64, arch=arch, tie_embeddings=tie, qkv_bias=bias, eos_token_id=0,
              kv_cache_dtype=kv)
    return jd.DecoderConfig(dtype=jnp.float32, **kw), td.DecoderConfig(dtype=torch.float32, **kw)


def twins(name, kv="native"):
    """JAX's seeded parameters and the port's copy of them."""
    jcfg, tcfg = configs(name, kv)
    jparams = jd.init_decoder_params(jcfg, seed=7)
    return jcfg, tcfg, jparams, decoder_params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)


def jax_tp_generate(jcfg, jparams, toks, mask, dp, tp, new):
    """JAX's TP generate: parameters and tokens placed by its specs."""
    mesh = jax_get_mesh({"dp": dp, "tp": tp}, devices=jax.devices()[: dp * tp])
    flat, treedef = jax.tree_util.tree_flatten(jparams)
    spec = treedef.flatten_up_to(jd.decoder_sharding_spec(jcfg))
    sh = jax.tree_util.tree_unflatten(treedef, [jax.device_put(x, NamedSharding(mesh, s))
                                                for x, s in zip(flat, spec)])
    data = NamedSharding(mesh, P("dp", None))
    out, lengths = jd.generate(sh, jax.device_put(jnp.asarray(toks), data),
                               jax.device_put(jnp.asarray(mask), data), jax.random.PRNGKey(0),
                               cfg=jcfg, max_new_tokens=new)
    return np.asarray(out), np.asarray(lengths)


@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("name", list(ARCHS))
@pytest.mark.parametrize("dp, tp", [(1, 2), (2, 2)])
def test_tp_generate_equals_replicated_and_jax(name, kv, dp, tp):
    jcfg, tcfg, jparams, params = twins(name, kv)
    toks, mask = td.left_pad_batch(PROMPTS, pad_id=0, bucket=False)
    want, want_len = td.generate(params, torch.from_numpy(toks), torch.from_numpy(mask), tcfg,
                                 max_new_tokens=12)
    tpd = td.shard_decoder(params, tcfg, get_mesh({"dp": dp, "tp": tp}, devices=["cpu"] * dp * tp))
    got, got_len = td.tp_generate(tpd, torch.from_numpy(toks), torch.from_numpy(mask),
                                  max_new_tokens=12)
    assert torch.equal(got, want) and torch.equal(got_len, want_len)
    jout, jlen = jax_tp_generate(jcfg, jparams, toks, mask, dp, tp, 12)
    np.testing.assert_array_equal(got.numpy(), jout)
    np.testing.assert_array_equal(got_len.numpy(), jlen)


@pytest.mark.parametrize("name", ["gpt2", "qwen2-untied-bias"])
def test_tp_prefill_and_decode_step_match_replicated(name):
    """One prefill and one decode step on tp 4 (one kv head a shard for
    qwen2-like GQA with 2 kv heads: tp 2): logits, and the int8 caches each
    shard writes equal to its heads of the replicated cache."""
    _, tcfg, _, params = twins(name, "int8")
    tp = tcfg.n_kv_heads
    toks, mask = (torch.from_numpy(a) for a in td.left_pad_batch(PROMPTS, 0, bucket=False))
    b, t = toks.shape
    cache = td.init_cache(tcfg, b, t + 2)
    want, _ = td.prefill(params, toks, mask, cache, tcfg)
    tpd = td.shard_decoder(params, tcfg, get_mesh({"tp": tp}, devices=["cpu"] * tp))
    caches = tpd.init_cache(b, t + 2)
    got = td.tp_prefill(tpd, toks, mask, caches)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=LOGIT_TOL)
    per = tcfg.n_kv_heads // tp
    for j, c in enumerate(caches[0]):
        heads = slice(j * per, (j + 1) * per)
        for key in ("k", "v"):
            diff = (c[key].int() - cache[key][:, :, heads].int()).abs()
            assert int(diff.max()) <= 1, key
        for key in ("k_scale", "v_scale"):
            np.testing.assert_allclose(c[key].numpy(), cache[key][:, :, heads].numpy(),
                                       rtol=1e-6, atol=0)
    tok = torch.argmax(want, -1).to(torch.int32)
    attn = torch.cat([mask, torch.zeros(b, 2)], -1)
    attn[:, t] = 1.0
    pos = mask.sum(-1).to(torch.int32)
    want2, _ = td.decode_step(params, tok, t, attn, pos, cache, tcfg)
    got2 = td.tp_decode_step(tpd, tok, t, attn, pos, caches)
    np.testing.assert_allclose(got2.numpy(), want2.numpy(), rtol=0, atol=LOGIT_TOL)


def test_sharding_specs_follow_jax():
    """The specs name JAX's splits (``wqkv`` for JAX's wq, wk and wv); a
    width tp does not divide raises."""
    for name in ARCHS:
        jcfg, tcfg = configs(name, "int8")
        jspec, tspec = jd.decoder_sharding_spec(jcfg), td.decoder_sharding_spec(tcfg)
        for k, v in jspec["layers"].items():
            key = {"wq": "wqkv", "wk": "wqkv", "wv": "wqkv", "bq": "bqkv", "bk": "bqkv",
                   "bv": "bqkv"}.get(k, k)
            assert tuple(v) == tspec["layers"][key], k
        assert {k: tuple(v) for k, v in jspec.items() if k != "layers"} == \
            {k: v for k, v in tspec.items() if k != "layers"}
        assert {k: tuple(v) for k, v in jd.cache_sharding_spec(jcfg).items()} == \
            td.cache_sharding_spec(tcfg)
    _, tcfg, _, params = twins("llama-gqa-tied")
    with pytest.raises(ValueError, match="n_kv_heads 2 does not split over tp = 4"):
        td.shard_decoder(params, tcfg, get_mesh({"tp": 4}, devices=["cpu"] * 4))
