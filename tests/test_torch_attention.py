"""The port's attention (``youtu_rag_tpu_torch/ops/attention.py``) against
the JAX package's Pallas kernels run in interpret mode, on the CPU.

Same numpy inputs through both, with padded keys and a batch row whose
every key is masked. Tolerances:
- f32: 1e-5 absolute; the same algorithm, f32 sums in another order
  (2.7e-7 seen);
- bf16: one bf16 ulp of the output (rtol 2^-7, the largest gap between two
  neighbouring bf16 values relative to either, plus 2^-10 absolute for
  outputs near zero): a sum taken in another order can land a value on the
  other side of a bf16 rounding, of ``p`` or of the output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youtu_rag_tpu.ops.attention import blockwise_attention as jax_blockwise
from youtu_rag_tpu.ops.attention import flash_attention as jax_flash
from youtu_rag_tpu.ops.attention import flash_attention_stats as jax_stats
from youtu_rag_tpu_torch.ops.attention import (
    CLAMP,
    blockwise_attention,
    blockwise_attention_reference,
    flash_attention,
    flash_attention_reference,
    flash_attention_stats,
    flash_attention_stats_reference,
)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def assert_close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2**-7, atol=2**-10)


def make_inputs(t, hd=64, b=2, h=2, seed=0):
    """q, k, v [b, h, t, hd] f32 and the encoder's -1e9 padding bias: row 0
    padded past t/2 + 3, row 1 (when b > 1) fully masked."""
    rng = np.random.default_rng(seed + t + hd)
    q, k, v = (rng.standard_normal((b, h, t, hd)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, t), np.float32)
    mask[0, t // 2 + 3 :] = 0.0
    mask[1:, :] = 0.0
    return q, k, v, (1.0 - mask) * -1e9


def both(arrays, dtype):
    jdt, tdt = DTYPES[dtype]
    *qkv, bias = arrays
    j = [jnp.asarray(x).astype(jdt) for x in qkv] + [jnp.asarray(bias)]
    t = [torch.from_numpy(x).to(tdt) for x in qkv] + [torch.from_numpy(bias)]
    return j, t


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("t", [256, 512, 1024])
def test_blockwise_plain_version_matches_jax(t, dtype):
    j, tt = both(make_inputs(t), dtype)
    want = np.asarray(jax_blockwise(*j, block_q=min(256, t), interpret=True).astype(jnp.float32))
    got = blockwise_attention_reference(*tt)
    assert got.dtype == tt[0].dtype and got.shape == tt[0].shape
    assert_close(got.float().numpy(), want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("t", [256, 512, 1024])
def test_flash_plain_version_matches_jax(t, dtype):
    j, tt = both(make_inputs(t), dtype)
    want = np.asarray(jax_flash(*j, interpret=True).astype(jnp.float32))
    got = flash_attention_reference(*tt)
    assert got.dtype == tt[0].dtype
    assert_close(got.float().numpy(), want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_plain_version_follows_jax_key_blocks(dtype):
    """With JAX's block_k = 256 over T = 1024 the running max changes at
    every 256 keys, and the plain version's casts of exp(s - m) follow."""
    j, tt = both(make_inputs(1024, seed=3), dtype)
    want = np.asarray(jax_flash(*j, block_q=256, block_k=256, interpret=True).astype(jnp.float32))
    assert_close(flash_attention_reference(*tt, block_k=256).float().numpy(), want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_head_dim_128_matches_jax(dtype):
    j, tt = both(make_inputs(256, hd=128), dtype)
    want = np.asarray(jax_blockwise(*j, interpret=True).astype(jnp.float32))
    assert_close(blockwise_attention_reference(*tt).float().numpy(), want, dtype)
    want = np.asarray(jax_flash(*j, interpret=True).astype(jnp.float32))
    assert_close(flash_attention_reference(*tt).float().numpy(), want, dtype)


@pytest.mark.parametrize("plain", [blockwise_attention_reference, flash_attention_reference])
def test_fully_masked_row_averages_v(plain):
    """A batch row whose every key is masked gives the uniform average of
    v, finite (the -1e30 clamp and the finite running max), as in JAX."""
    q, k, v, bias = make_inputs(256)
    bias[1] = -np.inf  # a literal -inf bias is clamped, not NaN-poisoning
    out = plain(*(torch.from_numpy(x) for x in (q, k, v, bias)))
    assert torch.isfinite(out).all()
    want = v[1].mean(axis=1, keepdims=True).repeat(256, axis=1)
    np.testing.assert_allclose(out[1].numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("wrapper, plain", [(blockwise_attention, blockwise_attention_reference),
                                            (flash_attention, flash_attention_reference)])
def test_wrapper_runs_plain_version_on_cpu(wrapper, plain):
    tt = [torch.from_numpy(x) for x in make_inputs(512)]
    before = wrapper.launches
    assert torch.equal(wrapper(*tt), plain(*tt))
    assert wrapper.launches == before  # launches count kernel launches only


@pytest.mark.parametrize("wrapper", [blockwise_attention, flash_attention])
def test_wrapper_rejects_out_of_contract(wrapper):
    q, k, v, bias = (torch.from_numpy(x) for x in make_inputs(256))
    with pytest.raises(ValueError, match="head dim"):
        wrapper(q[..., :32], k[..., :32], v[..., :32], bias)
    with pytest.raises(ValueError, match="T="):
        wrapper(q[:, :, :128], k[:, :, :128], v[:, :, :128], bias[:, :128])
    q3, k3, v3 = (torch.cat([x, x[:, :, :64]], dim=2) for x in (q, k, v))  # T = 320
    with pytest.raises(ValueError, match="T="):
        wrapper(q3, k3, v3, torch.cat([bias, bias[:, :64]], dim=1))
    with pytest.raises(ValueError, match="bf16"):
        wrapper(q.half(), k.half(), v.half(), bias)
    with pytest.raises(ValueError, match="bf16"):
        wrapper(q, k.bfloat16(), v, bias)
    with pytest.raises(ValueError, match="bias"):
        wrapper(q, k, v, bias[:, :128])
    with pytest.raises(ValueError, match="shape"):
        wrapper(q, k[:1], v, bias)


def test_clamp_matches_jax():
    assert CLAMP == -1e30
    q, k, v, bias = make_inputs(256)
    bias[0, :5] = -np.inf
    tt = [torch.from_numpy(x) for x in (q, k, v)]
    clamped = np.maximum(bias, CLAMP)
    for plain in (blockwise_attention_reference, flash_attention_reference):
        assert torch.equal(plain(*tt, torch.from_numpy(bias)), plain(*tt, torch.from_numpy(clamped)))


# ---------------------------------------------------------------------------
# flash_attention_stats: one ring hop, (acc, m, l) without the divide
# ---------------------------------------------------------------------------


def make_span(t, t_kv, hd=64, b=2, h=2, seed=0):
    """q [b, h, t, hd] against a span k, v [b, h, t_kv, hd]: row 0's keys
    padded past t_kv/2 + 3, row 1 (when b > 1) fully masked."""
    rng = np.random.default_rng(seed + t + 3 * t_kv + hd)
    q = rng.standard_normal((b, h, t, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, h, t_kv, hd)).astype(np.float32) for _ in range(2))
    mask = np.ones((b, t_kv), np.float32)
    mask[0, t_kv // 2 + 3 :] = 0.0
    mask[1:, :] = 0.0
    return q, k, v, (1.0 - mask) * -1e9


def assert_stats_close(got, want, dtype):
    """m within f32 summation order, l relative and acc / l within the
    module's tolerance (f32 1e-5; bf16 one bf16 ulp)."""
    (ga, gm, gl), (wa, wm, wl) = ([np.asarray(x, np.float32) for x in t] for t in (got, want))
    assert ga.shape == wa.shape and gm.shape == wm.shape == gl.shape == wl.shape
    np.testing.assert_allclose(gm, wm, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(gl, wl, rtol=1e-5 if dtype == "float32" else 2**-7, atol=0)
    assert_close(ga / gl[..., None], wa / wl[..., None], dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("t, t_kv", [(256, 256), (512, 512), (512, 256), (512, 1024)])
def test_stats_plain_version_matches_jax(t, t_kv, hd, dtype):
    j, tt = both(make_span(t, t_kv, hd), dtype)
    want = jax_stats(*j, interpret=True)
    got = flash_attention_stats_reference(*tt)
    assert all(x.dtype == torch.float32 for x in got)
    assert tuple(got[0].shape) == (2, 2, t, hd) and tuple(got[1].shape) == (2, 2, t)
    assert_stats_close([x.numpy() for x in got], want, dtype)


def test_stats_fully_masked_span_and_row_stay_finite():
    """A span whose every key is padding: m = -1e9 exactly, l counts the
    keys, acc / l averages v; a literal -inf bias is clamped."""
    q, k, v, bias = make_span(256, 512)
    bias[:] = -1e9
    bias[1, :7] = -np.inf
    acc, m, l = flash_attention_stats(*(torch.from_numpy(x) for x in (q, k, v, bias)))
    assert torch.isfinite(acc).all() and torch.isfinite(m).all() and torch.isfinite(l).all()
    assert (m[0] == -1e9).all()
    np.testing.assert_allclose(l[0].numpy(), 512.0, rtol=1e-6)
    want = v[0].mean(axis=1, keepdims=True).repeat(256, axis=1)
    np.testing.assert_allclose((acc[0] / l[0][..., None]).numpy(), want, atol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_stats_reconstructs_flash_and_two_hops_merge(dtype):
    """JAX's two-hop recurrence (tests/ops/test_attention.py) on the port:
    acc / l equals flash_attention, and two half-span hops merged by the
    ring's combine equal the whole-span result, as JAX's do."""
    rng = np.random.default_rng(0)
    b, h, t, hd = 1, 2, 512, 64
    q, k, v = (rng.normal(size=(b, h, t, hd)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, t), np.float32)
    mask[0, 400:] = 0.0
    bias = (1.0 - mask) * -1e9
    j, tt = both((q, k, v, bias), dtype)
    acc, m, l = flash_attention_stats(*tt)
    full = flash_attention(*tt).float().numpy()
    jfull = np.asarray(jax_flash(*j, block_q=256, block_k=256, interpret=True).astype(jnp.float32))
    np.testing.assert_allclose((acc / torch.clamp_min(l, 1e-30)[..., None]).numpy(), full,
                               atol=2e-4 if dtype == "float32" else 2**-6)
    hops = [flash_attention_stats(tt[0], tt[1][:, :, s], tt[2][:, :, s], tt[3][:, s])
            for s in (slice(0, 256), slice(256, 512))]
    (a1, m1, l1), (a2, m2, l2) = ([x.numpy() for x in hop] for hop in hops)
    m_new = np.maximum(m1, m2)
    w1, w2 = np.exp(m1 - m_new), np.exp(m2 - m_new)
    merged = (a1 * w1[..., None] + a2 * w2[..., None]) / np.maximum(
        (l1 * w1 + l2 * w2)[..., None], 1e-30)
    np.testing.assert_allclose(merged, full, atol=2e-4 if dtype == "float32" else 2**-6)
    np.testing.assert_allclose(merged, jfull, atol=2e-4 if dtype == "float32" else 2**-6)


def test_stats_wrapper_runs_plain_version_on_cpu_and_checks_its_range():
    tt = [torch.from_numpy(x) for x in make_span(256, 512)]
    before = flash_attention_stats.launches
    for a, b in zip(flash_attention_stats(*tt), flash_attention_stats_reference(*tt)):
        assert torch.equal(a, b)
    assert flash_attention_stats.launches == before
    q, k, v, bias = tt
    with pytest.raises(ValueError, match="T_kv"):
        flash_attention_stats(q, k[:, :, :320], v[:, :, :320], bias[:, :320])
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_stats(q[..., :32], k[..., :32], v[..., :32], bias)
    with pytest.raises(ValueError, match="bias"):
        flash_attention_stats(q, k, v, bias[:, :256])
    with pytest.raises(ValueError, match="match"):
        flash_attention_stats(q, k[:1], v[:1], bias)
