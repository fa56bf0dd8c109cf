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
from youtu_rag_tpu_torch.ops.attention import (
    CLAMP,
    blockwise_attention,
    blockwise_attention_reference,
    flash_attention,
    flash_attention_reference,
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
