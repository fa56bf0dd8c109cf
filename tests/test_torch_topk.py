"""The port's top-k (youtu_rag_tpu_torch.ops.topk) against the JAX kernels.

The same numpy inputs go through the JAX package's Pallas kernels
(``interpret=True``) and ``xla_topk*`` functions and through the port's
wrappers on the CPU, which run their plain PyTorch versions.

- bf16: scores agree within 1e-4 (both sum bf16 products in f32, in another
  order) and live slots hold the same rows; exact ties go to the lowest row.
- int8 / int4: the quantizers are byte-equal to the JAX ones; live slots
  hold the same rows in the same order and scores agree within 1e-5 (the
  integer dot is exact on both sides, and XLA on the CPU may contract the
  f32 epilogue into an FMA, one rounding fewer).
"""

import numpy as np
import pytest
import torch

from youtu_rag_tpu.ops import topk as jax_topk
from youtu_rag_tpu.ops.topk import pallas_topk_pruned, xla_topk
from youtu_rag_tpu_torch.ops.topk import (
    NEG_INF,
    quantize_rows_int4,
    quantize_rows_int8,
    topk_int4_pruned,
    topk_int4_pruned_reference,
    topk_int8_pruned,
    topk_int8_pruned_reference,
    topk_pruned,
    topk_pruned_reference,
    unpack_int4,
)

TOL = 1e-4
N = 2048
DUP_SRC, DUPS = 3, (101, 102, 103, 104)  # live rows 101-104 copy row 3


def make_inputs(q, d, seed=0, masked="mixed"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[list(DUPS)] = x[DUP_SRC]
    qs = rng.standard_normal((q, d)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    qs[0] = x[DUP_SRC]  # query 0's top slots are exact ties
    bias = np.zeros(N, np.float32)
    if masked == "mixed":
        bias[::5] = NEG_INF  # tombstones / filtered rows
        bias[7::13] = -np.inf  # NEG_INF + NEG_INF from a filter
    elif masked == "all":
        bias[:] = NEG_INF
    return qs, x, bias


def port(qs, x, bias, k):
    s, i = topk_pruned(torch.from_numpy(qs), torch.from_numpy(x).to(torch.bfloat16),
                       torch.from_numpy(bias), k)
    return s.numpy(), i.numpy()


def assert_live_match(got, want):
    gs, gi = got
    ws, wi = (np.asarray(a) for a in want)
    assert gs.dtype == np.float32 and gi.dtype == np.int32
    assert gs.shape == ws.shape and gi.shape == wi.shape
    for a in range(ws.shape[0]):
        live = ws[a] > NEG_INF / 2
        n = int(live.sum())
        assert int((gs[a] > NEG_INF / 2).sum()) == n
        np.testing.assert_allclose(gs[a, :n], ws[a, :n], atol=TOL)
        assert set(gi[a, :n].tolist()) == set(wi[a, :n].tolist())


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("k", [1, 10, 50])
@pytest.mark.parametrize("q", [1, 3, 8])
def test_matches_pallas_pruned_and_xla(q, k, d):
    qs, x, bias = make_inputs(q, d, seed=q * 1000 + k + d)
    got = port(qs, x, bias, k)
    assert_live_match(got, pallas_topk_pruned(qs, x, bias, k, block_rows=512, interpret=True))
    assert_live_match(got, xla_topk(qs, x, bias, k))


@pytest.mark.parametrize("k", [1, 10, 50])
def test_lowest_row_wins_ties(k):
    qs, x, bias = make_inputs(3, 128, seed=k)
    s, i = port(qs, x, bias, k)
    ties = [DUP_SRC, *DUPS][:k]
    assert i[0, : len(ties)].tolist() == ties
    assert len(set(s[0, : len(ties)].tolist())) == 1
    ps, pi = pallas_topk_pruned(qs, x, bias, k, block_rows=512, interpret=True)
    assert np.asarray(pi)[0, : len(ties)].tolist() == ties


def test_masked_rows_never_return():
    qs, x, bias = make_inputs(8, 128, seed=7)
    s, i = port(qs, x, bias, 50)
    dead = np.flatnonzero(bias != 0)
    assert not np.isin(i[s > NEG_INF / 2], dead).any()


@pytest.mark.parametrize("k", [1, 10, 50])
def test_all_masked_index(k):
    qs, x, bias = make_inputs(3, 128, seed=k, masked="all")
    s, _ = port(qs, x, bias, k)
    assert (s <= NEG_INF / 2).all()
    ps, _ = pallas_topk_pruned(qs, x, bias, k, block_rows=512, interpret=True)
    assert (np.asarray(ps) <= NEG_INF / 2).all()


def test_neg_inf_is_float32_min():
    assert NEG_INF == float(np.finfo(np.float32).min)
    from youtu_rag_tpu.ops.topk import NEG_INF as JAX_NEG_INF

    assert NEG_INF == JAX_NEG_INF


def test_cpu_wrapper_runs_plain_version_without_counting():
    qs, x, bias = make_inputs(3, 128)
    before = topk_pruned.launches
    args = (torch.from_numpy(qs), torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(bias), 10)
    s1, i1 = topk_pruned(*args)
    s2, i2 = topk_pruned_reference(*args)
    assert torch.equal(s1, s2) and torch.equal(i1, i2)
    assert topk_pruned.launches == before


def test_reference_rounds_to_bf16_then_sums_in_f32():
    """A bf16 matmul would round scores to bf16; the plain version must not."""
    qs, x, bias = make_inputs(1, 128)
    s, i = topk_pruned_reference(torch.from_numpy(qs), torch.from_numpy(x), torch.from_numpy(bias), 5)
    q16 = torch.from_numpy(qs).to(torch.bfloat16).double()
    x16 = torch.from_numpy(x).to(torch.bfloat16).double()
    exact = (q16 @ x16.T)[0, i[0].long()] + torch.from_numpy(bias)[i[0].long()].double()
    np.testing.assert_allclose(s[0].numpy(), exact.numpy(), atol=1e-6)


def test_other_devices_raise():
    meta = torch.empty((N, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        topk_pruned(torch.empty((1, 128), device="meta"), meta,
                    torch.empty(N, device="meta"), 10)
    with pytest.raises(ValueError):
        topk_pruned(torch.zeros(1, 128), meta, torch.zeros(N), 10)


# ---------------------------------------------------------------------------
# int8 / int4
# ---------------------------------------------------------------------------

QTOL = 1e-5
TIERS = {
    # tier: (JAX quantizer, JAX pruned Pallas kernel, JAX XLA path, port wrapper)
    "int8": (jax_topk.quantize_rows_int8, jax_topk.pallas_topk_int8_pruned,
             jax_topk.xla_topk_int8, topk_int8_pruned),
    "int4": (jax_topk.quantize_rows_int4, jax_topk.pallas_topk_int4_pruned,
             jax_topk.xla_topk_int4, topk_int4_pruned),
}


@pytest.mark.parametrize("d", [256, 768])
@pytest.mark.parametrize("seed", [0, 1])
def test_quantizers_are_byte_equal_to_jax(d, seed):
    rng = np.random.default_rng(seed)
    # rows over nine decades, a zero row and exact halves of a level
    x = (rng.standard_normal((500, d)) * rng.uniform(1e-6, 1e3, (500, 1))).astype(np.float32)
    x[5] = 0.0
    x[6, :] = np.arange(d, dtype=np.float32) / 2
    for jax_q, port_q in ((jax_topk.quantize_rows_int8, quantize_rows_int8),
                          (jax_topk.quantize_rows_int4, quantize_rows_int4)):
        jq, js = (np.asarray(a) for a in jax_q(x))
        pq, ps = port_q(torch.from_numpy(x))
        assert pq.dtype == torch.int8 and ps.dtype == torch.float32
        np.testing.assert_array_equal(pq.numpy(), jq)
        np.testing.assert_array_equal(ps.numpy().view(np.uint32), js.view(np.uint32))
    packed = np.array(jax_topk.quantize_rows_int4(x)[0])
    np.testing.assert_array_equal(unpack_int4(torch.from_numpy(packed)).numpy(),
                                  np.asarray(jax_topk.unpack_int4(packed)))


def quant_inputs(tier, q, d, seed=0, masked="mixed"):
    """Unit vectors quantized by the JAX quantizer, as numpy arrays."""
    qs, x, bias = make_inputs(q, d, seed=seed, masked=masked)
    xq, xs = (np.array(a) for a in TIERS[tier][0](x))
    return qs, xq, xs, bias


def port_quant(tier, qs, xq, xs, bias, k):
    s, i = TIERS[tier][3](torch.from_numpy(qs), torch.from_numpy(xq), torch.from_numpy(xs),
                          torch.from_numpy(bias), k)
    return s.numpy(), i.numpy()


def assert_quant_match(got, want):
    """Live slots: the same rows in the same order, scores within QTOL."""
    gs, gi = got
    ws, wi = (np.asarray(a) for a in want)
    assert gs.dtype == np.float32 and gi.dtype == np.int32
    assert gs.shape == ws.shape and gi.shape == wi.shape
    for a in range(ws.shape[0]):
        n = int((ws[a] > NEG_INF / 2).sum())
        assert int((gs[a] > NEG_INF / 2).sum()) == n
        np.testing.assert_allclose(gs[a, :n], ws[a, :n], rtol=0, atol=QTOL)
        assert gi[a, :n].tolist() == wi[a, :n].tolist()


@pytest.mark.parametrize("tier", ["int8", "int4"])
@pytest.mark.parametrize("d", [256, 512])
@pytest.mark.parametrize("k", [1, 10, 50])
@pytest.mark.parametrize("q", [1, 3, 8])
def test_quantized_matches_pallas_pruned_and_xla(tier, q, k, d):
    _, pallas, xla, _ = TIERS[tier]
    qs, xq, xs, bias = quant_inputs(tier, q, d, seed=q * 1000 + k + d)
    got = port_quant(tier, qs, xq, xs, bias, k)
    assert_quant_match(got, pallas(qs, xq, xs, bias, k, block_rows=512, interpret=True))
    assert_quant_match(got, xla(qs, xq, xs, bias, k))


@pytest.mark.parametrize("tier", ["int8", "int4"])
def test_quantized_duplicates_tie_to_the_lowest_row(tier):
    qs, xq, xs, bias = quant_inputs(tier, 3, 256, seed=11)
    s, i = port_quant(tier, qs, xq, xs, bias, 10)
    ties = [DUP_SRC, *DUPS]
    assert i[0, : len(ties)].tolist() == ties
    assert len(set(s[0, : len(ties)].tolist())) == 1
    _, pi = TIERS[tier][1](qs, xq, xs, bias, 10, block_rows=512, interpret=True)
    assert np.asarray(pi)[0, : len(ties)].tolist() == ties


@pytest.mark.parametrize("tier", ["int8", "int4"])
def test_quantized_masked_rows_never_return(tier):
    qs, xq, xs, bias = quant_inputs(tier, 8, 256, seed=7)
    s, i = port_quant(tier, qs, xq, xs, bias, 50)
    assert not np.isin(i[s > NEG_INF / 2], np.flatnonzero(bias != 0)).any()


@pytest.mark.parametrize("tier", ["int8", "int4"])
@pytest.mark.parametrize("k", [1, 50])
def test_quantized_all_masked_index(tier, k):
    qs, xq, xs, bias = quant_inputs(tier, 3, 256, seed=k, masked="all")
    s, _ = port_quant(tier, qs, xq, xs, bias, k)
    assert (s <= NEG_INF / 2).all()
    ps, _ = TIERS[tier][1](qs, xq, xs, bias, k, block_rows=512, interpret=True)
    assert (np.asarray(ps) <= NEG_INF / 2).all()


@pytest.mark.parametrize("tier", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("k", [256, 1024])
def test_large_k_matches_xla(tier, k):
    """k above the first kernel's old limit of 128, up to 1024."""
    if tier == "bf16":
        qs, x, bias = make_inputs(3, 256, seed=k)
        assert_live_match(port(qs, x, bias, k), xla_topk(qs, x, bias, k))
    else:
        qs, xq, xs, bias = quant_inputs(tier, 3, 256, seed=k)
        assert_quant_match(port_quant(tier, qs, xq, xs, bias, k),
                           TIERS[tier][2](qs, xq, xs, bias, k))


@pytest.mark.parametrize("tier", ["int8", "int4"])
def test_quantized_reference_dot_is_exact(tier):
    """The plain version's score is f32(exact int dot) * (qs * xs) + bias."""
    qs, xq, xs, bias = quant_inputs(tier, 2, 256, seed=3, masked="none")
    ref = topk_int8_pruned_reference if tier == "int8" else topk_int4_pruned_reference
    s, i = ref(torch.from_numpy(qs), torch.from_numpy(xq), torch.from_numpy(xs),
               torch.from_numpy(bias), 5)
    qq, qsc = (np.asarray(a) for a in jax_topk.quantize_rows_int8(qs))
    xint = xq if tier == "int8" else np.asarray(jax_topk.unpack_int4(xq))
    rows = i.numpy().astype(np.int64)
    acc = np.einsum("qd,qkd->qk", qq.astype(np.int64), xint[rows].astype(np.int64))
    want = acc.astype(np.float32) * (qsc[:, None] * xs[rows]) + bias[rows]
    np.testing.assert_array_equal(s.numpy(), want)


@pytest.mark.parametrize("tier", ["int8", "int4"])
def test_quantized_cpu_wrapper_runs_plain_version_without_counting(tier):
    qs, xq, xs, bias = quant_inputs(tier, 3, 256)
    wrapper = TIERS[tier][3]
    ref = topk_int8_pruned_reference if tier == "int8" else topk_int4_pruned_reference
    args = tuple(torch.from_numpy(a) for a in (qs, xq, xs, bias)) + (10,)
    before = wrapper.launches
    s1, i1 = wrapper(*args)
    s2, i2 = ref(*args)
    assert torch.equal(s1, s2) and torch.equal(i1, i2)
    assert wrapper.launches == before


@pytest.mark.parametrize("k", [0, N + 1])
def test_every_wrapper_refuses_k_outside_the_kernel_range_on_the_cpu(k):
    """The kernels keep any k from 1 to the index's N rows (JAX asserts
    k <= block_rows, which divides N)."""
    qs, x, bias = make_inputs(1, 256)
    with pytest.raises(ValueError, match="k="):
        topk_pruned(torch.from_numpy(qs), torch.from_numpy(x), torch.from_numpy(bias), k)
    for tier in ("int8", "int4"):
        qs, xq, xs, bias = quant_inputs(tier, 1, 256)
        with pytest.raises(ValueError, match="k="):
            port_quant(tier, qs, xq, xs, bias, k)
