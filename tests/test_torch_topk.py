"""The port's top-k (youtu_rag_tpu_torch.ops.topk) against the JAX kernel.

The same numpy inputs go through ``pallas_topk_pruned(..., interpret=True)``
and ``xla_topk`` of the JAX package and through the port's
``topk_pruned`` on the CPU, which runs its plain PyTorch version. Scores
agree within 1e-4 (both sum bf16 products in f32, in another order) and
live slots hold the same rows; exact ties go to the lowest row.
"""

import numpy as np
import pytest
import torch

from youtu_rag_tpu.ops.topk import pallas_topk_pruned, xla_topk
from youtu_rag_tpu_torch.ops.topk import NEG_INF, topk_pruned, topk_pruned_reference

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
