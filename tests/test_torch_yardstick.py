"""The PyTorch yardsticks of ``chip_smoke.py`` and the bench scripts, on CPU
tensors: ``library_call``'s int8 product pads the queries to
``int_mm_rows`` (the larger of 32 and q rounded up to 8, as torch._int_mm
takes them), so it answers at every query count the main path and
``bench/ring_variants.py`` give it, and agrees with the int8 scan's plain
version; ``bench/ab_kernels.py`` takes its IVF index from
``configs/rag/ivf_int8.yaml`` through the config loader."""

import importlib.util
from pathlib import Path

import pytest
import torch
import yaml

from youtu_rag_tpu_torch.bench.ab_kernels import ivf_index_config
from youtu_rag_tpu_torch.ops.topk import quantize_rows_int8, topk_int8_pruned_reference

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("qn,rows", [(1, 32), (8, 32), (32, 32), (33, 40), (64, 64), (65, 72)])
def test_int8_padding(smoke, qn, rows):
    assert smoke.int_mm_rows(qn) == rows


@pytest.mark.parametrize("qn", [1, 32, 33, 64])
def test_int8_library_call_answers_at_q(smoke, qn):
    g = torch.Generator().manual_seed(qn)
    n, d, k = 512, 128, 10
    x = torch.randn(n, d, generator=g)
    x8, xs = quantize_rows_int8(x / x.norm(dim=1, keepdim=True))
    q = torch.randn(qn, d, generator=g)
    bias = torch.zeros(n)
    bias[::7] = -1.0  # a few rows pushed down
    desc, call = smoke.library_call("int8", q, x8, xs, bias, k)
    assert call is not None, desc
    assert f"q_pad{smoke.int_mm_rows(qn)}" in desc
    got = call()
    want_s, want_i = topk_int8_pruned_reference(q, x8, xs, bias, k)
    assert got.values.shape == (qn, k)
    torch.testing.assert_close(got.values, want_s, rtol=0, atol=1e-5)
    assert torch.equal(got.indices.int(), want_i)


def test_ab_kernels_ivf_settings_come_from_the_config(smoke):
    yml = yaml.safe_load((REPO / "configs" / "rag" / "ivf_int8.yaml").read_text())
    index = yml["vector_store"]["index"]
    for tier in ("bfloat16", "int8", "int4"):
        cfg = ivf_index_config(tier)
        assert cfg.storage_dtype == tier
        for key, value in index.items():
            if key != "storage_dtype":
                assert getattr(cfg, key) == value, key
    # the settings chip_smoke.py's phases 5c and 5d copy, which 5f holds
    # against the same config on the card
    assert {key: getattr(cfg, key) for key in smoke.IVF_SETTINGS} == smoke.IVF_SETTINGS
