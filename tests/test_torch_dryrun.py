"""The port's multi-device dry run (``youtu_rag_tpu_torch/dryrun.py``), the
counterpart of ``__graft_entry__.py::dryrun_multichip``, on ``cpu`` slots:
8 slots take every path (SP with TP inside the ring), 4 every path but
TP in the ring, 2 the train step, TP decoding, the index, PP and EP; each
run returns its numbers within JAX's bounds. Without ``devices`` it takes
the CUDA devices and refuses a host without one."""

import math

import pytest
import torch

from youtu_rag_tpu_torch.dryrun import dryrun_multichip


@pytest.mark.parametrize("n", [8, 4, 2])
def test_dryrun_on_cpu_slots(n):
    out = dryrun_multichip(n, devices=["cpu"] * n)
    assert math.isfinite(out["train_loss"]) and out["tp_decode_parity"] is True
    assert out["ivf_top1"] == "c0"
    assert out["pp_err"] < 1e-4 and out["ep_err"] < 1e-4 and out["a2a_err"] < 1e-4
    if n >= 4:
        assert out["sp_err"] < 1e-4 and math.isfinite(out["hybrid_loss"])
        assert math.isfinite(out["moe_loss"]) and out["moe_aux_loss"] > 0.0
    else:
        assert math.isnan(out["sp_err"]) and math.isnan(out["moe_loss"])


def test_dryrun_needs_cuda_or_devices():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(4)
    with pytest.raises(ValueError, match="over 4 slots, have 2 devices"):
        dryrun_multichip(4, devices=["cpu"] * 2)
