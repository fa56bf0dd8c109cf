"""Tensor-parallel decoding over a gloo process group (``shard_decoder``
on a group mesh, one (dp, tp) slot per spawned CPU process, joined through
a ``FileStore`` under ``tmp_path``, a time limit per test): every rank's
greedy tokens and lengths equal the replicated run's and the local mesh's
TP run's, and those equal the JAX package's TP ``generate`` (held in
``tests/test_torch_decoder_tp.py``). The all-reduces sum in another
order; the tokens are compared exactly."""

import os
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from youtu_rag_tpu_torch.models import decoder as td
from youtu_rag_tpu_torch.parallel import get_mesh

sys.path.insert(0, os.path.dirname(__file__))
import torch_tp_workers as workers  # noqa: E402

SPAWN_TIMEOUT_S = 90


def spawn(mode: str, tmp_path) -> list[dict]:
    axes, world = workers.CASES[mode]
    ctx = mp.start_processes(workers.run, args=(world, str(tmp_path / f"store-{mode}"), mode,
                                                str(tmp_path)),
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


@pytest.mark.parametrize("mode", list(workers.CASES))
def test_group_tp_generate_equals_replicated_and_local(mode, tmp_path):
    cfg, params, toks, mask = workers.model()
    want, want_len = td.generate(params, toks, mask, cfg, max_new_tokens=workers.NEW)
    axes, world = workers.CASES[mode]
    local = td.shard_decoder(params, cfg, get_mesh(axes, devices=["cpu"] * world))
    got, got_len = td.tp_generate(local, toks, mask, max_new_tokens=workers.NEW)
    assert torch.equal(got, want) and torch.equal(got_len, want_len)
    for out in spawn(mode, tmp_path):
        np.testing.assert_array_equal(out["out"], want.numpy())
        np.testing.assert_array_equal(out["lengths"], want_len.numpy())
