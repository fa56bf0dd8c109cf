"""The sharded train steps and the parallel forwards over gloo process
groups, one mesh slot per spawned CPU process (joined through a
``FileStore`` under ``tmp_path``; a time limit per spawn), against the same
scenarios on a local mesh of ``cpu`` slots in one process
(``tests/torch_train_workers.py``):

- 4 ranks: the dp 2 × tp 2 InfoNCE step and the dp 2 × ep 2 MoE step, 2
  steps each (losses and the gathered parameters; every rank's), SP with
  TP inside the ring (sp 2 × tp 2), and the expert-parallel forwards over
  ep 4 (psum; all-to-all with capacities that drop tokens);
- 2 ranks: a 2-stage pipeline forward with 4 microbatches.

The group forms reduce and gather in another order than the local ones,
so values are compared within 1e-6 (f32; the gradients the first step
applies within 1e-6 of each leaf's largest). With four CUDA cards (a
``cuda``-marked test, skipped elsewhere) the same scenarios run over NCCL,
one card a rank, against a local mesh on card 0: the losses within 1e-5
relative, the gradients the first step applies within 1e-5 of each leaf's
largest, the forwards within 1e-5 (f32 with TF32 off; the card's atomics
make runs differ in the last bits, and Adam's sign-like update turns such
bits of a near-zero gradient into a step's change, so the parameters are
not compared there)."""

import os
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(__file__))
import torch_train_workers as workers  # noqa: E402

SPAWN_TIMEOUT_S = 120
TOL = 1e-6


def spawn(world: int, tmp_path, backend: str = "gloo") -> list[dict[str, dict]]:
    out_dir = tmp_path / f"world{world}-{backend}"
    out_dir.mkdir()
    ctx = mp.start_processes(workers.run, args=(world, str(tmp_path / f"store-{world}-{backend}"),
                                                str(out_dir), backend),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                pytest.fail(f"the {world} gloo processes did not finish in {SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    names = {f.rsplit("-", 1)[0] for f in os.listdir(out_dir)}
    return [{n: dict(np.load(out_dir / f"{n}-{r}.npz")) for n in names} for r in range(world)]


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return spawn(4, tmp_path_factory.mktemp("gloo4")), workers.scenarios(4, ["cpu"] * 4)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return spawn(2, tmp_path_factory.mktemp("gloo2")), workers.scenarios(2, ["cpu"] * 2)


def assert_same(ranks: list[dict], local: dict, name: str):
    want = local[name]
    for r, got in enumerate(ranks):
        assert set(got[name]) == set(want), (name, r)
        for k, v in want.items():
            scale = max(float(np.abs(v).max()), 1e-12) if k.startswith("grad:") else 1.0
            np.testing.assert_allclose(got[name][k], v, rtol=0, atol=TOL * scale,
                                       err_msg=f"{name} rank {r}: {k}")


@pytest.mark.parametrize("name", ["tp", "ep"])
def test_sharded_steps_on_gloo_equal_the_local_mesh(four, name):
    ranks, local = four
    assert_same(ranks, local, name)
    assert np.isfinite(local[name]["losses"]).all()
    if name == "ep":
        assert (local[name]["aux"] > 0).all()


@pytest.mark.parametrize("name", ["sp_tp", "ep_psum", "ep_a2a"])
def test_parallel_forwards_on_gloo_equal_the_local_mesh(four, name):
    ranks, local = four
    assert_same(ranks, local, name)


def test_two_stage_pipeline_on_gloo_equals_the_local_mesh(two):
    ranks, local = two
    assert_same(ranks, local, "pp")


@pytest.mark.cuda
def test_nccl_ranks_equal_the_local_mesh_on_four_cards(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards: NCCL ranks, one card each")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        local = {**workers.scenarios(4, ["cuda:0"] * 4), **workers.scenarios(2, ["cuda:0"] * 2)}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    four = spawn(4, tmp_path, "nccl")
    two = spawn(2, tmp_path, "nccl")
    for ranks in (four, two):
        for r, got in enumerate(ranks):
            for name, arrays in got.items():
                for k, v in arrays.items():
                    want = local[name][k]
                    if k.startswith("param:"):
                        continue
                    if k in ("losses", "aux"):
                        np.testing.assert_allclose(v, want, rtol=1e-5, err_msg=f"{name} {r} {k}")
                        continue
                    scale = max(float(np.abs(want).max()), 1e-12) if k.startswith("grad:") else 1
                    np.testing.assert_allclose(v, want, rtol=0, atol=1e-5 * scale,
                                               err_msg=f"{name} rank {r}: {k}")
