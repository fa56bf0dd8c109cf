"""The port's ``ShardedVectorIndex`` over a gloo process group (2 and 4
CPU processes spawned with ``torch.multiprocessing``, joined through a
``FileStore`` under ``tmp_path``, a time limit per test): every rank
returns what the same index on a local mesh of as many shards returns, and
what the JAX package's ``ShardedVectorIndex`` returns on as many host
devices, through appends that grow the index twice (rows change process:
the ring moves them), a filtered search, deletes, ``compact`` (round the
ring on the group, the capacity kept; on one process both packages run
that body, ``compact_by_permutation``, as JAX's own test does) and a
snapshot reloaded onto the mesh (``tests/torch_sharded_workers.py``).

Tolerances: the group and the local mesh give the same rows and scores
bit for bit (the same kernels on the same shards, the same merge); against
JAX the same rows, bf16 scores within 1e-5 and int8/int4 bit-equal."""

import os
import sys

import jax
import numpy as np
import pytest

from youtu_rag_tpu_torch.parallel import get_mesh
from torch_native_helpers import jax_tracer_restored  # noqa: F401 - a fixture

sys.path.insert(0, os.path.dirname(__file__))
import torch_sharded_workers as workers  # noqa: E402
from torch_sharded_jax import compare, jax_twin  # noqa: E402

pytestmark = pytest.mark.usefixtures("jax_tracer_restored")


@pytest.mark.parametrize("mode", ["brute2", "brute4_int8", "int4_2x2"])
def test_group_index_equals_local_mesh_and_jax(mode, tmp_path):
    _, world, per = workers.CASES[mode]
    shards = world * per
    local = workers.scenario(mode, get_mesh({"db": shards}, devices=["cpu"] * shards), "db",
                             str(tmp_path), one_process=True)
    assert local["capacity"][1] >= 4 * local["capacity"][0]  # grew twice over
    for out in workers.spawn(mode, tmp_path):
        compare(out, local, exact=True)
    compare(local, jax_twin(mode, jax.devices()[:shards], tmp_path),
            exact=workers.CASES[mode][0].get("storage_dtype") in ("int8", "int4"))
