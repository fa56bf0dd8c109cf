"""The port's sharded IVF and hybrid mesh over a gloo process group (2 and
4 spawned CPU processes, ``tests/torch_sharded_workers.py``): IVF built by
``_mp_fit_assign`` (the fit sample gathered to every process, the fit
replicated, each process assigning its own rows) gives every rank what the
local mesh's ``fit_and_assign`` gives and what the JAX package's sharded
IVF gives; a 2-process × 2-device hybrid ``("dcn", "ici")`` index, whose
only cross-process collective is the candidate merge, against JAX's on a
2 × 2 hybrid mesh (``tests/parallel/test_multihost.py``'s case). Every
side starts k-means from JAX's init draw.

Tolerances: group and local mesh bit for bit; against JAX the same rows,
bf16 scores within 1e-5, int8 bit-equal (JAX's IVF through its Pallas DMA
kernels in interpret mode)."""

import functools
import os
import sys

import jax
import numpy as np
import pytest

from youtu_rag_tpu.ops import ivf as jax_ops_ivf
from youtu_rag_tpu.ops import topk as jax_ops_topk
from youtu_rag_tpu.parallel import sharded_index as jax_sharded
from youtu_rag_tpu_torch.ops import kmeans as port_kmeans
from youtu_rag_tpu_torch.parallel import get_hybrid_mesh, get_mesh
from torch_native_helpers import jax_tracer_restored  # noqa: F401 - a fixture

sys.path.insert(0, os.path.dirname(__file__))
import torch_sharded_workers as workers  # noqa: E402
from torch_sharded_jax import compare, jax_twin  # noqa: E402

pytestmark = pytest.mark.usefixtures("jax_tracer_restored")

N_BUILD, N_LISTS = 780, 8  # the rows when the scenario builds IVF, its lists


@pytest.fixture
def jax_init_rows(monkeypatch):
    """JAX's k-means init draw, which the port's local mesh starts from here
    and its spawned ranks are handed."""
    init = np.array(jax.random.choice(jax.random.PRNGKey(0), N_BUILD, (N_LISTS,), replace=False))
    monkeypatch.setattr(port_kmeans, "kmeans_init", lambda n, n_clusters, seed: init)
    for name in ("pallas_topk_pruned", "pallas_topk_int8_pruned", "pallas_topk_int4_pruned"):
        monkeypatch.setattr(jax_sharded, name,
                            functools.partial(getattr(jax_ops_topk, name), interpret=True))
    for name in ("pallas_ivf_topk_dma", "pallas_ivf_topk_int8_dma", "pallas_ivf_topk_int4_dma"):
        monkeypatch.setattr(jax_ops_ivf, name,
                            functools.partial(getattr(jax_ops_ivf, name), interpret=True))
    return init


@pytest.mark.parametrize("mode", ["ivf4", "ivf2_int8"])
def test_group_ivf_equals_local_mesh_and_jax(mode, tmp_path, jax_init_rows):
    _, world, per = workers.CASES[mode]
    shards = world * per
    local = workers.scenario(mode, get_mesh({"db": shards}, devices=["cpu"] * shards), "db",
                             str(tmp_path), one_process=True)
    assert local["novel"][0][0][0] == "novel-0"
    for out in workers.spawn(mode, tmp_path, init=jax_init_rows):
        compare(out, local, exact=True)
    quant = "storage_dtype" in workers.CASES[mode][0]
    compare(local, jax_twin(mode, jax.devices()[:shards], tmp_path,
                           search={"backend": "pallas"} if quant else None), exact=quant)


def test_hybrid_group_mesh_equals_local_and_jax(tmp_path):
    """2 processes × 2 local devices, rows sharded jointly over ("dcn",
    "ici"): 4 shards, 2 a process."""
    local = workers.scenario("hybrid", get_hybrid_mesh({"ici": 2}, {"dcn": 2},
                                                       devices=["cpu"] * 4),
                             ("dcn", "ici"), str(tmp_path), one_process=True)
    for out in workers.spawn("hybrid", tmp_path):
        compare(out, local, exact=True)
    compare(local, jax_twin("hybrid", jax.devices()[:4], tmp_path), exact=False)
