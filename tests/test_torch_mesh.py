"""The port's device meshes (``youtu_rag_tpu_torch/parallel/mesh.py``)
against the JAX package's on the 8 host devices ``tests/conftest.py``
gives JAX: the same shapes, axis names and device order (the port's devices
are ``cpu:i`` here, so their order shows), the hybrid DCN×ICI mesh emulated
in one process, ``init_distributed`` a no-op in one process, and no
fallback to the CPU when no device is named. Everything compared is an
integer, so the tolerance is exact equality."""

import jax
import numpy as np
import pytest
import torch

from youtu_rag_tpu.parallel.mesh import get_hybrid_mesh as jax_hybrid
from youtu_rag_tpu.parallel.mesh import get_mesh as jax_mesh
from youtu_rag_tpu.parallel.mesh import init_distributed as jax_init
from youtu_rag_tpu.parallel.mesh import is_multi_process as jax_multi
from youtu_rag_tpu_torch.parallel import mesh as port
from torch_native_helpers import jax_tracer_restored  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("jax_tracer_restored")

CPUS = [torch.device("cpu", i) for i in range(8)]


def order(m) -> np.ndarray:
    """Each slot's device number: JAX's device id, the port's cpu:i index."""
    return np.vectorize(lambda d: d.id if hasattr(d, "id") else d.index)(m.devices)


@pytest.mark.parametrize("axes", [None, {"db": 8}, {"dp": 2, "tp": 4}, {"dp": -1, "tp": 2},
                                  {"db": 4}, {"a": 2, "b": -1, "c": 2}])
def test_get_mesh_matches_jax(axes):
    want = jax_mesh(axes)
    got = port.get_mesh(axes, devices=CPUS)
    assert got.shape == dict(want.shape) and got.axis_names == want.axis_names
    np.testing.assert_array_equal(order(got), order(want))
    assert not got.distributed and got.group(got.axis_names) is None


@pytest.mark.parametrize("ici, dcn", [({"ici": 4}, {"dcn": 2}), ({"ici": -1}, {"dcn": 2}),
                                      ({"tp": 2}, {"dp": 2}), ({"ici": 2}, {"dcn": -1})])
def test_hybrid_mesh_single_process_matches_jax(ici, dcn):
    want = jax_hybrid(ici, dcn)
    got = port.get_hybrid_mesh(ici, dcn, devices=CPUS)
    assert got.shape == dict(want.shape) and got.axis_names == want.axis_names
    np.testing.assert_array_equal(order(got), order(want))
    assert not port.is_multi_process(got) and not jax_multi(want.devices.flat)


def test_mesh_asks_no_more_devices_than_given():
    with pytest.raises(AssertionError):
        jax_mesh({"db": 9})
    with pytest.raises(ValueError, match="needs 9 devices"):
        port.get_mesh({"db": 9}, devices=CPUS)
    with pytest.raises(ValueError, match="needs 16 devices"):
        port.get_hybrid_mesh({"ici": 8}, {"dcn": 2}, devices=CPUS)


def test_init_distributed_is_a_noop_in_one_process(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert jax_init() is False
    assert port.init_distributed() is False and port.init_distributed() is False
    assert not torch.distributed.is_initialized() and not port.is_multi_process()
    # a world of one, even with an address, stays single-process
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    assert port.init_distributed(world_size=1) is False


def test_layout_is_jax_shard_order():
    """``P(("dcn", "ici"))`` shards row-major over the named axes; the
    other axes index the rows of ``layout``."""
    m = port.get_mesh({"dp": 2, "db": 4}, devices=CPUS)
    devs, procs = m.layout(("db",))
    assert devs.shape == (2, 4) and procs.shape == (2, 4) and not procs.any()
    assert [d.index for d in devs[1]] == [4, 5, 6, 7]
    devs, _ = port.get_hybrid_mesh({"ici": 4}, {"dcn": 2}, devices=CPUS).layout(("dcn", "ici"))
    assert [d.index for d in devs[0]] == list(range(8))


def test_meshes_take_the_card_unless_told_otherwise(monkeypatch):
    """No fallback: without ``devices`` a mesh is the CUDA devices, and a
    host without them raises; the local count is 0 there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.get_mesh({"db": 2})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.get_hybrid_mesh({"ici": -1}, {"dcn": 1})
    assert port.local_device_count() == 0
    assert jax.local_device_count() == 8  # JAX's host devices, for the other tests
