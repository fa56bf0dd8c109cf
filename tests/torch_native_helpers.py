"""Fixtures shared by the port's tests that drive the JAX package.

``jax_tracer_restored``: the JAX package keeps one global tracer with a
ring of its last 1,000 spans (``youtu_rag_tpu/tracing/tracer.py``), and
its own span tests read the spans a call adds past the ring's length. A
port test that runs the JAX package beside the port adds spans to that
ring; every such module takes this fixture, so it hands the ring back as
it found it.

``jax_lib``: for the tests that hold the port's native host kernels
against the JAX package's C path. The JAX package builds ``fasthash.c``
through cffi into one shared cache directory. Test workers that start at once race for it, and a worker that
loses keeps the JAX package's Python fallback for the whole process; a
test that names the C path on both sides would then compare the port's C
path with JAX's Python path (1-2 ulp apart). Take ``jax_lib`` to run JAX's
C path whatever the race did."""

import pytest

import youtu_rag_tpu.native as jax_native
from youtu_rag_tpu.tracing.tracer import get_tracer as jax_get_tracer


@pytest.fixture(scope="module")
def jax_tracer_restored():
    """The JAX tracer's spans as the module found them, at its teardown."""
    saved = list(jax_get_tracer().spans)
    yield
    jax_get_tracer().spans[:] = saved


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX package's cffi library, built again in a directory of this
    module's own when the process lost the shared cache's build race."""
    if jax_native.get_fasthash()[1] is not None:
        yield jax_native.get_fasthash()
        return
    mp = pytest.MonkeyPatch()
    mp.setenv("YRT_NATIVE_CACHE", str(tmp_path_factory.mktemp("jax_native")))
    mp.setattr(jax_native, "_tried", False)
    mp.setattr(jax_native, "_lib", None)
    mp.setattr(jax_native, "_ffi", None)
    got = jax_native.get_fasthash()
    assert got[1] is not None, "the JAX package's native kernel does not build here"
    yield got
    mp.undo()


@pytest.fixture(scope="module")
def torch_one_thread():
    """torch's intra-op threads at 1 for the module, then as they were: the
    trainers' tests run tiny models, which gain nothing from more threads
    and lose much to oversubscription beside the suite's other workers."""
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
