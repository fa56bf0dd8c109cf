"""A fixture shared by the port's tests that hold its native host kernels
against the JAX package's C path.

The JAX package builds ``fasthash.c`` through cffi into one shared cache
directory. Test workers that start at once race for it, and a worker that
loses keeps the JAX package's Python fallback for the whole process; a
test that names the C path on both sides would then compare the port's C
path with JAX's Python path (1-2 ulp apart). Take ``jax_lib`` to run JAX's
C path whatever the race did."""

import pytest

import youtu_rag_tpu.native as jax_native


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
