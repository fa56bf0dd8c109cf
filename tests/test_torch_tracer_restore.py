"""The port's parity tests hand the JAX tracer's span ring back as they
found it (``jax_tracer_restored``, ``tests/torch_native_helpers.py``).

The JAX package's span tests (``tests/tracing/test_span_coverage.py``)
read the spans a call adds past ``len(tracer.spans)``; once a process's
ring holds its 1,000 spans that slice is empty and they fail. One pytest
process runs a port-style module that fills the ring
(``tests/torch_tracer_filler.py``) and then the span tests: with the
fixture both pass, and without it (the control) both fail."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
SPAN_TESTS = ("test_retrieve_emits_embed_and_search_spans",
              "test_build_emits_per_source_ingest_spans")


@pytest.mark.parametrize("restore", [True, False], ids=["restored", "control"])
def test_span_tests_pass_after_a_port_module(restore):
    env = {**os.environ, "TRACER_FILLER_RESTORE": "1" if restore else "0"}
    env.pop("PYTEST_XDIST_WORKER", None)
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "no:xdist", "-p", "no:randomly",
         "-p", "no:cacheprovider", "-q", "-rA", f"--rootdir={TESTS.parent}",
         str(TESTS / "torch_tracer_filler.py"), str(TESTS / "tracing" / "test_span_coverage.py")],
        capture_output=True, text=True, cwd=TESTS.parent, env=env, timeout=300)
    lines = out.stdout.splitlines()
    assert any(l.startswith("PASSED") and "test_fill_jax_tracer" in l for l in lines), out.stdout
    want = "PASSED" if restore else "FAILED"
    for name in SPAN_TESTS:
        assert any(l.startswith(want) and name in l for l in lines), out.stdout[-3000:]
