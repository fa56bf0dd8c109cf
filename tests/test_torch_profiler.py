"""The port's device profiler (``youtu_rag_tpu_torch/tracing/profiler.py``)
against the JAX package's ``tracing/profiler.py``: the same directory
rule (``YRT_PROFILE_DIR``), a no-op unless ``YRT_PROFILE`` is set or
``enabled=True`` (both yield None then, and write nothing), and when on, a
trace directory named ``<name>-<unix time>`` under it; the port's holds a
Chrome trace with the block's ``annotate`` span and its operations. No
number is compared, so no tolerance."""

import json

import pytest
import torch

from youtu_rag_tpu.tracing import profiler as jax_profiler
from youtu_rag_tpu_torch.tracing import profiler
from torch_native_helpers import jax_tracer_restored  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("jax_tracer_restored")


def test_profile_dir_follows_the_env_like_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("YRT_PROFILE_DIR", str(tmp_path / "prof"))
    assert profiler.profile_dir() == jax_profiler.profile_dir() == tmp_path / "prof"
    assert (tmp_path / "prof").is_dir()


@pytest.mark.parametrize("env, enabled", [(None, None), ("", None), ("1", False)])
def test_device_trace_is_a_noop_when_off(monkeypatch, tmp_path, env, enabled):
    monkeypatch.setenv("YRT_PROFILE_DIR", str(tmp_path))
    if env is None:
        monkeypatch.delenv("YRT_PROFILE", raising=False)
    else:
        monkeypatch.setenv("YRT_PROFILE", env)
    with profiler.device_trace("off", enabled=enabled) as out, \
            jax_profiler.device_trace("off", enabled=enabled) as jax_out:
        torch.ones(3).sum()
    assert out is None and jax_out is None and not list(tmp_path.iterdir())


@pytest.mark.parametrize("how", ["env", "argument"])
def test_device_trace_writes_a_chrome_trace(monkeypatch, tmp_path, how):
    monkeypatch.setenv("YRT_PROFILE_DIR", str(tmp_path))
    if how == "env":
        monkeypatch.setenv("YRT_PROFILE", "1")
    with profiler.device_trace("kb-search", enabled=True if how == "argument" else None) as out:
        with profiler.annotate("rerank"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    assert out.parent == tmp_path and out.name.startswith("kb-search-")
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "rerank" in names and any("mm" in str(n) for n in names)


def test_annotate_outside_a_trace_is_harmless():
    with profiler.annotate("idle"):
        assert torch.ones(2).sum() == 2
