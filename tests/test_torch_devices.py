"""The port's ``utils/devices.py`` and ``utils/provenance.py`` against the
JAX package's.

``resolve_backend`` keeps JAX's names but not its CPU fallback: asked for
the card on a host without one it raises, and it answers "cpu" only when
the caller names the CPU. ``run_provenance`` gives JAX's keys for the same
seed on a host without a card, and adds the card's name and its
``nvidia-smi`` name and power limit where one is present."""

import subprocess

import pytest
import torch

from youtu_rag_tpu.utils import devices as jax_devices
from youtu_rag_tpu.utils import provenance as jax_provenance
from youtu_rag_tpu_torch.utils import devices, provenance


def test_probe_without_a_card_raises_and_never_falls_back():
    """The real probe, in its subprocess: on a host without CUDA the card is
    refused; on one with a card it answers "cuda"."""
    if torch.cuda.is_available():
        assert devices.probe_default_backend() == "cuda"
        assert devices.resolve_backend() == "cuda"
        return
    assert devices.probe_default_backend() is None
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            devices.resolve_backend(device)


def test_cpu_only_when_named(monkeypatch):
    def no_probe(timeout_s=150.0):
        raise AssertionError("the CPU was named: no probe")

    monkeypatch.setattr(devices, "probe_default_backend", no_probe)
    assert devices.resolve_backend("cpu") == "cpu"
    assert devices.resolve_backend(torch.device("cpu")) == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        devices.resolve_backend("mps")


def test_failed_probe_raises_where_jax_falls_back(monkeypatch):
    monkeypatch.setattr(devices, "probe_default_backend", lambda timeout_s=150.0: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        devices.resolve_backend()
    monkeypatch.setattr(devices, "probe_default_backend", lambda timeout_s=150.0: "cuda")
    assert devices.resolve_backend() == devices.resolve_backend("cuda:1") == "cuda"
    # JAX's module names its fallback; the port has none to name
    assert jax_devices.FALLBACK_LABEL == "unavailable-fallback-cpu"
    assert not hasattr(devices, "FALLBACK_LABEL")
    assert {"probe_default_backend", "resolve_backend"} <= set(vars(devices))


@pytest.mark.parametrize("outcome,want", [
    (subprocess.TimeoutExpired("python", 1.0), None),
    (OSError("no python"), None),
    (subprocess.CompletedProcess([], 1, "PLATFORM=cuda\n", ""), None),
    (subprocess.CompletedProcess([], 0, "noise\nPLATFORM=\n", ""), None),
    (subprocess.CompletedProcess([], 0, "warning\nPLATFORM=cuda\n", ""), "cuda"),
])
def test_probe_reads_its_subprocess_as_jax_does(monkeypatch, outcome, want):
    def run(cmd, **kw):
        assert kw["timeout"] == 7.0
        if isinstance(outcome, BaseException):
            raise outcome
        return outcome

    monkeypatch.setattr(subprocess, "run", run)
    assert devices.probe_default_backend(timeout_s=7.0) == want
    assert jax_devices.probe_default_backend(timeout_s=7.0) == (want and "cuda")


@pytest.mark.parametrize("seed,extra", [(None, {}), (0, {}), (7, {"corpus": "x", "n": 3})])
def test_provenance_keys_match_jax(monkeypatch, seed, extra):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    got = provenance.run_provenance(seed=seed, **extra)["provenance"]
    want = jax_provenance.run_provenance(seed=seed, **extra)["provenance"]
    assert set(got) == set(want)
    for key in set(want) - {"generated_utc"}:
        assert got[key] == want[key], key
    assert got["git_hash"] == provenance.git_head() == jax_provenance.git_head()


def test_provenance_names_the_card(monkeypatch):
    smi = "NVIDIA H100 80GB HBM3, 700.00 W"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")

    def run(cmd, **kw):
        if cmd == provenance.SMI_QUERY:
            return subprocess.CompletedProcess(cmd, 0, smi + "\n", "")
        return subprocess.CompletedProcess(cmd, 0, "a" * 40 + "\n", "")

    monkeypatch.setattr(subprocess, "run", run)
    got = provenance.run_provenance(seed=3)["provenance"]
    want = jax_provenance.run_provenance(seed=3)["provenance"]
    assert set(got) - set(want) == {"device_name", "card"}
    assert got["device_name"] == "NVIDIA H100 80GB HBM3" and got["card"] == smi
    assert got["git_hash"] == "a" * 40 and got["fixture_seed"] == 3


def test_card_line_without_nvidia_smi(monkeypatch):
    def missing(cmd, **kw):
        raise FileNotFoundError(cmd[0])

    monkeypatch.setattr(subprocess, "run", missing)
    assert provenance.card_line() is None
    assert provenance.git_head() is None
