"""Device-level profiling: ``youtu_rag_tpu/tracing/profiler.py`` on
``torch.profiler``. ``device_trace`` records the enclosed block (host ops
and, on a card, its kernels through CUPTI) and writes a Chrome trace
(``trace.json``, readable in Perfetto or ``chrome://tracing``) into a
directory of its own under ``profile_dir()``; ``annotate`` names a span
inside it."""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from pathlib import Path

import torch

from ..utils.log import get_logger

logger = get_logger("tracing.profiler")


def profile_dir() -> Path:
    """``YRT_PROFILE_DIR``, else ``yrt-profiles`` in the temporary directory."""
    d = Path(os.environ.get("YRT_PROFILE_DIR") or Path(tempfile.gettempdir()) / "yrt-profiles")
    d.mkdir(parents=True, exist_ok=True)
    return d


@contextlib.contextmanager
def device_trace(name: str = "trace", enabled: bool | None = None):
    """Profile the enclosed block:

        with device_trace("kb-search"):
            store.search_batch(...)

    Enabled when ``YRT_PROFILE`` is set to anything non-empty (as the JAX
    package reads it) or ``enabled=True``; otherwise a no-op yielding None,
    so the hook can stay in hot paths. Yields the trace's directory,
    ``<profile_dir>/<name>-<unix time>``, which holds ``trace.json`` once
    the block ends."""
    if enabled is None:
        enabled = bool(os.environ.get("YRT_PROFILE"))
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    out = profile_dir() / f"{name}-{int(time.time())}"
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logger.info("capturing device trace -> %s", out)
    with profile(activities=activities) as prof:
        yield out
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))


@contextlib.contextmanager
def annotate(label: str):
    """A named span inside a device trace (``torch.profiler.record_function``)."""
    with torch.profiler.record_function(label):
        yield
