"""Backend resolution for the port's benchmark entry points:
``youtu_rag_tpu/utils/devices.py`` over ``torch.cuda``.

A wedged CUDA stack can block its first initialization inside native code,
where Python signal handlers cannot run. ``probe_default_backend`` asks in
a **subprocess** with a hard timeout, so the parent can always report.

Unlike the JAX module there is no CPU fallback: ``resolve_backend`` asked
for the card on a host without a healthy one raises, and returns ``"cpu"``
only when the caller names the CPU. A measurement that finds no card
fails; it never runs on another device under the card's name.
"""

from __future__ import annotations

import subprocess
import sys

_PROBE_SRC = ("import torch; print('PLATFORM=' + "
              "('cuda' if torch.cuda.is_available() and torch.cuda.device_count() else ''))")


def probe_default_backend(timeout_s: float = 150.0) -> str | None:
    """Probe CUDA in a killable subprocess: ``"cuda"`` when a card
    initializes, ``None`` when none does or the probe times out."""
    try:
        r = subprocess.run([sys.executable, "-c", _PROBE_SRC], capture_output=True, text=True,
                           timeout=timeout_s)
    except (subprocess.TimeoutExpired, OSError):
        return None
    if r.returncode != 0:
        return None
    for line in reversed(r.stdout.strip().splitlines()):
        if line.startswith("PLATFORM="):
            return line.split("=", 1)[1].strip() or None
    return None


def resolve_backend(device: str | None = None, timeout_s: float = 150.0) -> str:
    """The platform label a benchmark reports: ``"cpu"`` when ``device``
    names the CPU, else ``"cuda"`` once the probe saw a card. Raises
    RuntimeError when the card was asked for (``device`` None or a CUDA
    device) and the probe found none. Call it before the first in-process
    CUDA use."""
    if device is not None and str(device).split(":")[0] == "cpu":
        return "cpu"
    if device is not None and str(device).split(":")[0] != "cuda":
        raise ValueError(f"unsupported device {device!r}: expected 'cuda[:n]' or 'cpu'")
    if probe_default_backend(timeout_s) is None:
        raise RuntimeError("no CUDA device answered the probe; pass device='cpu' to run on the "
                           "CPU (results then name the CPU, never the card)")
    return "cuda"
