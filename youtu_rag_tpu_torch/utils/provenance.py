"""Self-describing benchmark reports: ``youtu_rag_tpu/utils/provenance.py``
for the port.

A report records the fixture seed, the git commit the run came from and
the run time, as the JAX module's does, and, when a card is present, the
card's name (``torch.cuda.get_device_name``) and the power limit it ran
under (``nvidia-smi``): a card set below 700 W runs slower under load.
"""

from __future__ import annotations

import subprocess
import time
from typing import Any

import torch

SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]


def git_head(cwd: str | None = None) -> str | None:
    """Current commit hash (None outside a git checkout / without git)."""
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                             timeout=10, cwd=cwd)
    except (OSError, subprocess.TimeoutExpired):
        return None
    h = out.stdout.strip()
    return h if out.returncode == 0 and len(h) == 40 else None


def card_line(index: int = 0) -> str | None:
    """Card ``index``'s line of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` (e.g. "NVIDIA H100 80GB HBM3, 700.00 W"); None
    without nvidia-smi."""
    try:
        out = subprocess.run(SMI_QUERY, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[index].strip() if out.returncode == 0 and len(lines) > index else None


def run_provenance(seed: int | None = None, **extra: Any) -> dict[str, Any]:
    """Provenance block for a benchmark report: seed + git hash + UTC time,
    and with a card present its name (``device_name``) and the
    ``nvidia-smi`` line of its name and power limit (``card``)."""
    prov: dict[str, Any] = {
        "git_hash": git_head(),
        "generated_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    if seed is not None:
        prov["fixture_seed"] = seed
    if torch.cuda.is_available():
        prov["device_name"] = torch.cuda.get_device_name(0)
        prov["card"] = card_line(0)
    prov.update(extra)
    return {"provenance": prov}
