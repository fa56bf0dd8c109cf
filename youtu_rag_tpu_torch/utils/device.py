"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the CUDA card; a host without one raises rather than
    falling back to the CPU. Pass ``device="cpu"`` for the plain path."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "youtu_rag_tpu_torch runs on CUDA by default and this host has no "
                "CUDA device; pass device='cpu' to run the plain PyTorch path"
            )
        return torch.device("cuda")
    return torch.device(device)


def serving_attention(device: torch.device) -> str:
    """The encoder's serving ``attention_impl`` on ``device``: the kernels
    on the card ("pallas"), plain attention elsewhere ("xla"), as the JAX
    package picks Pallas on a TPU only."""
    return "pallas" if device.type == "cuda" else "xla"
