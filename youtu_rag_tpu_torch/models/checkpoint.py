"""Training checkpoints: parameters, optimizer state, step and metadata.

The port's counterpart of ``youtu_rag_tpu/models/checkpoint.py``, with its
API (``save``, ``latest_step``, ``restore``, ``close``, ``max_to_keep``)
and without orbax: step ``n`` is the directory ``<dir>/<n>/`` holding
``params.pt`` and ``opt_state.pt`` (nested dicts of tensors, loadable with
``torch.load(weights_only=True)``) and ``metadata.json``. A save writes a
temporary directory and moves it into place with ``os.replace``, so a
reader sees a whole step or none. As orbax's manager does, a save of a
step at or below the latest one is skipped, and only the newest
``max_to_keep`` steps stay.

The JAX package's orbax checkpoints are not read here (ROADMAP Queue C):
the artifact both packages share is the npz deployment format
(``models.encoder.save_params_npz`` / ``load_params_npz``).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any

import torch

from ..utils.log import get_logger

logger = get_logger("models.checkpoint")


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return tree


def _like(tree: Any, template: Any) -> Any:
    """``tree``'s values on the devices (and in the dtypes) of
    ``template``'s leaves, with their ``requires_grad``."""
    if isinstance(tree, dict):
        return {k: _like(v, template.get(k) if isinstance(template, dict) else None)
                for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and isinstance(template, torch.Tensor):
        out = tree.to(device=template.device, dtype=template.dtype)
        return out.requires_grad_(template.requires_grad) if out.is_floating_point() else out
    return tree


class TrainCheckpointer:
    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def all_steps(self) -> list[int]:
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, params: Any, opt_state: Any, metadata: dict | None = None) -> None:
        latest = self.latest_step()
        if latest is not None and step <= latest:
            logger.info("checkpoint step %d not saved: step %d is already saved", step, latest)
            return
        tmp = Path(tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=self.directory))
        try:
            torch.save(_to_cpu(params), tmp / "params.pt")
            torch.save(_to_cpu(opt_state), tmp / "opt_state.pt")
            (tmp / "metadata.json").write_text(json.dumps(metadata or {}))
            os.replace(tmp, self.directory / str(step))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in self.all_steps()[: -self.max_to_keep]:
            shutil.rmtree(self.directory / str(old), ignore_errors=True)
        logger.info("saved checkpoint step %d -> %s", step, self.directory)

    def restore(self, step: int | None = None, params_like: Any = None,
                opt_state_like: Any = None):
        """Restore (params, opt_state, metadata). With ``params_like`` /
        ``opt_state_like`` (e.g. the live parameters and
        ``optimizer.init(params)``) each tensor lands on its template's
        device and dtype; without, on the CPU."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        d = self.directory / str(step)
        params = torch.load(d / "params.pt", weights_only=True)
        opt_state = torch.load(d / "opt_state.pt", weights_only=True)
        metadata = json.loads((d / "metadata.json").read_text())
        if params_like is not None:
            params = _like(params, params_like)
        if opt_state_like is not None:
            opt_state = _like(opt_state, opt_state_like)
        return params, opt_state, metadata

    def close(self) -> None:
        """Nothing to flush: every save is complete when it returns."""
