"""Config loader: YAML composition + env interpolation → pydantic models.

Capability parity with ``utu/config/loader.py:14-72`` (Hydra + OmegaConf
composition over ``configs/**/*.yaml`` with ``${oc.env:VAR}``
interpolation) without the Hydra dependency:

- ``defaults:`` lists compose relative config files in order (later wins;
  ``_self_`` positions the file's own keys, defaulting to last);
- ``${oc.env:VAR}`` / ``${oc.env:VAR,fallback}`` / ``${env:VAR}``
  interpolate environment variables at load time;
- loaders validate into AgentConfig / RAGConfig / ToolkitConfig / EvalConfig.

The port's copy of ``youtu_rag_tpu/core/loader.py``; ``yaml`` is imported
inside the functions that parse, so the package imports without it.
"""

from __future__ import annotations

import copy
import os
import re
from pathlib import Path
from typing import Any

from ..utils.log import get_logger

logger = get_logger("core.loader")

_ENV_RE = re.compile(r"\$\{(?:oc\.)?env:([A-Za-z_][A-Za-z0-9_]*)(?:,([^}]*))?\}")


def _interp(value: Any) -> Any:
    if isinstance(value, str):

        def sub(m: re.Match) -> str:
            var, default = m.group(1), m.group(2)
            got = os.environ.get(var)
            if got is None:
                if default is None:
                    logger.warning("env var %s not set and no default", var)
                    return ""
                return default
            return got

        full = _ENV_RE.fullmatch(value)
        if full:  # full-string match may return non-str via YAML re-parse
            import yaml

            out = sub(full)
            try:
                return yaml.safe_load(out) if out != "" else ""
            except yaml.YAMLError:
                return out
        return _ENV_RE.sub(sub, value)
    if isinstance(value, list):
        return [_interp(v) for v in value]
    if isinstance(value, dict):
        return {k: _interp(v) for k, v in value.items()}
    return value


def _deep_merge(base: dict, overlay: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


class ConfigLoader:
    """Loads composed YAML configs from a ``configs/`` tree."""

    def __init__(self, root: str | Path | None = None):
        if root is None:
            for cand in (Path.cwd() / "configs", Path(__file__).resolve().parents[2] / "configs"):
                if cand.is_dir():
                    root = cand
                    break
            else:
                root = Path.cwd() / "configs"
        self.root = Path(root)

    def _resolve(self, name: str, group: str | None = None) -> Path:
        name = name if name.endswith((".yaml", ".yml")) else f"{name}.yaml"
        candidates = [self.root / group / name] if group else []
        candidates.append(self.root / name)
        for c in candidates:
            if c.exists():
                return c
        raise FileNotFoundError(f"config {name!r} not found under {self.root} (group={group})")

    def _resolve_relative(self, ref: str, current: Path, group: str | None) -> Path:
        """Resolve a defaults entry: relative to the current file's dir,
        the current dir + group, the configs root + group, then the root."""
        name = ref if ref.endswith((".yaml", ".yml")) else f"{ref}.yaml"
        candidates = []
        if group:
            candidates += [current.parent / group / name, self.root / group / name]
        candidates += [current.parent / name, self.root / name]
        for c in candidates:
            if c.exists():
                return c
        raise FileNotFoundError(f"defaults entry {ref!r} (group={group}) not found near {current}")

    def load_raw(self, name: str, group: str | None = None) -> dict:
        return self._load_path(self._resolve(name, group), ())

    def _load_path(self, path: Path, seen: tuple) -> dict:
        if str(path) in seen:
            raise ValueError(f"circular defaults: {' -> '.join(seen)} -> {path}")
        import yaml

        data = yaml.safe_load(path.read_text()) or {}
        assert isinstance(data, dict), f"{path} must contain a mapping"

        defaults = data.pop("defaults", None)
        own = data
        if not defaults:
            return _interp(own)

        merged: dict = {}
        self_done = False
        for item in defaults:
            if item == "_self_":
                merged = _deep_merge(merged, own)
                self_done = True
                continue
            if isinstance(item, dict):
                ((grp, sub),) = item.items()
                sub_path = self._resolve_relative(str(sub), path, str(grp))
            else:
                sub_path = self._resolve_relative(str(item), path, None)
            merged = _deep_merge(merged, self._load_path(sub_path, seen + (str(path),)))
        if not self_done:
            merged = _deep_merge(merged, own)
        return _interp(merged)

    # -- typed loaders (parity surface: loader.py:22-72) -------------------

    def load_agent_config(self, name: str):
        from ..agents.config import AgentConfig

        return AgentConfig.model_validate(self.load_raw(name, group="agents"))

    def load_rag_config(self, name: str = "default"):
        from .config import RAGConfig

        return RAGConfig.model_validate(self.load_raw(name, group="rag"))

    def load_toolkit_config(self, name: str):
        from ..tools.base import ToolkitConfig

        cfg = ToolkitConfig.model_validate(self.load_raw(name, group="tools"))
        cfg.name = cfg.name or name
        return cfg

    def load_eval_config(self, name: str):
        from ..eval.config import EvalConfig

        return EvalConfig.model_validate(self.load_raw(name, group="eval"))
