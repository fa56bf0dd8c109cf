"""Agent execution environments: a copy of ``youtu_rag_tpu/agents/env.py``
on the port's toolkits.

Parity with ``utu/env`` (``BaseEnv.get_state/get_tools/build/cleanup``,
``base_env.py:8-33``; ``BasicEnv``/``ShellLocalEnv``/``BrowserEnv`` and the
factory ``env/__init__.py:8-22``):

- ``BasicEnv``      — no extra tools/state;
- ``ShellLocalEnv`` — a workspace directory + bash/python/file toolkits;
- ``BrowserEnv``    — docker-backed browser sandbox; gated on a docker
  daemon (``docker_manager.py`` lifecycle) — where none is reachable,
  building it raises with a clear message."""

from __future__ import annotations

import shutil
import tempfile

from ..tools.base import AsyncBaseToolkit
from ..utils.log import get_logger

logger = get_logger("agents.env")


class BaseEnv:
    async def build(self) -> None:
        ...

    async def cleanup(self) -> None:
        ...

    def get_state(self) -> str:
        return ""

    def get_tools(self) -> list[AsyncBaseToolkit]:
        return []


class BasicEnv(BaseEnv):
    pass


class ShellLocalEnv(BaseEnv):
    """Local workspace with shell/python/file tools."""

    def __init__(self, workspace: str | None = None, keep: bool = False):
        self.workspace = workspace or tempfile.mkdtemp(prefix="yrt-env-")
        self.keep = keep or workspace is not None
        self._toolkits: list[AsyncBaseToolkit] = []

    async def build(self) -> None:
        from ..tools.builtin import BashToolkit, FileToolkit, PythonExecutorToolkit

        cfg = {"workspace": self.workspace}
        self._toolkits = [
            BashToolkit({"workspace": self.workspace}),
            PythonExecutorToolkit(cfg),
            FileToolkit(cfg),
        ]

    async def cleanup(self) -> None:
        if not self.keep:
            shutil.rmtree(self.workspace, ignore_errors=True)

    def get_state(self) -> str:
        return f"workspace: {self.workspace}"

    def get_tools(self) -> list[AsyncBaseToolkit]:
        return self._toolkits


class BrowserEnv(BaseEnv):
    """Docker browser sandbox (ref: env/utils/docker_manager.py +
    BrowserEnv): a labeled container exposing a CDP/MCP endpoint on an
    allocated host port. Gated on a docker daemon — without one, build()
    raises with a clear message; the manager itself is fully testable
    through an injected fake runner."""

    def __init__(self, image: str = "env_browser_chromium:latest", manager=None, **kwargs):
        self.image = image
        self.kwargs = kwargs
        self.manager = manager  # injectable DockerManager (tests)
        self.container = None

    async def build(self) -> None:
        from .docker_env import DockerManager, docker_available

        if self.manager is None:
            if not docker_available():
                raise RuntimeError(
                    "BrowserEnv requires a docker daemon (no docker CLI found); "
                    "use ShellLocalEnv or point YRT_DOCKER_HOST at a daemon"
                )
            self.manager = DockerManager(image=self.image)
        self.container = await self.manager.start_container()

    async def cleanup(self) -> None:
        if self.manager is not None and self.container is not None:
            await self.manager.stop_container(self.container.id)
            self.container = None

    def get_state(self) -> str:
        if self.container is None:
            return "browser sandbox: not started"
        return f"browser sandbox on 127.0.0.1:{self.container.port} ({self.container.status.value})"


def get_env(config=None) -> BaseEnv:
    """Factory (ref: env/__init__.py get_env)."""
    name = getattr(config, "name", None) if config is not None else None
    cfg = dict(getattr(config, "config", {}) or {})
    if not name or name == "basic":
        return BasicEnv()
    if name in ("shell_local", "shell"):
        return ShellLocalEnv(**cfg)
    if name == "browser":
        return BrowserEnv(**cfg)
    raise ValueError(f"unknown env {name!r}")
