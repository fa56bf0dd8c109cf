"""Docker container lifecycle + port management for sandbox envs: a copy of
``youtu_rag_tpu/agents/docker_env.py``.

Capability parity with ``utu/env/utils/docker_manager.py:1-408`` (pooled
browser-sandbox containers with tracked status, start/stop/stop-all,
orphan discovery) and ``port_manager.py`` (host-port allocation). The
reference drives the docker-py SDK; this build shells out to the ``docker``
CLI through an injectable async runner so the full lifecycle is testable
with a fake runner when no daemon exists (the env factory gates on
availability and reports cleanly)."""

from __future__ import annotations

import asyncio
import json
import shutil
import socket
import uuid
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Awaitable, Callable

from ..utils.log import get_logger

logger = get_logger("agents.docker")


class PortManager:
    """Host-port allocation in a range (ref: port_manager.py)."""

    def __init__(self, port_range: tuple[int, int] = (9000, 9999)):
        self.low, self.high = port_range
        self._allocated: set[int] = set()

    def is_port_available(self, port: int) -> bool:
        if port in self._allocated:
            return False
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            return s.connect_ex(("127.0.0.1", port)) != 0

    def allocate_port(self) -> int | None:
        for port in range(self.low, self.high + 1):
            if self.is_port_available(port):
                self._allocated.add(port)
                return port
        return None

    def reserve_port(self, port: int) -> bool:
        if not self.is_port_available(port):
            return False
        self._allocated.add(port)
        return True

    def release_port(self, port: int) -> None:
        self._allocated.discard(port)

    @property
    def allocated(self) -> set[int]:
        return set(self._allocated)


class ContainerStatus(str, Enum):
    STARTING = "starting"
    RUNNING = "running"
    STOPPED = "stopped"
    ERROR = "error"


@dataclass
class ContainerInfo:
    id: str
    cid: str = ""
    image: str = ""
    port: int | None = None
    status: ContainerStatus = ContainerStatus.STARTING
    error: str = ""
    labels: dict[str, Any] = field(default_factory=dict)


Runner = Callable[[list[str]], Awaitable[tuple[int, str, str]]]


async def _cli_runner(args: list[str]) -> tuple[int, str, str]:
    proc = await asyncio.create_subprocess_exec(
        "docker", *args, stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE
    )
    out, err = await proc.communicate()
    return proc.returncode, out.decode(errors="replace"), err.decode(errors="replace")


def docker_available() -> bool:
    return shutil.which("docker") is not None


class DockerManager:
    """Tracked container lifecycle over the docker CLI.

    ``runner`` is injectable: tests pass a fake that scripts CLI replies,
    so start/stop/find-orphans logic is exercised without a daemon."""

    LABEL = "yrt-env"

    def __init__(
        self,
        image: str = "env_browser_chromium:latest",
        num_max: int = -1,
        port_range: tuple[int, int] = (9000, 9999),
        runner: Runner | None = None,
    ):
        if runner is None and not docker_available():
            raise RuntimeError(
                "DockerManager needs the docker CLI (none found); "
                "pass a runner for tests or install docker"
            )
        self.image = image
        self.num_max = num_max
        self.ports = PortManager(port_range)
        self.runner = runner or _cli_runner
        self.containers: dict[str, ContainerInfo] = {}

    async def start_container(self, env_id: str | None = None) -> ContainerInfo:
        """Run one sandbox container with a host port mapped to 9222
        (CDP/MCP endpoint in the reference's browser image)."""
        if self.num_max > 0 and sum(
            1 for c in self.containers.values() if c.status == ContainerStatus.RUNNING
        ) >= self.num_max:
            raise RuntimeError(f"container pool exhausted (num_max={self.num_max})")
        env_id = env_id or f"env-{uuid.uuid4().hex[:8]}"
        port = self.ports.allocate_port()
        if port is None:
            raise RuntimeError("no free host ports in range")
        info = ContainerInfo(id=env_id, image=self.image, port=port)
        self.containers[env_id] = info
        rc, out, err = await self.runner(
            [
                "run", "-d", "--rm",
                "--label", f"{self.LABEL}={env_id}",
                "-p", f"{port}:9222",
                self.image,
            ]
        )
        if rc != 0:
            info.status = ContainerStatus.ERROR
            info.error = err.strip()[:500]
            self.ports.release_port(port)
            raise RuntimeError(f"docker run failed: {info.error}")
        info.cid = out.strip()[:64]
        info.status = ContainerStatus.RUNNING
        logger.info("container %s (%s) on port %d", env_id, info.cid[:12], port)
        return info

    async def stop_container(self, env_id: str) -> bool:
        info = self.containers.get(env_id)
        if info is None or not info.cid:
            return False
        rc, _, err = await self.runner(["stop", info.cid])
        info.status = ContainerStatus.STOPPED if rc == 0 else ContainerStatus.ERROR
        if rc != 0:
            info.error = err.strip()[:500]
        if info.port is not None:
            self.ports.release_port(info.port)
        return rc == 0

    async def stop_all(self) -> int:
        n = 0
        for env_id, info in list(self.containers.items()):
            if info.status == ContainerStatus.RUNNING and await self.stop_container(env_id):
                n += 1
        return n

    async def exec(self, env_id: str, cmd: list[str]) -> tuple[int, str]:
        info = self.containers.get(env_id)
        if info is None or info.status != ContainerStatus.RUNNING:
            raise RuntimeError(f"container {env_id} is not running")
        rc, out, err = await self.runner(["exec", info.cid, *cmd])
        return rc, out if rc == 0 else f"{out}\n{err}"

    async def find_orphans(self, stop: bool = False) -> list[str]:
        """Discover containers carrying our label that this manager does
        not track (crashed previous runs; ref: find_all)."""
        rc, out, _ = await self.runner(
            ["ps", "--filter", f"label={self.LABEL}", "--format", "{{json .}}"]
        )
        if rc != 0:
            return []
        known = {c.cid[:12] for c in self.containers.values() if c.cid}
        orphans = []
        for line in out.strip().split("\n"):
            if not line.strip():
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            cid = str(row.get("ID", ""))[:12]
            if cid and cid not in known:
                orphans.append(cid)
        if stop:
            for cid in orphans:
                await self.runner(["stop", cid])
        return orphans

    def get_status(self, env_id: str) -> dict[str, Any]:
        info = self.containers.get(env_id)
        if info is None:
            return {"id": env_id, "status": "unknown"}
        return {
            "id": info.id, "cid": info.cid[:12], "image": info.image,
            "port": info.port, "status": info.status.value, "error": info.error,
        }

    def get_all_status(self) -> list[dict[str, Any]]:
        return [self.get_status(i) for i in self.containers]
