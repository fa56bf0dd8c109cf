"""The port's agent environments (``agents/env.py``, ``agents/docker_env.py``
and ``SimpleAgent``'s env block) against the JAX package's, on the CPU.

- the env cases of ``tests/agents/test_context_env.py`` (a shell workspace
  with its tools and its cleanup, the factory, an agent that runs
  ``run_bash`` in its env, the browser env's gate) on both packages;
- the 6 cases of ``tests/agents/test_docker_env.py`` with the fake docker
  CLI runner (no daemon needed): port allocation, the container
  lifecycle and pool cap, a failed run, orphans, ``BrowserEnv`` over a
  manager, the gate without docker. The same CLI calls, statuses and
  states on both packages.

Tolerance: none; every compared value is text, a status or a CLI call."""

import asyncio
import json
import os
import random
import types
import uuid

import pytest

import youtu_rag_tpu.agents.docker_env as jax_docker
import youtu_rag_tpu.agents.env as jax_env
import youtu_rag_tpu_torch.agents.docker_env as docker
import youtu_rag_tpu_torch.agents.env as env
from youtu_rag_tpu.agents.config import AgentConfig as JaxAgentConfig
from youtu_rag_tpu.agents.config import EnvConfig as JaxEnvConfig
from youtu_rag_tpu.agents.llm import FakeChatClient as JaxFake
from youtu_rag_tpu.agents.simple_agent import SimpleAgent as JaxSimpleAgent
from youtu_rag_tpu_torch.agents.config import AgentConfig, EnvConfig
from youtu_rag_tpu_torch.agents.llm import FakeChatClient
from youtu_rag_tpu_torch.agents.simple_agent import SimpleAgent
from torch_native_helpers import jax_tracer_restored  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("jax_tracer_restored")


def package(jax: bool):
    if jax:
        return types.SimpleNamespace(env=jax_env, docker=jax_docker, AgentConfig=JaxAgentConfig,
                                     EnvConfig=JaxEnvConfig, Fake=JaxFake,
                                     SimpleAgent=JaxSimpleAgent)
    return types.SimpleNamespace(env=env, docker=docker, AgentConfig=AgentConfig,
                                 EnvConfig=EnvConfig, Fake=FakeChatClient, SimpleAgent=SimpleAgent)


class FakeDocker:
    """Scripts docker CLI replies; records the calls (the JAX test's)."""

    def __init__(self):
        self.calls = []
        self.running = {}
        self.n = 0
        self.fail_next_run = False

    async def __call__(self, args):
        self.calls.append(args)
        cmd = args[0]
        if cmd == "run":
            if self.fail_next_run:
                self.fail_next_run = False
                return 125, "", "docker: image pull backoff"
            self.n += 1
            cid = f"{self.n:012x}" + "e" * 52
            self.running[cid[:12]] = args
            return 0, cid + "\n", ""
        if cmd == "stop":
            self.running.pop(args[1][:12], None)
            return 0, args[1] + "\n", ""
        if cmd == "exec":
            return 0, "exec-output\n", ""
        if cmd == "ps":
            rows = [json.dumps({"ID": cid}) for cid in self.running]
            return 0, "\n".join(rows) + "\n", ""
        return 1, "", f"unknown {cmd}"


def without_ports(calls):
    """CLI calls with the host port of ``-p`` left out: the manager takes
    the first free port of its range, which another process may hold."""
    return [[a.split(":")[1] if i and call[i - 1] == "-p" else a for i, a in enumerate(call)]
            for call in calls]


# ---------------------------------------------------------------------------
# tests/agents/test_context_env.py's env cases
# ---------------------------------------------------------------------------


def case_shell_env_tools_and_cleanup(ns):
    e = ns.env.ShellLocalEnv()
    asyncio.run(e.build())
    names = set()
    for t in e.get_tools():
        names.update(t.tools_map)
    assert {"run_bash", "execute_python_code", "read_file"} <= names
    ws = e.workspace
    assert os.path.exists(ws) and e.get_state() == f"workspace: {ws}"
    asyncio.run(e.cleanup())
    assert not os.path.exists(ws)
    return sorted(names), [type(t).__name__ for t in e.get_tools()]


def case_env_factory_and_agent_integration(ns):
    assert isinstance(ns.env.get_env(None), ns.env.BasicEnv)
    cfg = ns.AgentConfig(env=ns.EnvConfig(name="shell_local"))
    client = ns.Fake(scripted=[
        ns.Fake.tool_response("run_bash", {"command": "echo hello-from-env > f.txt; cat f.txt"}),
        ns.Fake.tool_response("execute_python_code", {"code": "print(open('f.txt').read())"}),
        ns.Fake.text_response("ran")])
    agent = ns.SimpleAgent(cfg, client=client)
    rec = asyncio.run(agent.run("run echo"))
    assert rec.tool_calls[0].output.strip() == "hello-from-env"
    ws = agent.env.workspace
    assert os.path.exists(os.path.join(ws, "f.txt"))
    asyncio.run(agent.cleanup())
    assert not os.path.exists(ws)
    return [(t.name, t.arguments, t.output) for t in rec.tool_calls], rec.final_output


def case_env_factory_names(ns):
    out = []
    for name in (None, "basic", "shell_local", "shell", "browser"):
        cfg = None if name is None else ns.EnvConfig(name=name)
        out.append(type(ns.env.get_env(cfg)).__name__)
    with pytest.raises(ValueError, match="unknown env"):
        ns.env.get_env(ns.EnvConfig(name="nope"))
    keep = ns.env.get_env(types.SimpleNamespace(name="shell_local",
                                                config={"workspace": "/x/ws"}))
    return out, keep.workspace, keep.keep


def case_browser_env_gated(ns):
    e = ns.env.BrowserEnv()
    with pytest.raises((RuntimeError, NotImplementedError)) as info:
        asyncio.run(e.build())
    return type(info.value).__name__, "requires a docker daemon" in str(info.value)


# ---------------------------------------------------------------------------
# tests/agents/test_docker_env.py
# ---------------------------------------------------------------------------


def case_port_manager_allocate_release(ns):
    pm = ns.docker.PortManager((9400, 9404))
    ports = [pm.allocate_port() for _ in range(5)]
    assert all(p is not None for p in ports) and len(set(ports)) == 5
    assert pm.allocate_port() is None
    pm.release_port(ports[0])
    assert pm.allocate_port() == ports[0]
    assert not pm.reserve_port(ports[1])
    return len(pm.allocated)


def case_container_lifecycle_and_pool_cap(ns):
    fake = FakeDocker()
    mgr = ns.docker.DockerManager(num_max=2, runner=fake)

    async def go():
        a = await mgr.start_container("env-a")
        b = await mgr.start_container("env-b")
        assert a.status == ns.docker.ContainerStatus.RUNNING and a.port != b.port
        with pytest.raises(RuntimeError, match="pool exhausted"):
            await mgr.start_container("env-c")
        rc, out = await mgr.exec("env-a", ["echo", "hi"])
        assert rc == 0 and "exec-output" in out
        assert await mgr.stop_container("env-a")
        assert mgr.get_status("env-a")["status"] == "stopped"
        c = await mgr.start_container("env-c")
        assert c.status == ns.docker.ContainerStatus.RUNNING
        assert await mgr.stop_all() == 2
        return a

    a = asyncio.run(go())
    assert any(x[0] == "run" and "yrt-env=env-a" in x for x in fake.calls)
    assert a.port not in mgr.ports.allocated
    return without_ports(fake.calls), [
        {k: v for k, v in s.items() if k != "port"} for s in mgr.get_all_status()]


def case_run_failure_releases_port(ns):
    fake = FakeDocker()
    fake.fail_next_run = True
    mgr = ns.docker.DockerManager(runner=fake)

    async def go():
        with pytest.raises(RuntimeError, match="docker run failed"):
            await mgr.start_container("bad")

    asyncio.run(go())
    assert not mgr.ports.allocated
    assert mgr.get_status("bad")["status"] == "error"
    return {k: v for k, v in mgr.get_status("bad").items() if k != "port"}


def case_find_orphans(ns):
    fake = FakeDocker()
    mgr = ns.docker.DockerManager(runner=fake)

    async def go():
        await mgr.start_container("mine")
        fake.running["deadbeef0000"] = ["run"]
        return await mgr.find_orphans(stop=True)

    orphans = asyncio.run(go())
    assert orphans == ["deadbeef0000"]
    assert "deadbeef0000" not in fake.running
    return orphans, without_ports(fake.calls)


def case_browser_env_with_fake_manager(ns):
    fake = FakeDocker()
    e = ns.env.BrowserEnv(manager=ns.docker.DockerManager(runner=fake))

    async def go():
        await e.build()
        state = e.get_state()
        await e.cleanup()
        return state

    state = asyncio.run(go())
    assert "browser sandbox on 127.0.0.1:" in state and "running" in state
    assert e.get_state() == "browser sandbox: not started"
    return state.split(":")[0], state.split("(")[1], without_ports(fake.calls)


def case_browser_env_gated_without_docker(ns):
    e = ns.env.get_env(type("C", (), {"name": "browser", "config": {}})())
    with pytest.raises(RuntimeError, match="docker daemon"):
        asyncio.run(e.build())
    return type(e).__name__


CASES = [case_shell_env_tools_and_cleanup, case_env_factory_and_agent_integration,
         case_env_factory_names, case_browser_env_gated, case_port_manager_allocate_release,
         case_container_lifecycle_and_pool_cap, case_run_failure_releases_port,
         case_find_orphans, case_browser_env_with_fake_manager,
         case_browser_env_gated_without_docker]


@pytest.fixture
def no_docker(monkeypatch):
    """No docker CLI on the path, whatever the host has; each package's
    container ids from its own seeded stream (the same on both)."""
    for mod in (docker, jax_docker):
        monkeypatch.setattr(mod.shutil, "which", lambda name: None)
        ids = random.Random(0)
        monkeypatch.setattr(mod, "uuid", types.SimpleNamespace(
            uuid4=lambda ids=ids: uuid.UUID(int=ids.getrandbits(128))))


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_case_matches_jax(case, no_docker):
    assert case(package(jax=False)) == case(package(jax=True))


def test_docker_manager_needs_the_cli_or_a_runner(no_docker):
    assert not docker.docker_available()
    with pytest.raises(RuntimeError, match="docker CLI"):
        docker.DockerManager()
    assert isinstance(docker.DockerManager(runner=FakeDocker()), docker.DockerManager)
