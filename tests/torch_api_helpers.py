"""Shared pieces of the port's API tests: the small index every test KB
uses, ``ApiState`` makers for both packages, multipart bodies, SSE cards,
an app served on localhost beside another, and a fixture that takes out
of the port's process-wide KB registry what a test put there."""

from __future__ import annotations

import json
import tempfile
import types

import pytest

SMALL_INDEX = dict(min_capacity=256, block_rows=128)


def package(name: str) -> types.SimpleNamespace:
    """The modules an API test touches, from the JAX package ("jax") or the
    port ("port"); ``kw`` holds what the port's constructors need to run on
    the CPU."""
    if name == "jax":
        from youtu_rag_tpu.agents import llm, simple_agent
        from youtu_rag_tpu.agents.config import AgentConfig
        from youtu_rag_tpu.api import app, state
        from youtu_rag_tpu.core import config
        from youtu_rag_tpu.db.service import DBService
        from youtu_rag_tpu.retrieval import kb
        from youtu_rag_tpu.tools.base import ToolkitConfig
        kw: dict = {}
    else:
        from youtu_rag_tpu_torch.agents import llm, simple_agent
        from youtu_rag_tpu_torch.agents.config import AgentConfig
        from youtu_rag_tpu_torch.api import app, state
        from youtu_rag_tpu_torch.core import config
        from youtu_rag_tpu_torch.db.service import DBService
        from youtu_rag_tpu_torch.retrieval import kb
        from youtu_rag_tpu_torch.tools.base import ToolkitConfig
        kw = {"device": "cpu"}
    return types.SimpleNamespace(
        name=name, app=app, state=state, config=config, kb=kb, kw=kw,
        AgentConfig=AgentConfig, FakeChatClient=llm.FakeChatClient,
        SimpleAgent=simple_agent.SimpleAgent, DBService=DBService, ToolkitConfig=ToolkitConfig)


def small_rag(pkg):
    cfg = pkg.config
    return cfg.RAGConfig(vector_store=cfg.VectorStoreConfig(index=cfg.IndexConfig(**SMALL_INDEX)))


def make_state(pkg, prefix: str = "yrt-api", data_dir: str | None = None, **kw):
    """An ``ApiState`` of ``pkg`` on the small index, in a data dir of its own."""
    kw.setdefault("rag_config", small_rag(pkg))
    data_dir = data_dir or tempfile.mkdtemp(prefix=f"{prefix}-{pkg.name}-")
    return pkg.state.ApiState(data_dir=data_dir, **kw, **pkg.kw)


def multipart(filename: str, content: bytes, ctype: str = "application/octet-stream",
              metadata: dict | None = None) -> tuple[bytes, dict]:
    boundary = "xyzboundary"
    parts = []
    if metadata is not None:
        parts.append((f"--{boundary}\r\nContent-Disposition: form-data; name=\"metadata\"\r\n\r\n"
                      f"{json.dumps(metadata)}\r\n").encode())
    parts.append((f"--{boundary}\r\n"
                  f'Content-Disposition: form-data; name="file"; filename="{filename}"\r\n'
                  f"Content-Type: {ctype}\r\n\r\n").encode() + content + b"\r\n")
    body = b"".join(parts) + f"--{boundary}--\r\n".encode()
    return body, {"Content-Type": f"multipart/form-data; boundary={boundary}"}


def sse_cards(body: bytes) -> list[dict]:
    return [json.loads(line[5:]) for line in body.decode().split("\n") if line.startswith("data:")]


class Served:
    """``app`` served on 127.0.0.1 on a free port, on the running loop."""

    def __init__(self, app):
        from tornado.httpserver import HTTPServer
        from tornado.testing import bind_unused_port

        sock, self.port = bind_unused_port()
        self.server = HTTPServer(app)
        self.server.add_sockets([sock])
        self.base = f"http://127.0.0.1:{self.port}"

    async def fetch(self, path: str, method: str = "GET", body=None, headers=None):
        from tornado.httpclient import AsyncHTTPClient

        if isinstance(body, (dict, list)):
            body = json.dumps(body)
        if body is None and method in ("POST", "PUT"):
            body = b""
        return await AsyncHTTPClient().fetch(
            self.base + path, method=method, body=body, headers=headers,
            raise_error=False, request_timeout=60.0,
            allow_nonstandard_methods=method == "DELETE" and body is not None)

    async def ws_cards(self, message: dict, until: tuple = ("done",)) -> list[dict]:
        """Send one message on /ws/chat and read cards up to the first of
        type ``until`` (a request refused before the run gets one error
        card and no ``done``)."""
        from tornado.websocket import websocket_connect

        conn = await websocket_connect(f"ws://127.0.0.1:{self.port}/ws/chat")
        await conn.write_message(json.dumps(message))
        cards = []
        while True:
            msg = await conn.read_message()
            assert msg is not None, f"the socket closed before a card of type {until}"
            cards.append(json.loads(msg))
            if cards[-1]["type"] in until:
                break
        conn.close()
        return cards

    async def close(self) -> None:
        self.server.stop()
        await self.server.close_all_connections()


@pytest.fixture
def port_registry():
    """The port's process-wide KB registry, cleared after the test of every
    name the test registered there."""
    from youtu_rag_tpu_torch.retrieval.kb import GLOBAL_KB_REGISTRY

    before = set(GLOBAL_KB_REGISTRY.names())
    yield GLOBAL_KB_REGISTRY
    for name in set(GLOBAL_KB_REGISTRY.names()) - before:
        GLOBAL_KB_REGISTRY.remove(name)
