"""Minimal MCP (Model Context Protocol) stdio client + toolkit bridge.

Parity with the reference's MCP integration (``utu/tools/utils.py``
get_mcp_server / get_mcp_tools over the ``mcp`` SDK; toolkit mode "mcp" in
``ToolkitConfig``). The SDK is not in this image, so this is a
self-contained JSON-RPC 2.0 stdio client implementing the slice the
toolkits need: ``initialize`` handshake, ``tools/list``, ``tools/call``.

``MCPToolkit`` exposes a server's tools through the standard
AsyncBaseToolkit surface: schemas come from the server's inputSchema, and
``call_tool`` proxies over the wire — so agents use MCP tools exactly like
builtin ones (activated_tools filtering included).

The port's copy of ``youtu_rag_tpu/tools/mcp_client.py``.
"""

from __future__ import annotations

import asyncio
import json
from typing import Any

from ..utils.log import get_logger
from . import register_toolkit
from .base import AsyncBaseToolkit, ToolkitConfig

logger = get_logger("tools.mcp")


def _content_to_text(result: dict) -> str:
    """tools/call result → text (shared by all three transports)."""
    parts = []
    for item in result.get("content", []):
        if item.get("type") == "text":
            parts.append(item.get("text", ""))
        else:
            parts.append(json.dumps(item, ensure_ascii=False))
    if result.get("isError"):
        return "Error: " + ("\n".join(parts) or "tool failed")
    return "\n".join(parts)


_PROTOCOL_VERSION = "2024-11-05"


class MCPStdioClient:
    """JSON-RPC 2.0 over a child process's stdio."""

    def __init__(self, command: str, args: list[str] | None = None, env: dict | None = None, timeout: float = 20.0):
        self.command = command
        self.args = args or []
        self.env = env
        self.timeout = timeout
        self._proc: asyncio.subprocess.Process | None = None
        self._id = 0
        self._lock = asyncio.Lock()

    async def connect(self) -> None:
        import os

        env = dict(os.environ)
        if self.env:
            env.update(self.env)
        self._proc = await asyncio.create_subprocess_exec(
            self.command,
            *self.args,
            stdin=asyncio.subprocess.PIPE,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.DEVNULL,
            env=env,
        )
        result = await self._request(
            "initialize",
            {
                "protocolVersion": _PROTOCOL_VERSION,
                "capabilities": {},
                "clientInfo": {"name": "youtu-rag-tpu", "version": "0.1.0"},
            },
        )
        await self._notify("notifications/initialized", {})
        logger.info("MCP connected: %s", result.get("serverInfo", {}))

    async def close(self) -> None:
        if self._proc is not None:
            self._proc.kill()
            await self._proc.wait()
            self._proc = None

    async def _send(self, payload: dict) -> None:
        assert self._proc and self._proc.stdin
        self._proc.stdin.write((json.dumps(payload) + "\n").encode())
        await self._proc.stdin.drain()

    async def _notify(self, method: str, params: dict) -> None:
        await self._send({"jsonrpc": "2.0", "method": method, "params": params})

    async def _request(self, method: str, params: dict) -> dict:
        async with self._lock:
            self._id += 1
            rid = self._id
            await self._send({"jsonrpc": "2.0", "id": rid, "method": method, "params": params})
            assert self._proc and self._proc.stdout
            while True:
                line = await asyncio.wait_for(self._proc.stdout.readline(), timeout=self.timeout)
                if not line:
                    raise RuntimeError("MCP server closed the pipe")
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if msg.get("id") != rid:
                    continue  # notification or unrelated response
                if "error" in msg:
                    raise RuntimeError(f"MCP error: {msg['error']}")
                return msg.get("result", {})

    async def list_tools(self) -> list[dict]:
        result = await self._request("tools/list", {})
        return result.get("tools", [])

    async def call_tool(self, name: str, arguments: dict) -> str:
        result = await self._request("tools/call", {"name": name, "arguments": arguments})
        return _content_to_text(result)


class MCPHttpClient:
    """Streamable-HTTP MCP transport: JSON-RPC POSTs to one endpoint;
    responses arrive as JSON or a one-shot SSE stream (the 2024-11-05
    streamable-http profile the reference configures via
    mcp_transport='streamable_http')."""

    def __init__(self, url: str, headers: dict | None = None, timeout: float = 30.0):
        self.url = url
        self.headers = headers or {}
        self.timeout = timeout
        self._id = 0
        self._session_id: str | None = None

    async def connect(self) -> None:
        result = await self._request(
            "initialize",
            {
                "protocolVersion": _PROTOCOL_VERSION,
                "capabilities": {},
                "clientInfo": {"name": "youtu-rag-tpu", "version": "0.1.0"},
            },
        )
        await self._notify("notifications/initialized", {})
        logger.info("MCP (http) connected: %s", result.get("serverInfo", {}))

    async def close(self) -> None:
        ...

    def _hdrs(self) -> dict:
        h = {
            "Content-Type": "application/json",
            "Accept": "application/json, text/event-stream",
            **self.headers,
        }
        if self._session_id:
            h["Mcp-Session-Id"] = self._session_id
        return h

    async def _notify(self, method: str, params: dict) -> None:
        import httpx

        async with httpx.AsyncClient(timeout=self.timeout) as client:
            await client.post(
                self.url, json={"jsonrpc": "2.0", "method": method, "params": params}, headers=self._hdrs()
            )

    async def _request(self, method: str, params: dict) -> dict:
        import httpx

        self._id += 1
        payload = {"jsonrpc": "2.0", "id": self._id, "method": method, "params": params}
        async with httpx.AsyncClient(timeout=self.timeout) as client:
            r = await client.post(self.url, json=payload, headers=self._hdrs())
            r.raise_for_status()
            sid = r.headers.get("Mcp-Session-Id")
            if sid:
                self._session_id = sid
            ctype = r.headers.get("Content-Type", "")
            if ctype.startswith("text/event-stream"):
                msg = None
                for line in r.text.split("\n"):
                    if line.startswith("data:"):
                        try:
                            obj = json.loads(line[5:].strip())
                        except json.JSONDecodeError:
                            continue
                        if obj.get("id") == self._id:
                            msg = obj
                if msg is None:
                    raise RuntimeError("no matching response in MCP SSE stream")
            else:
                msg = r.json()
        if "error" in msg:
            raise RuntimeError(f"MCP error: {msg['error']}")
        return msg.get("result", {})

    async def list_tools(self) -> list[dict]:
        return (await self._request("tools/list", {})).get("tools", [])

    async def call_tool(self, name: str, arguments: dict) -> str:
        result = await self._request("tools/call", {"name": name, "arguments": arguments})
        return _content_to_text(result)


class MCPSseClient:
    """Legacy HTTP+SSE MCP transport (the pre-streamable 2024 profile the
    reference selects with mcp_transport='sse'): GET the SSE endpoint for a
    long-lived stream; the first ``endpoint`` event names the POST URL;
    requests POST there (202) and responses arrive as ``message`` events
    on the stream."""

    def __init__(
        self,
        url: str,
        headers: dict | None = None,
        timeout: float = 30.0,
        max_reconnects: int = 3,
        reconnect_backoff: float = 0.3,
    ):
        self.url = url
        self.headers = headers or {}
        self.timeout = timeout
        self.max_reconnects = max_reconnects
        self.reconnect_backoff = reconnect_backoff
        self._id = 0
        self._endpoint: str | None = None
        self._endpoint_ready: asyncio.Future | None = None
        self._pending: dict[int, asyncio.Future] = {}
        self._reader_task: asyncio.Task | None = None
        self._client = None  # long-lived httpx client pinned to the stream
        self._closed = False
        self._connected = False
        self._reconnects = 0
        self.reconnect_count = 0  # total successful reconnects (observability)

    async def connect(self) -> None:
        self._closed = False
        await self._open_stream()
        await self._handshake()

    async def _open_stream(self) -> None:
        import httpx

        if self._client is None:
            self._client = httpx.AsyncClient(timeout=httpx.Timeout(self.timeout, read=None))
        # cancel any still-running previous reader BEFORE resetting the
        # endpoint: a stale stream's late `endpoint` event would point
        # subsequent POSTs at a dead session
        prev = getattr(self, "_reader_task", None)
        if prev is not None and not prev.done():
            prev.cancel()
        self._endpoint = None
        loop = asyncio.get_running_loop()
        self._endpoint_ready = loop.create_future()
        self._reader_task = loop.create_task(self._read_stream())
        await asyncio.wait_for(self._endpoint_ready, self.timeout)
        self._connected = True

    async def _handshake(self) -> None:
        result = await self._request(
            "initialize",
            {
                "protocolVersion": _PROTOCOL_VERSION,
                "capabilities": {},
                "clientInfo": {"name": "youtu-rag-tpu", "version": "0.1.0"},
            },
        )
        await self._notify("notifications/initialized", {})
        logger.info("MCP (sse) connected: %s", result.get("serverInfo", {}))

    async def _reconnect(self) -> None:
        """Re-open the stream + re-handshake after a dropped connection
        (sessions don't survive the stream, so in-flight requests failed
        already; new requests ride the fresh session)."""
        while not self._closed and self._reconnects < self.max_reconnects:
            self._reconnects += 1
            delay = self.reconnect_backoff * 2 ** (self._reconnects - 1)
            logger.warning(
                "MCP SSE stream lost; reconnect %d/%d in %.1fs",
                self._reconnects, self.max_reconnects, delay,
            )
            await asyncio.sleep(delay)
            if self._closed:
                return
            try:
                await self._open_stream()
                await self._handshake()
                self._reconnects = 0
                self.reconnect_count += 1
                logger.info("MCP SSE reconnected")
                return
            except Exception as e:  # noqa: BLE001 - retry until budget spent
                logger.warning("MCP SSE reconnect failed: %s", e)
                self._connected = False
        if not self._closed:
            logger.error("MCP SSE gave up after %d reconnect attempts", self.max_reconnects)

    async def _await_connected(self) -> None:
        """Block a request briefly while a reconnect is in flight."""
        if self._connected:
            return
        deadline = asyncio.get_running_loop().time() + self.timeout
        while not self._connected:
            if self._closed:
                raise RuntimeError("MCP SSE client is closed")
            if self._reconnects >= self.max_reconnects:
                raise RuntimeError("MCP SSE disconnected (reconnect budget spent)")
            if asyncio.get_running_loop().time() > deadline:
                raise RuntimeError("MCP SSE disconnected (reconnect timed out)")
            await asyncio.sleep(0.05)

    async def close(self) -> None:
        self._closed = True
        self._connected = False
        if self._reader_task is not None:
            self._reader_task.cancel()
            try:
                await self._reader_task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            self._reader_task = None
        if self._client is not None:
            await self._client.aclose()
            self._client = None

    async def _read_stream(self) -> None:
        """Parse the SSE stream; route `endpoint` and JSON-RPC `message`s."""
        from urllib.parse import urljoin

        try:
            async with self._client.stream(
                "GET", self.url, headers={"Accept": "text/event-stream", **self.headers}
            ) as r:
                r.raise_for_status()
                event, data_lines = "message", []
                async for line in r.aiter_lines():
                    if line.startswith("event:"):
                        event = line[6:].strip()
                    elif line.startswith("data:"):
                        data_lines.append(line[5:].lstrip())
                    elif line == "":  # blank line = event boundary
                        if data_lines:
                            self._dispatch(event, "\n".join(data_lines), urljoin)
                        event, data_lines = "message", []
                    # comments (":" prefix) and other fields ignored
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 - fail all waiters
            self._stream_lost(f"MCP SSE stream failed: {e}")
            return
        # server closed the stream cleanly (restart/keep-alive cutoff)
        self._stream_lost("MCP SSE stream closed by server")

    def _stream_lost(self, reason: str) -> None:
        was_connected = self._connected
        self._connected = False
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(RuntimeError(reason))
        self._pending.clear()
        if self._endpoint_ready and not self._endpoint_ready.done():
            self._endpoint_ready.set_exception(RuntimeError(reason))
            return  # initial connect failing is the caller's error, not a reconnect
        if was_connected and not self._closed:
            asyncio.get_running_loop().create_task(self._reconnect())

    def _dispatch(self, event: str, data: str, urljoin) -> None:
        if not data:
            return
        if self._endpoint is None and (event == "endpoint" or not data.startswith("{")):
            self._endpoint = urljoin(self.url, data)
            if self._endpoint_ready and not self._endpoint_ready.done():
                self._endpoint_ready.set_result(None)
            return
        try:
            msg = json.loads(data)
        except json.JSONDecodeError:
            return
        fut = self._pending.pop(msg.get("id"), None)
        if fut is not None and not fut.done():
            fut.set_result(msg)

    async def _notify(self, method: str, params: dict) -> None:
        await self._client.post(
            self._endpoint,
            json={"jsonrpc": "2.0", "method": method, "params": params},
            headers={"Content-Type": "application/json", **self.headers},
        )

    async def _request(self, method: str, params: dict) -> dict:
        self._id += 1
        rid = self._id
        fut = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        r = await self._client.post(
            self._endpoint,
            json={"jsonrpc": "2.0", "id": rid, "method": method, "params": params},
            headers={"Content-Type": "application/json", **self.headers},
        )
        if r.status_code >= 400:
            self._pending.pop(rid, None)
            raise RuntimeError(f"MCP SSE POST failed: HTTP {r.status_code}")
        msg = await asyncio.wait_for(fut, self.timeout)
        if "error" in msg:
            raise RuntimeError(f"MCP error: {msg['error']}")
        return msg.get("result", {})

    async def list_tools(self) -> list[dict]:
        await self._await_connected()
        return (await self._request("tools/list", {})).get("tools", [])

    async def call_tool(self, name: str, arguments: dict) -> str:
        await self._await_connected()
        result = await self._request("tools/call", {"name": name, "arguments": arguments})
        return _content_to_text(result)


@register_toolkit("mcp")
class MCPToolkit(AsyncBaseToolkit):
    """Bridge an MCP server's tools into the toolkit surface.

    config (ToolkitConfig.config):
      stdio transport:           command, args, env, timeout
      streamable_http transport: url, headers, timeout
      sse transport (legacy):    url, headers, timeout + transport='sse'
                                 (also inferred from a /sse url path)"""

    def __init__(self, config: ToolkitConfig | dict | None = None):
        super().__init__(config)
        cfg = self.config.config
        if cfg.get("url"):
            transport = cfg.get("transport") or (
                "sse" if cfg["url"].rstrip("/").endswith("/sse") else "streamable_http"
            )
            client_cls = MCPSseClient if transport == "sse" else MCPHttpClient
            self.client = client_cls(
                url=cfg["url"], headers=cfg.get("headers"), timeout=float(cfg.get("timeout", 30.0))
            )
        else:
            self.client = MCPStdioClient(
                command=cfg.get("command", ""),
                args=cfg.get("args", []),
                env=cfg.get("env"),
                timeout=float(cfg.get("timeout", 20.0)),
            )
        self._remote_tools: list[dict] = []

    async def build(self) -> None:
        if self._built:
            return
        if isinstance(self.client, MCPStdioClient) and not self.client.command:
            raise ValueError("MCP toolkit needs config.command (stdio) or config.url (http)")
        await self.client.connect()
        self._remote_tools = await self.client.list_tools()
        if self.config.activated_tools:
            names = set(self.config.activated_tools)
            self._remote_tools = [t for t in self._remote_tools if t["name"] in names]
        await super().build()

    async def cleanup(self) -> None:
        await self.client.close()
        await super().cleanup()

    def get_tools_map_func(self):
        # remote tools have no local callables; call_tool routes directly
        return {t["name"]: None for t in self._remote_tools}

    def get_tools_in_openai(self) -> list[dict]:
        return [
            {
                "type": "function",
                "function": {
                    "name": t["name"],
                    "description": t.get("description", ""),
                    "parameters": t.get("inputSchema", {"type": "object", "properties": {}}),
                },
            }
            for t in self._remote_tools
        ]

    async def call_tool(self, name: str, arguments: dict) -> str:
        if not self._built:
            await self.build()
        if name not in {t["name"] for t in self._remote_tools}:
            raise ValueError(f"Tool {name} not found on MCP server")
        return await self.client.call_tool(name, arguments)
