"""Serve the port's toolkits as an MCP server, over stdio or HTTP+SSE: the
port's copy of ``scripts/start_tools_mcp.py``.

    python -m youtu_rag_tpu_torch.start_tools_mcp --toolkits rag codesnip
    python -m youtu_rag_tpu_torch.start_tools_mcp --toolkits rag --device cpu
    python -m youtu_rag_tpu_torch.start_tools_mcp --transport sse --port 8765

It speaks JSON-RPC 2.0: initialize, tools/list, tools/call, the protocol
slice that ``tools.mcp_client`` consumes. The SSE transport serves GET /sse
(an ``endpoint`` event, then the message stream) and POST /messages, as
``MCPSseClient``'s legacy profile expects; it needs tornado, imported only
there.

Each toolkit gets ``--device`` as its config's ``device`` key: the
toolkits that make a KB or a memory store (``rag``, ``memory``) keep it
there, the host-only ones ignore it. Without ``--device`` that is the CUDA
card, and on a host without one such a toolkit raises when the server
builds it; ``--device cpu`` runs the plain PyTorch path."""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import uuid

from .tools import get_toolkit
from .tools.base import ToolRouter
from .version import __version__


def make_router(toolkits: list[str], device: str | None = None) -> ToolRouter:
    """The toolkits by registry name, each with ``device`` in its config."""
    return ToolRouter([get_toolkit(name, {"device": device}) for name in toolkits])


async def handle_message(msg: dict, router, schemas) -> dict | None:
    """One JSON-RPC message → response dict (None for notifications)."""
    method, rid = msg.get("method"), msg.get("id")
    if rid is None:
        return None
    if method == "initialize":
        return {
            "jsonrpc": "2.0",
            "id": rid,
            "result": {
                "protocolVersion": "2024-11-05",
                "serverInfo": {"name": "youtu-rag-tpu-tools", "version": __version__},
                "capabilities": {"tools": {}},
            },
        }
    if method == "tools/list":
        return {
            "jsonrpc": "2.0",
            "id": rid,
            "result": {
                "tools": [
                    {
                        "name": s["function"]["name"],
                        "description": s["function"]["description"],
                        "inputSchema": s["function"]["parameters"],
                    }
                    for s in schemas
                ]
            },
        }
    if method == "tools/call":
        params = msg.get("params", {})
        out = await router.call(params.get("name", ""), params.get("arguments", {}))
        return {
            "jsonrpc": "2.0",
            "id": rid,
            "result": {
                "isError": out.startswith("Error"),
                "content": [{"type": "text", "text": out}],
            },
        }
    return {"jsonrpc": "2.0", "id": rid,
            "error": {"code": -32601, "message": f"unknown method {method}"}}


async def serve_stdio(router, schemas) -> None:
    """One message a line on stdin, one response a line on stdout; a line
    that is not JSON is skipped."""
    loop = asyncio.get_running_loop()
    while True:
        line = await loop.run_in_executor(None, sys.stdin.readline)
        if not line:
            break
        try:
            msg = json.loads(line)
        except json.JSONDecodeError:
            continue
        resp = await handle_message(msg, router, schemas)
        if resp is not None:
            sys.stdout.write(json.dumps(resp) + "\n")
            sys.stdout.flush()


async def serve_sse(router, schemas, port: int) -> None:
    import tornado.locks
    import tornado.web

    streams: dict[str, "SseHandler"] = {}

    class SseHandler(tornado.web.RequestHandler):
        async def get(self):
            self.set_header("Content-Type", "text/event-stream")
            self.set_header("Cache-Control", "no-cache")
            sid = uuid.uuid4().hex[:12]
            streams[sid] = self
            self._closed = tornado.locks.Event()
            self.write(f"event: endpoint\ndata: /messages?session={sid}\n\n")
            await self.flush()
            try:
                await self._closed.wait()
            finally:
                streams.pop(sid, None)

        def on_connection_close(self):
            if hasattr(self, "_closed"):
                self._closed.set()

        async def push(self, msg: dict) -> None:
            self.write("event: message\ndata: " + json.dumps(msg) + "\n\n")
            await self.flush()

    class MessagesHandler(tornado.web.RequestHandler):
        async def post(self):
            sid = self.get_query_argument("session", "")
            stream = streams.get(sid)
            if stream is None:
                self.set_status(404)
                self.finish({"error": f"unknown session {sid!r}"})
                return
            try:
                msg = json.loads(self.request.body)
            except json.JSONDecodeError:
                self.set_status(400)
                self.finish({"error": "invalid JSON"})
                return
            self.set_status(202)
            self.finish()
            resp = await handle_message(msg, router, schemas)
            if resp is not None:
                await stream.push(resp)

    app = tornado.web.Application([(r"/sse", SseHandler), (r"/messages", MessagesHandler)])
    app.listen(port)
    print(f"MCP SSE server on :{port} ({len(schemas)} tools)", flush=True)
    await asyncio.Event().wait()


async def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--toolkits", nargs="+", default=["tabular", "codesnip", "file"])
    p.add_argument("--transport", choices=["stdio", "sse"], default="stdio")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--device", default=None,
                   help="where a toolkit's KB or memory store lives (default: the CUDA card)")
    args = p.parse_args(argv)

    router = make_router(args.toolkits, args.device)
    await router.build()
    schemas = router.schemas()

    if args.transport == "sse":
        await serve_sse(router, schemas, args.port)
    else:
        await serve_stdio(router, schemas)


if __name__ == "__main__":
    asyncio.run(main())
