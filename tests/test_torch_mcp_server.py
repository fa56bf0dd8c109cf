"""The port's MCP tool server (``youtu_rag_tpu_torch.start_tools_mcp``)
against the JAX package's (``scripts/start_tools_mcp.py``): the same
JSON-RPC messages get the same responses in process, the port's
``MCPToolkit`` gets the same answers from both servers over stdio and from
the port's over SSE, and without CUDA a server that would build a KB on the
card refuses to start instead of answering from the CPU."""

import asyncio
import importlib.util
import json
import os
import re
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from youtu_rag_tpu_torch import start_tools_mcp as port_mcp
from youtu_rag_tpu_torch.tools import TOOLKIT_MAP, builtin  # noqa: F401 (fills TOOLKIT_MAP)
from youtu_rag_tpu_torch.tools.base import ToolkitConfig
from youtu_rag_tpu_torch.tools.mcp_client import MCPToolkit

from torch_native_helpers import jax_lib, jax_tracer_restored  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
JAX_SCRIPT = REPO / "scripts" / "start_tools_mcp.py"
PORT_ENV = {"PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu"}
HOST_TOOLKITS = ["tabular", "codesnip", "file"]
N_DOCS = 48


@pytest.fixture(scope="module")
def jax_mcp(jax_tracer_restored, jax_lib):  # noqa: F811
    spec = importlib.util.spec_from_file_location("jax_start_tools_mcp", JAX_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fact_docs(seed: int = 0, n: int = N_DOCS) -> tuple[list[str], list[str]]:
    """``n`` short fact documents and one question per document."""
    rng = np.random.default_rng(seed)
    syll = ["ka", "lo", "mi", "ne", "ru", "ta", "vo", "zi", "pe", "su", "do", "ga"]
    words = sorted({"".join(rng.choice(syll, size=3)) for _ in range(8 * n)})
    rng.shuffle(words)
    docs, questions = [], []
    for i in range(n):
        ent, attr = words[2 * i].capitalize(), words[2 * i + 1]
        docs.append(f"# {ent}\n\nThe {attr} of {ent} is {int(rng.integers(10_000, 100_000))}.")
        questions.append(f"What is the {attr} of {ent}?")
    return docs, questions


def rpc(rid, method, params=None) -> dict:
    msg = {"jsonrpc": "2.0", "method": method}
    if rid is not None:
        msg["id"] = rid
    if params is not None:
        msg["params"] = params
    return msg


def call(rid, name, arguments) -> dict:
    return rpc(rid, "tools/call", {"name": name, "arguments": arguments})


async def answer_all(handle, router, msgs: list[dict]) -> list:
    await router.build()
    schemas = router.schemas()
    return [await handle(m, router, schemas) for m in msgs]


_SECTION = re.compile(r"## Context \d+ \(Relevance: (-?[\d.]+)\)\n\n(.*)", re.S)


def same_context(got: str, want: str) -> bool:
    """``rag_retrieve``'s markdown: equal, or the same sections up to the
    hash embedder's 1-2 ulp (a shown relevance within 0.01, chunks within
    0.01 of each other may trade places, the last rank may differ)."""
    if got == want:
        return True
    g = [_SECTION.match(s).groups() for s in got.split("\n\n---\n\n")]
    w = [_SECTION.match(s).groups() for s in want.split("\n\n---\n\n")]
    if len(g) != len(w):
        return False
    rel = {body: float(r) for r, body in w}
    for i, ((rg, bg), (rw, bw)) in enumerate(zip(g, w)):
        if abs(float(rg) - float(rw)) > 0.01:
            return False
        if bg != bw and i < len(g) - 1 and abs(rel.get(bg, np.inf) - float(rw)) > 0.01:
            return False
    return True


def rag_messages(docs, questions) -> list[dict]:
    msgs = [rpc(1, "initialize", {"protocolVersion": "2024-11-05"}),
            rpc(None, "notifications/initialized", {}),
            rpc(2, "tools/list"),
            call(3, "rag_build", {"texts": docs, "source": "facts"}),
            call(4, "rag_stats", {})]
    msgs += [call(10 + i, "rag_retrieve", {"query": q, "top_k": 5})
             for i, q in enumerate(questions)]
    msgs += [call(100, "rag_retrieve", {"query": questions[0]}),
             call(101, "rag_build", {"bogus": 1}),
             call(102, "no_such_tool", {}),
             rpc(103, "resources/list"),
             rpc(104, None),
             call(105, "rag_clear", {}),
             call(106, "rag_retrieve", {"query": questions[1]})]
    return msgs


def same_stats(got: dict, want: dict) -> bool:
    """rag_stats: the port's KB names its backend "torch" and adds its device."""
    g, w = json.loads(got["result"]["content"][0]["text"]), json.loads(
        want["result"]["content"][0]["text"])
    return g.pop("device") == "cpu" and g.pop("backend") == "torch" and w.pop("backend") == "tpu" \
        and g == w


def test_rag_messages_match_jax(jax_mcp):
    """rag on the CPU: every response equal to JAX's, rag_retrieve's text up
    to the hash embedder's ulps, rag_stats up to the port's backend name."""
    from youtu_rag_tpu.tools import get_toolkit as jax_get_toolkit
    from youtu_rag_tpu.tools.base import ToolRouter as JaxRouter

    docs, questions = fact_docs()
    msgs = rag_messages(docs, questions)
    want = asyncio.run(answer_all(jax_mcp.handle_message, JaxRouter([jax_get_toolkit("rag")]),
                                  msgs))
    got = asyncio.run(answer_all(port_mcp.handle_message, port_mcp.make_router(["rag"], "cpu"),
                                 msgs))
    assert len(got) == len(want) == len(msgs)
    hits = 0
    for msg, g, w in zip(msgs, got, want):
        if msg.get("id") is None:
            assert g is None and w is None
            continue
        name = msg.get("params", {}).get("name")
        if name == "rag_stats":
            assert same_stats(g, w), (g, w)
        elif name == "rag_retrieve" and not g["result"]["content"][0]["text"].startswith("No "):
            assert g["result"]["isError"] is w["result"]["isError"] is False
            text = g["result"]["content"][0]["text"]
            assert same_context(text, w["result"]["content"][0]["text"]), (text, w)
            if 10 <= msg["id"] < 10 + N_DOCS:
                hits += docs[msg["id"] - 10].splitlines()[-1] in text
        else:
            assert g == w, msg
    by_id = {m.get("id"): g for m, g in zip(msgs, got)}
    built = by_id[3]["result"]["content"][0]["text"]
    assert built == f"indexed {N_DOCS} chunks from {N_DOCS} documents"
    assert [t["name"] for t in by_id[2]["result"]["tools"]] == [
        "rag_build", "rag_clear", "rag_retrieve", "rag_stats"]
    assert by_id[101]["result"]["isError"] is True
    assert by_id[102]["result"]["isError"] is True
    assert by_id[103]["error"]["code"] == -32601 and by_id[104]["error"]["code"] == -32601
    assert by_id[106]["result"]["content"][0]["text"] == "No results."
    assert hits == N_DOCS  # every question's fact in its top 5


def test_host_toolkit_messages_match_jax(jax_mcp, tmp_path):
    """tabular, codesnip and file (JAX's default toolkits): the same
    initialize, tools/list and tool results; the port's ``--device`` key
    changes nothing for them."""
    from youtu_rag_tpu.tools import get_toolkit as jax_get_toolkit
    from youtu_rag_tpu.tools.base import ToolRouter as JaxRouter

    csv = tmp_path / "t.csv"
    csv.write_text("a,b\n1,x\n2,y\n3,x\n")
    msgs = [rpc(1, "initialize", {}), rpc(None, "notifications/initialized"), rpc(2, "tools/list"),
            call(3, "run_snippet", {"code": "print(7*6)"}),
            call(4, "run_snippet", {"code": "import sys; sys.exit(3)"}),
            call(5, "write_file", {"path": "d/n.txt", "content": "héllo"}),
            call(6, "read_file", {"path": "d/n.txt"}),
            call(7, "list_files", {"path": "d"}),
            call(8, "read_file", {"path": "../escape"}),
            call(9, "tabular_column_stats", {"path": str(csv), "column": "a"}),
            call(10, "tabular_column_stats", {"path": str(csv), "column": "zz"}),
            call(11, "tabular_overview", {"path": str(tmp_path / "missing.csv")}),
            rpc(12, "shutdown")]
    want = asyncio.run(answer_all(jax_mcp.handle_message,
                                  JaxRouter([jax_get_toolkit(n) for n in HOST_TOOLKITS]), msgs))
    for device in (None, "cpu"):
        got = asyncio.run(answer_all(port_mcp.handle_message,
                                     port_mcp.make_router(HOST_TOOLKITS, device), msgs))
        assert got == want
    assert got[3]["result"]["content"][0]["text"] == "42"
    assert got[8]["result"]["isError"] is True
    assert got[12]["error"] == {"code": -32601, "message": "unknown method shutdown"}


# every toolkit but "mcp", the client of another server, which needs its command
@pytest.mark.parametrize("name", sorted(set(TOOLKIT_MAP) - {"mcp"}))
def test_tools_list_matches_jax_for_every_toolkit(name, jax_mcp):
    """Each registered toolkit takes the server's ``device`` key and lists
    the tools JAX's server lists for it."""
    from youtu_rag_tpu.tools import get_toolkit as jax_get_toolkit
    from youtu_rag_tpu.tools.base import ToolRouter as JaxRouter

    msgs = [rpc(1, "tools/list")]
    want = asyncio.run(answer_all(jax_mcp.handle_message, JaxRouter([jax_get_toolkit(name)]), msgs))
    got = asyncio.run(answer_all(port_mcp.handle_message, port_mcp.make_router([name], "cpu"),
                                 msgs))
    assert got == want


def stdio_toolkit(args: list[str], env: dict | None = None) -> MCPToolkit:
    return MCPToolkit(ToolkitConfig(mode="mcp", config={
        "command": sys.executable, "args": args, "env": env, "timeout": 120.0}))


async def drive_client(tk: MCPToolkit, docs, questions) -> dict:
    await tk.build()
    try:
        out = {"names": sorted(s["function"]["name"] for s in tk.get_tools_in_openai()),
               "snippet": await tk.call_tool("run_snippet", {"code": "print(7*6)"}),
               "build": await tk.call_tool("rag_build", {"texts": docs}),
               "answers": [await tk.call_tool("rag_retrieve", {"query": q}) for q in questions]}
        with pytest.raises(RuntimeError, match="-32601"):
            await tk.client._request("no/such", {})
        return out
    finally:
        await tk.cleanup()


def check_answers(got: dict, want: dict, docs) -> None:
    assert got["names"] == want["names"] and "run_snippet" in got["names"]
    assert got["snippet"] == want["snippet"] == "42"
    assert got["build"] == want["build"]
    for doc, g, w in zip(docs, got["answers"], want["answers"]):
        assert same_context(g, w), (g, w)
        assert doc.splitlines()[-1] in g


def test_stdio_client_same_answers_from_both_servers(jax_mcp):
    """The port's MCPToolkit over stdio against the port's server
    (``--device cpu``) and JAX's script, both serving rag and codesnip."""
    docs, questions = fact_docs(seed=1, n=16)
    port = stdio_toolkit(["-m", "youtu_rag_tpu_torch.start_tools_mcp", "--toolkits", "rag",
                          "codesnip", "--device", "cpu"], PORT_ENV)
    jax = stdio_toolkit([str(JAX_SCRIPT), "--toolkits", "rag", "codesnip"],
                        {"JAX_PLATFORMS": "cpu"})

    async def both():
        return await asyncio.gather(drive_client(port, docs, questions),
                                    drive_client(jax, docs, questions))

    got, want = asyncio.run(both())
    check_answers(got, want, docs)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_sse_transport(jax_mcp):
    """``--transport sse``: MCPSseClient gets the in-process server's
    answers; POST /messages answers 404 for an unknown session and 400 for
    a body that is not JSON."""
    pytest.importorskip("tornado")
    httpx = pytest.importorskip("httpx")
    docs, questions = fact_docs(seed=2, n=12)
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "youtu_rag_tpu_torch.start_tools_mcp", "--transport", "sse",
         "--port", str(port), "--toolkits", "rag", "codesnip", "--device", "cpu"],
        cwd=REPO, env={**os.environ, **PORT_ENV}, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith(f"MCP SSE server on :{port} (5 tools)"), line
        tk = MCPToolkit(ToolkitConfig(mode="mcp", config={
            "url": f"http://127.0.0.1:{port}/sse", "timeout": 60.0}))

        async def drive():
            await tk.build()
            try:
                async with httpx.AsyncClient(timeout=30.0) as c:
                    unknown = await c.post(f"http://127.0.0.1:{port}/messages?session=nope",
                                           content=b"{}")
                    bad = await c.post(tk.client._endpoint, content=b"{not json")
                out = {"names": sorted(s["function"]["name"] for s in tk.get_tools_in_openai()),
                       "snippet": await tk.call_tool("run_snippet", {"code": "print(7*6)"}),
                       "build": await tk.call_tool("rag_build", {"texts": docs}),
                       "answers": [await tk.call_tool("rag_retrieve", {"query": q})
                                   for q in questions]}
                return out, unknown, bad
            finally:
                await tk.cleanup()

        got, unknown, bad = asyncio.run(drive())
    finally:
        proc.kill()
        proc.wait()
    assert unknown.status_code == 404 and "unknown session" in unknown.json()["error"]
    assert bad.status_code == 400 and bad.json() == {"error": "invalid JSON"}
    msgs = [call(1, "run_snippet", {"code": "print(7*6)"}), call(2, "rag_build", {"texts": docs})]
    msgs += [call(3 + i, "rag_retrieve", {"query": q}) for i, q in enumerate(questions)]
    ref = asyncio.run(answer_all(port_mcp.handle_message,
                                 port_mcp.make_router(["rag", "codesnip"], "cpu"), msgs))
    texts = [r["result"]["content"][0]["text"] for r in ref]
    want = {"names": got["names"], "snippet": texts[0], "build": texts[1], "answers": texts[2:]}
    check_answers(got, want, docs)
    assert got["answers"] == texts[2:]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_no_cpu_fallback_in_process(no_cuda):
    """Without CUDA and without a device the rag toolkit's KB cannot be
    made, so neither the router nor the command starts; the host-only
    toolkits need no device and serve."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mcp.make_router(["codesnip", "rag"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        asyncio.run(port_mcp.main(["--toolkits", "rag"]))
    got = asyncio.run(answer_all(port_mcp.handle_message, port_mcp.make_router(["codesnip"]),
                                 [call(1, "run_snippet", {"code": "print(6*7)"})]))
    assert got[0]["result"]["content"][0]["text"] == "42"


def test_no_cpu_fallback_over_stdio():
    """A server started without ``--device`` on a host that shows no CUDA
    exits before it answers: the client's build fails, nothing is served
    from the CPU."""
    tk = stdio_toolkit(["-m", "youtu_rag_tpu_torch.start_tools_mcp", "--toolkits", "rag",
                        "codesnip"], {**PORT_ENV, "CUDA_VISIBLE_DEVICES": ""})
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="closed the pipe"):
        asyncio.run(tk.build())
    asyncio.run(tk.cleanup())
    assert time.perf_counter() - t0 < 120
    out = subprocess.run([sys.executable, "-m", "youtu_rag_tpu_torch.start_tools_mcp",
                          "--toolkits", "rag"], cwd=REPO, capture_output=True, text=True,
                         timeout=120, input="",
                         env={**os.environ, **PORT_ENV, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and not out.stdout and "no CUDA device" in out.stderr
