"""The port's API entry points on the CPU: ``serve_api`` (its options, its
device and ``--shards``, and a served process answering over HTTP), the
replay server against the JAX package's on the same records, the SPA's
files and the app's route table against the JAX package's, and
``youtu_rag_tpu_torch.api`` on a host without tornado."""

from __future__ import annotations

import asyncio
import importlib.util
import json
import os
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest
import torch

from torch_api_helpers import Served, make_state, package, port_registry  # noqa: F401
from youtu_rag_tpu_torch import cli_chat, serve_api
from torch_native_helpers import jax_tracer_restored  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("jax_tracer_restored")

REPO = Path(__file__).resolve().parent.parent
JAX_STATIC = REPO / "youtu_rag_tpu" / "api" / "static"
PORT_STATIC = REPO / "youtu_rag_tpu_torch" / "api" / "static"


# ---------------------------------------------------------------------------
# serve_api
# ---------------------------------------------------------------------------


def test_serve_api_builds_the_state_it_is_asked_for(tmp_path, port_registry):
    args = serve_api.parse_args([
        "--device", "cpu", "--data-dir", str(tmp_path), "--search-coalesce-ms", "2",
        "--embedding-provider", "hash",
        "--llm-weights-dir", str(REPO / "benchmarks" / "models" / "yrt_tiny_chat")])
    state = serve_api.build_state(args)
    assert state.device == torch.device("cpu") and state.data_dir == tmp_path
    assert state.rag_config.vector_store.coalesce_window_ms == 2.0
    assert state.rag_config.knowledge_builder.embedding.provider == "hash"
    cfg = state.agent_config
    assert cfg.model.provider == "local" and cfg.model.weights_dir.endswith("yrt_tiny_chat")
    assert cfg.agent.instructions == cli_chat.DEFAULT_KB_INSTRUCTIONS
    assert "kb_search" in cfg.toolkits
    # the defaults: no overrides, the CUDA card
    args = serve_api.parse_args([])
    assert args.device is None and args.shards == 0 and args.port == 8080


def test_serve_api_shards_raise(tmp_path):
    args = serve_api.parse_args(["--shards", "2", "--device", "cpu", "--data-dir", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="Queue A 8"):
        serve_api.build_state(args)


def test_serve_api_without_cuda_raises(tmp_path):
    code = ("import torch, asyncio; torch.cuda.is_available = lambda: False; "
            "from youtu_rag_tpu_torch import serve_api; "
            f"asyncio.run(serve_api.main(['--data-dir', {str(tmp_path)!r}, '--port', '0']))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def free_port() -> int:
    from tornado.testing import bind_unused_port

    sock, port = bind_unused_port()
    sock.close()
    return port


def get_json(url: str, data: dict | None = None) -> dict:
    req = urllib.request.Request(url, data=None if data is None else json.dumps(data).encode(),
                                 method="GET" if data is None else "POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_serve_api_serves_on_the_cpu(tmp_path):
    """``python -m youtu_rag_tpu_torch.serve_api --device cpu`` answers the
    calls of the repo's API walkthrough on localhost."""
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "youtu_rag_tpu_torch.serve_api", "--device", "cpu",
         "--port", str(port), "--data-dir", str(tmp_path / "api")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        for _ in range(600):
            try:
                health = get_json(base + "/health")
                break
            except OSError:
                assert proc.poll() is None, proc.stdout.read()
                time.sleep(0.1)
        assert health["status"] == "healthy"
        assert get_json(base + "/api/knowledge-bases", {"name": "demo"})["device"] == "cpu"
        built = get_json(base + "/api/knowledge-bases/demo/build", {
            "documents": [{"id": "d1", "content": "some text to index about HBM bandwidth"}]})
        assert built["status"]["status"] == "completed"
        hits = get_json(base + "/api/knowledge-bases/demo/query", {"query": "HBM bandwidth"})
        assert hits["results"][0]["document_id"] == "d1"
    finally:
        proc.terminate()
        proc.wait(timeout=30)


# ---------------------------------------------------------------------------
# the replay server
# ---------------------------------------------------------------------------


def jax_replay_module():
    path = REPO / "scripts" / "replay_server.py"
    spec = importlib.util.spec_from_file_location("jax_replay_server", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


RECORDS = [
    dict(trace_id="t1", input="What is the color of Zoka?", output="teal",
         trajectory=[{"role": "user", "content": "What is the color of Zoka?"},
                     {"role": "tool", "name": "kb_embedding_search", "arguments": "{}",
                      "output": "[1] zoka.md"},
                     {"role": "assistant", "content": "teal"}]),
    dict(trace_id="t2", input="q", error="boom", trajectory=[]),
]


async def replays(mod, db_cls, record_cls, db_path: str) -> dict:
    from tornado.websocket import websocket_connect

    db = db_cls(f"sqlite:///{db_path}")
    for rec in RECORDS:
        db.add(record_cls(**rec))
    served = Served(mod.make_app(db, 0.0))
    try:
        r = await served.fetch("/api/replays")
        out = {"list": json.loads(r.body), "page": (await served.fetch("/")).body.decode()}
        for trace_id in ("t1", "t2", "ghost"):
            conn = await websocket_connect(f"ws://127.0.0.1:{served.port}/ws")
            await conn.write_message(json.dumps({"trace_id": trace_id, "query": "replay"}))
            cards = []
            while not cards or cards[-1]["type"] not in ("done", "error"):
                cards.append(json.loads(await conn.read_message()))
            conn.close()
            out[trace_id] = cards
        return out
    finally:
        await served.close()


def test_replay_server_matches_jax(tmp_path):
    from youtu_rag_tpu.db.models import TrajectoryRecord as JaxRecord
    from youtu_rag_tpu.db.service import DBService as JaxDB
    from youtu_rag_tpu_torch import replay_server
    from youtu_rag_tpu_torch.db.models import TrajectoryRecord
    from youtu_rag_tpu_torch.db.service import DBService

    got = asyncio.run(replays(replay_server, DBService, TrajectoryRecord, str(tmp_path / "p.db")))
    want = asyncio.run(replays(jax_replay_module(), JaxDB, JaxRecord, str(tmp_path / "j.db")))
    assert got == want
    assert [c["type"] for c in got["t1"]] == ["plan", "tool_call", "tool_output", "text_delta",
                                              "final", "done"]
    assert got["ghost"] == [{"type": "error", "content": "no recorded run 'ghost'"}]


# ---------------------------------------------------------------------------
# the SPA and the route table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("asset", sorted(p.relative_to(JAX_STATIC).as_posix()
                                         for p in JAX_STATIC.rglob("*") if p.is_file()))
def test_static_files_equal_jax(asset):
    assert (PORT_STATIC / asset).read_bytes() == (JAX_STATIC / asset).read_bytes()


def test_static_tree_has_no_other_files():
    def tree(root):
        return sorted(p.relative_to(root).as_posix() for p in root.rglob("*") if p.is_file())

    assert tree(PORT_STATIC) == tree(JAX_STATIC)


def routes(app) -> list[tuple[str, str]]:
    return [(rule.matcher.regex.pattern, rule.target.__name__)
            for rule in app.default_router.rules[0].target.rules]


def test_route_table_matches_jax(port_registry):
    jax, port = package("jax"), package("port")
    got = routes(port.app.create_app(make_state(port, "yrt-routes")))
    want = routes(jax.app.create_app(make_state(jax, "yrt-routes")))
    assert got == want and len(got) == 40


# ---------------------------------------------------------------------------
# a host without tornado
# ---------------------------------------------------------------------------


NO_TORNADO = """
import sys, tempfile
sys.modules["tornado"] = None  # importing tornado fails
import youtu_rag_tpu_torch.api as api
from youtu_rag_tpu_torch.api.state import ApiState, LocalFileStore
from youtu_rag_tpu_torch import serve_api
with tempfile.TemporaryDirectory() as d:
    state = ApiState(data_dir=d, device="cpu")
    kb = state.get_or_create_kb("notornado")
    assert str(kb.device) == "cpu" and state.kbs.names() == ["notornado"]
    assert api.ApiState is ApiState and api.LocalFileStore is LocalFileStore
try:
    api.create_app
except ImportError as e:
    print("create_app:", type(e).__name__)
print(sorted(m for m in sys.modules if m.startswith("tornado") and sys.modules[m] is not None))
"""


def test_api_state_imports_without_tornado():
    out = subprocess.run([sys.executable, "-c", NO_TORNADO], capture_output=True, text=True,
                         cwd=REPO, timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["create_app: ModuleNotFoundError", "[]"]
