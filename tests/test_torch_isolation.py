"""The port stands alone: no module of youtu_rag_tpu_torch (nor
chip_smoke.py) imports jax, jaxlib or the JAX package, a CPU query through
the port loads none of them, and its entry points default to CUDA."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "youtu_rag_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "youtu_rag_tpu", "optax", "orbax", "flax"}


def port_sources():
    # _build/ holds build outputs (gitignored), not the package's sources
    sources = [p for p in PORT.rglob("*.py") if "_build" not in p.relative_to(PORT).parts]
    return sorted(sources) + [REPO / "chip_smoke.py"]


def imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_has_sources():
    names = {p.relative_to(REPO).as_posix() for p in port_sources()}
    for module in ("ops/topk.py", "ops/attention.py", "ops/ivf.py", "ops/kmeans.py",
                   "index/ivf.py", "models/encoder.py", "models/convert.py",
                   "models/wordpiece.py", "models/pretrained.py", "utils/http.py",
                   "models/bpe.py", "models/decoder.py", "agents/llm.py", "agents/local_llm.py",
                   "agents/react.py", "agents/simple_agent.py", "agents/config.py",
                   "agents/events.py", "agents/context.py", "agents/hooks.py",
                   "agents/llm_agent.py", "tools/__init__.py", "tools/base.py",
                   "tools/schema.py", "tools/kb_search.py", "native/__init__.py",
                   "ingest/agent.py", "ingest/processors.py", "ingest/tables.py",
                   "ingest/qa_file.py", "ingest/cleanup.py", "ingest/metadata_extractor.py",
                   "ingest/hichunk.py", "ingest/ocr.py", "memory/store.py", "memory/toolkit.py",
                   "tools/builtin.py", "tools/rag_toolkit.py", "tools/meta_retrieval.py",
                   "tools/text2sql.py", "tools/misc.py", "tools/file_edit.py",
                   "tools/html_toolkit.py", "tools/web.py", "tools/mcp_client.py",
                   "db/adapters.py", "agents/factory.py", "core/loader.py", "eval/config.py",
                   "index/numpy_ref.py", "agents/env.py", "agents/docker_env.py",
                   "agents/orchestra.py", "agents/orchestrator.py", "agents/workforce.py",
                   "db/models.py", "db/migrations.py", "db/service.py", "tracing/otlp.py",
                   "retrieval/monitoring.py", "utils/cache.py", "api/__init__.py",
                   "api/state.py", "api/app.py", "serve_api.py", "replay_server.py",
                   "integrations/__init__.py", "integrations/dtr/__init__.py",
                   "integrations/dtr/session_log.py", "integrations/dtr/table_structure.py",
                   "integrations/dtr/loader.py", "integrations/dtr/smg.py",
                   "integrations/dtr/reward.py", "integrations/dtr/schema_link.py",
                   "integrations/dtr/answer.py", "integrations/dtr/viz.py",
                   "integrations/dtr/operators.py", "integrations/dtr/mcts_planner.py",
                   "integrations/dtr/excel_agent.py", "integrations/dtr/framework.py",
                   "eval/processor.py", "eval/retrieval_eval.py", "eval/benchmark.py",
                   "run_eval.py", "bench/dtr.py", "models/train.py", "models/train_lm.py",
                   "models/checkpoint.py", "models/data_synth.py", "models/lm_synth.py",
                   "models/paraphrase_synth.py", "parallel/expert_parallel.py",
                   "meta/__init__.py", "meta/generators.py", "train_embedder.py",
                   "train_chat_lm.py", "gen_simple_agent.py", "gen_tool.py"):
        assert f"youtu_rag_tpu_torch/{module}" in names
    for src in ("topk_pruned.cu", "topk_int8_pruned.cu", "topk_int4_pruned.cu", "topk_select.cuh",
                "topk_scorers.cuh", "ivf_topk.cu", "attention.cu", "topk_blocks.cu"):
        assert (PORT / "csrc" / src).exists()
    assert (PORT / "native" / "fasthash.c").exists()
    assert (PORT / "agents" / "data" / "planner_examples.json").exists()
    for asset in ("index.html", "app.js", "style.css", "views/chat.js"):
        assert (PORT / "api" / "static" / asset).exists()


@pytest.mark.parametrize("path", port_sources(), ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_jax_imports(path):
    assert not imported_roots(path) & FORBIDDEN


QUERY_SCRIPT = """
import sys
before = {m.split(".")[0] for m in sys.modules}
import asyncio, tempfile, os
from youtu_rag_tpu_torch.retrieval.kb import KnowledgeBase
with tempfile.TemporaryDirectory() as d:
    with open(os.path.join(d, "tpu.md"), "w") as f:
        f.write("# TPU\\nHBM bandwidth on v5e is ~820 GB/s.\\n")
    kb = KnowledgeBase("iso", device="cpu")
    asyncio.run(kb.build_files([os.path.join(d, "tpu.md")]))
    hits = asyncio.run(kb.search("HBM bandwidth", top_k=1))
    assert hits and hits[0].chunk.document_id == "tpu.md"
added = {m.split(".")[0] for m in sys.modules} - before
print(sorted(added & {"jax", "jaxlib", "youtu_rag_tpu"}))
print("youtu_rag_tpu" in sys.modules)
"""


def test_cpu_query_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", QUERY_SCRIPT], capture_output=True, text=True,
                         cwd=REPO, timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "False"]


CARD_SCRIPT = """
import sys
for name in ("transformers", "tokenizers", "safetensors", "httpx", "pandas", "cffi", "yaml",
             "bs4", "tornado"):
    sys.modules[name] = None  # none of them is required: importing them fails
import importlib, pkgutil, tempfile
import numpy as np, torch
import youtu_rag_tpu_torch
# the two modules that serve over tornado need it (serve_api imports the app
# when it serves)
SERVE = {"youtu_rag_tpu_torch.api.app", "youtu_rag_tpu_torch.replay_server"}
names = [m.name for m in pkgutil.walk_packages(youtu_rag_tpu_torch.__path__, "youtu_rag_tpu_torch.")
         if "._build" not in m.name and m.name not in SERVE]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, "tests")
from torch_bert_checkpoint import write_bert_dir
from youtu_rag_tpu_torch.models.embedder import TorchEmbedder
from youtu_rag_tpu_torch.models.reranker import TorchReranker
with tempfile.TemporaryDirectory() as d:
    emb = TorchEmbedder.from_pretrained(write_bert_dir(d + "/e", pooling="cls", dtype="BF16"),
                                        dtype=torch.float32, device="cpu")
    assert emb.tokenizer._fast is None  # the pure-Python WordPiece
    vecs = emb.embed_batch(["the quick brown fox", "hello world"])
    assert vecs.shape == (2, 32) and np.allclose(np.linalg.norm(vecs, axis=1), 1.0, atol=1e-5)
    rr = TorchReranker.from_pretrained(write_bert_dir(d + "/r", num_labels=1), device="cpu")
    scores = rr.score("quick fox", ["the quick brown fox", "lazy dog"])
    assert len(scores) == 2 and np.isfinite(scores).all()
print(len(names), sorted(m for m in ("transformers", "tokenizers", "safetensors", "httpx",
                                    "pandas", "cffi", "yaml", "bs4", "tornado")
                         if sys.modules.get(m) is not None))
"""


def test_card_path_needs_no_hf_packages():
    """The port requires none of transformers, tokenizers, safetensors,
    httpx, pandas, cffi, yaml, bs4 and tornado (the card's machine need not
    have them): every port module but the two that serve over tornado
    imports without them, and a pretrained
    checkpoint (written by the tests' numpy writer) embeds and reranks."""
    out = subprocess.run([sys.executable, "-c", CARD_SCRIPT], capture_output=True, text=True,
                         cwd=REPO, timeout=300, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    n_modules, loaded = out.stdout.split(maxsplit=1)
    assert int(n_modules) >= 40 and loaded.strip() == "[]"


NATIVE_SCRIPT = """
import json, os, sys, tempfile
from pathlib import Path
import youtu_rag_tpu_torch.native as native

port = Path(native.__file__).resolve().parent.parent
default_library = native.library_path()
native.BUILD_DIR = Path(tempfile.mkdtemp(dir=port / "_build"))  # a fresh build, under _build/
events = {"open": [], "dlopen": [], "popen": []}

def hook(event, args):
    if event == "open" and isinstance(args[0], (str, bytes, os.PathLike)):
        events["open"].append(os.fsdecode(args[0]))
    elif event == "ctypes.dlopen":
        events["dlopen"].append(os.fsdecode(args[0]))
    elif event == "subprocess.Popen":
        events["popen"].append([os.fsdecode(a) for a in args[1]])

sys.addaudithook(hook)
native.load()
native.hash_embed_batch_native(["a text", "中文"], 16)
native.tokenize_ids_native("a text", 6, 32764, 4)
snapshot = {k: list(v) for k, v in events.items()}
built = sorted(p.name for p in native.BUILD_DIR.iterdir())
for p in native.BUILD_DIR.iterdir():
    p.unlink()
native.BUILD_DIR.rmdir()
print(json.dumps({"events": snapshot, "built": built, "library": str(native.library_path()),
                  "build_dir": str(native.BUILD_DIR), "default": str(default_library)}))
"""


def test_native_build_reads_only_the_port():
    """``native/__init__.py`` opens no file outside youtu_rag_tpu_torch/
    (its C source is the port's copy, never the JAX package's), compiles
    that copy alone into a file under ``_build/`` and loads the library
    from there; by default the library is ``_build/fasthash-<hash>.so``."""
    out = subprocess.run([sys.executable, "-c", NATIVE_SCRIPT], capture_output=True, text=True,
                         cwd=REPO, timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    got = __import__("json").loads(out.stdout.strip().splitlines()[-1])
    build_dir, events = Path(got["build_dir"]), got["events"]
    assert build_dir.parent == PORT / "_build"
    assert Path(got["default"]).parent == PORT / "_build"
    assert Path(got["default"]).name.startswith("fasthash-") and got["default"].endswith(".so")
    assert got["built"] == [Path(got["library"]).name]
    assert events["open"] and all(Path(p).resolve().is_relative_to(PORT) for p in events["open"])
    assert events["dlopen"] == [got["library"]]
    (cmd,) = events["popen"]
    assert str(PORT / "native" / "fasthash.c") in cmd
    files = [a for a in cmd[1:] if "/" in a]
    assert all(Path(a).resolve().is_relative_to(PORT) for a in files), cmd
    assert Path(cmd[cmd.index("-o") + 1]).parent == build_dir


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, tmp_path):
    from youtu_rag_tpu_torch.index import DeviceVectorIndex
    from youtu_rag_tpu_torch.models.embedder import TorchEmbedder
    from youtu_rag_tpu_torch.retrieval.kb import KnowledgeBase
    from youtu_rag_tpu_torch.retrieval.store import TorchVectorStore
    from youtu_rag_tpu_torch.utils.device import resolve_device

    from youtu_rag_tpu_torch.api.state import ApiState
    from youtu_rag_tpu_torch.agents.llm import get_chat_client
    from youtu_rag_tpu_torch.agents.local_llm import LocalChatClient
    from youtu_rag_tpu_torch.memory import MemoryVectorStore, VectorMemoryToolkit
    from youtu_rag_tpu_torch.models.embedder import HashEmbedder
    from youtu_rag_tpu_torch.models.reranker import TorchReranker

    for make in (lambda: resolve_device(None), lambda: DeviceVectorIndex(8),
                 lambda: TorchVectorStore(), lambda: KnowledgeBase("x"), TorchEmbedder,
                 lambda: TorchEmbedder.from_pretrained("/nowhere"),
                 lambda: TorchReranker.from_pretrained("/nowhere"), TorchReranker,
                 lambda: LocalChatClient("/nowhere"),
                 lambda: get_chat_client({"provider": "local", "weights_dir": "/nowhere"}),
                 lambda: MemoryVectorStore(HashEmbedder(16)), VectorMemoryToolkit,
                 lambda: VectorMemoryToolkit({"user_id": "u"}),
                 lambda: ApiState(data_dir=str(tmp_path))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert DeviceVectorIndex(8, device="cpu").device.type == "cpu"
    assert MemoryVectorStore(HashEmbedder(16), device="cpu").store.device.type == "cpu"
    assert VectorMemoryToolkit({"device": "cpu"}).store.store.device.type == "cpu"
    assert ApiState(data_dir=str(tmp_path), device="cpu").device.type == "cpu"


def test_cli_without_cuda_raises(tmp_path):
    (tmp_path / "a.md").write_text("# A\ntext\n")
    code = ("import torch, asyncio; torch.cuda.is_available = lambda: False; "
            "from youtu_rag_tpu_torch import cli_chat; "
            f"asyncio.run(cli_chat.main(['--paths', {str(tmp_path)!r}]))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120, input="")
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def test_tool_prompt_names_no_jax_module():
    """A generated toolkit imports the port's base class, never the JAX
    package's."""
    from youtu_rag_tpu_torch.meta.generators import TOOL_GEN_PROMPT

    assert "youtu_rag_tpu." not in TOOL_GEN_PROMPT
    assert "youtu_rag_tpu_torch.tools.base" in TOOL_GEN_PROMPT


@pytest.mark.parametrize("entry,argv", [
    ("train_embedder", ["--synthetic", "4", "--preset", "tiny", "--steps", "1"]),
    ("train_chat_lm", ["--steps", "1"]),
])
def test_trainers_without_cuda_raise(entry, argv, no_cuda, tmp_path):
    import importlib

    mod = importlib.import_module(f"youtu_rag_tpu_torch.{entry}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv + ["--out", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
