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
FORBIDDEN = {"jax", "jaxlib", "youtu_rag_tpu"}


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
                   "models/wordpiece.py", "models/pretrained.py", "utils/http.py"):
        assert f"youtu_rag_tpu_torch/{module}" in names
    for src in ("topk_pruned.cu", "topk_int8_pruned.cu", "topk_int4_pruned.cu", "topk_select.cuh",
                "topk_scorers.cuh", "ivf_topk.cu", "attention.cu", "topk_blocks.cu"):
        assert (PORT / "csrc" / src).exists()


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
for name in ("transformers", "tokenizers", "safetensors", "httpx"):
    sys.modules[name] = None  # none of them is required: importing them fails
import importlib, pkgutil, tempfile
import numpy as np, torch
import youtu_rag_tpu_torch
names = [m.name for m in pkgutil.walk_packages(youtu_rag_tpu_torch.__path__, "youtu_rag_tpu_torch.")
         if "._build" not in m.name]
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
print(len(names), sorted(m for m in ("transformers", "tokenizers", "safetensors", "httpx")
                         if sys.modules.get(m) is not None))
"""


def test_card_path_needs_no_hf_packages():
    """The port requires none of transformers, tokenizers, safetensors and
    httpx (the card's machine need not have them): every port module imports
    without them, and a pretrained checkpoint (written by the tests' numpy
    writer) embeds and reranks."""
    out = subprocess.run([sys.executable, "-c", CARD_SCRIPT], capture_output=True, text=True,
                         cwd=REPO, timeout=300, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    n_modules, loaded = out.stdout.split(maxsplit=1)
    assert int(n_modules) >= 40 and loaded.strip() == "[]"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from youtu_rag_tpu_torch.index import DeviceVectorIndex
    from youtu_rag_tpu_torch.models.embedder import TorchEmbedder
    from youtu_rag_tpu_torch.retrieval.kb import KnowledgeBase
    from youtu_rag_tpu_torch.retrieval.store import TorchVectorStore
    from youtu_rag_tpu_torch.utils.device import resolve_device

    from youtu_rag_tpu_torch.models.reranker import TorchReranker

    for make in (lambda: resolve_device(None), lambda: DeviceVectorIndex(8),
                 lambda: TorchVectorStore(), lambda: KnowledgeBase("x"), TorchEmbedder,
                 lambda: TorchEmbedder.from_pretrained("/nowhere"),
                 lambda: TorchReranker.from_pretrained("/nowhere"), TorchReranker):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert DeviceVectorIndex(8, device="cpu").device.type == "cpu"


def test_cli_without_cuda_raises(tmp_path):
    (tmp_path / "a.md").write_text("# A\ntext\n")
    code = ("import torch, asyncio; torch.cuda.is_available = lambda: False; "
            "from youtu_rag_tpu_torch import cli_chat; "
            f"asyncio.run(cli_chat.main(['--paths', {str(tmp_path)!r}]))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120, input="")
    assert out.returncode != 0 and "no CUDA device" in out.stderr
