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
                   "index/ivf.py", "models/encoder.py", "models/convert.py"):
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


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from youtu_rag_tpu_torch.index import DeviceVectorIndex
    from youtu_rag_tpu_torch.models.embedder import TorchEmbedder
    from youtu_rag_tpu_torch.retrieval.kb import KnowledgeBase
    from youtu_rag_tpu_torch.retrieval.store import TorchVectorStore
    from youtu_rag_tpu_torch.utils.device import resolve_device

    for make in (lambda: resolve_device(None), lambda: DeviceVectorIndex(8),
                 lambda: TorchVectorStore(), lambda: KnowledgeBase("x"), TorchEmbedder):
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
