"""``ops/precision.py::f32_matmul``: the port turns TF32 off for its f32
products and puts back the caller's setting.

- the helper restores ``torch.backends.cuda.matmul.allow_tf32`` whether it
  was True or False, also when the body raises;
- the ten places that held their products to f32 each go through the
  helper (a scan of their sources: no module of the port assigns the flag
  any more);
- a caller's True survives a brute search, an IVF search, an encoder
  forward, the ring's plain hop and a k-means fit (on the CPU, where the
  helper runs the same way).
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from youtu_rag_tpu_torch.ops.precision import f32_matmul

PORT = Path(__file__).resolve().parent.parent / "youtu_rag_tpu_torch"
# (module, function) of each product held to f32
SITES = [
    ("index/device_index.py", "_residual_rerank"),
    ("index/ivf.py", "probe_blocks"),
    ("models/encoder.py", "_attention_core"),
    ("parallel/sequence_parallel.py", "_ring_attention"),
    ("ops/kmeans.py", "kmeans_lloyd"),
    ("ops/kmeans.py", "kmeans_assign"),
    ("ops/topk.py", "_bf16_scores"),
    ("ops/topk.py", "_exact_dot"),
    ("ops/ivf.py", "ivf_topk_dma_reference"),
    ("ops/attention.py", "_scores"),
]


@pytest.fixture
def tf32_flag():
    saved = torch.backends.cuda.matmul.allow_tf32
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("before", [True, False])
def test_helper_restores_the_flag(tf32_flag, before):
    torch.backends.cuda.matmul.allow_tf32 = before
    with f32_matmul():
        assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is before
    with pytest.raises(RuntimeError, match="inside"):
        with f32_matmul():
            raise RuntimeError("inside")
    assert torch.backends.cuda.matmul.allow_tf32 is before


def _functions(path: Path) -> dict[str, ast.FunctionDef]:
    tree = ast.parse(path.read_text())
    return {n.name: n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}


def _uses_helper(fn: ast.FunctionDef) -> bool:
    return any(isinstance(n, ast.With) and any(
        isinstance(i.context_expr, ast.Call) and getattr(i.context_expr.func, "id", "")
        == "f32_matmul" for i in n.items) for n in ast.walk(fn))


@pytest.mark.parametrize("module,function", SITES)
def test_each_site_goes_through_the_helper(module, function):
    fns = _functions(PORT / module)
    assert function in fns, f"{module} has no {function}"
    assert _uses_helper(fns[function]), f"{module}:{function} does not use f32_matmul"


def test_no_module_sets_the_flag():
    for path in sorted(PORT.rglob("*.py")):
        if "_build" in path.parts or path.name == "precision.py":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    assert not (isinstance(t, ast.Attribute) and t.attr == "allow_tf32"), (
                        f"{path.relative_to(PORT)}:{node.lineno} sets allow_tf32")


def test_a_callers_tf32_survives_searches_forwards_and_kmeans(tf32_flag):
    from youtu_rag_tpu_torch.core.config import IndexConfig
    from youtu_rag_tpu_torch.core.types import Chunk
    from youtu_rag_tpu_torch.index import DeviceVectorIndex
    from youtu_rag_tpu_torch.models.encoder import EncoderConfig, encode_tokens, init_encoder_params
    from youtu_rag_tpu_torch.ops import kmeans_fit
    from youtu_rag_tpu_torch.parallel import make_sp_encoder

    torch.backends.cuda.matmul.allow_tf32 = True
    x = np.random.default_rng(0).standard_normal((512, 32)).astype(np.float32)
    idx = DeviceVectorIndex(32, IndexConfig(block_rows=64, n_lists=4, n_probe=2), device="cpu")
    idx.add([Chunk(f"c{i}", "doc", "", i) for i in range(512)], x)
    idx.search(x[:2], top_k=3)
    assert torch.backends.cuda.matmul.allow_tf32 is True
    idx.build_ivf()
    assert idx.search(x[:2], top_k=3)[0][0][0].id == "c0"
    assert torch.backends.cuda.matmul.allow_tf32 is True
    cfg = EncoderConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=2, d_ff=64, out_dim=16,
                        dtype=torch.float32)
    params = init_encoder_params(cfg, torch.Generator().manual_seed(0))
    ids, mask = torch.randint(1, 64, (2, 16)), torch.ones(2, 16)
    encode_tokens(params, ids, mask, cfg)
    make_sp_encoder(cfg, 2)(params, ids, mask)
    kmeans_fit(torch.from_numpy(x), 4)
    assert torch.backends.cuda.matmul.allow_tf32 is True
