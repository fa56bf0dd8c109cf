"""Kernel tests of youtu_rag_tpu_torch that need an NVIDIA GPU.

They carry the ``cuda`` marker and skip on hosts without CUDA. The file
imports nothing of JAX, so on the card it runs without the JAX package:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

import os
import sys

import numpy as np
import pytest
import torch

from youtu_rag_tpu_torch.core.config import IndexConfig
from youtu_rag_tpu_torch.core.types import Chunk
from youtu_rag_tpu_torch.index import DeviceVectorIndex
from youtu_rag_tpu_torch.ops.ivf import (
    ivf_topk,
    ivf_topk_dma,
    ivf_topk_dma_reference,
    ivf_topk_int4_dma,
    ivf_topk_int4_dma_reference,
    ivf_topk_int8,
    ivf_topk_int8_dma,
    ivf_topk_int8_dma_reference,
    ivf_topk_int8_reference,
    ivf_topk_reference,
)
from youtu_rag_tpu_torch.ops.attention import (
    blockwise_attention,
    blockwise_attention_reference,
    flash_attention,
    flash_attention_reference,
    flash_attention_stats,
    flash_attention_stats_reference,
)
from youtu_rag_tpu_torch.ops.topk import (
    NEG_INF,
    fused_topk,
    quantize_rows_int4,
    quantize_rows_int8,
    topk,
    topk_int4_pruned,
    topk_int4_pruned_reference,
    topk_int8,
    topk_int8_pruned,
    topk_int8_pruned_reference,
    topk_int8_reference,
    topk_pruned,
    topk_pruned_reference,
    topk_reference,
)

sys.path.insert(0, os.path.dirname(__file__))
from torch_ivf_cases import IVF_CASES, IVF_WIDE_CASES  # noqa: E402
from torch_ivf_cases import make_inputs as ivf_case_inputs  # noqa: E402

TOL = 1e-4  # unit vectors; f32 sums in another order than cuBLAS
N = 4096


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def make_inputs(q, d, seed, n=N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[101:105] = x[3]  # exact ties
    qs = rng.standard_normal((q, d)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    qs[0] = x[3]
    bias = np.zeros(n, np.float32)
    bias[::5] = NEG_INF
    bias[7::13] = -np.inf
    return qs, x, bias


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 50, 128, 256, 1024])
@pytest.mark.parametrize("q", [1, 8, 64])
def test_kernel_matches_plain_version(cuda_device, q, k):
    qs, x, bias = make_inputs(q, 256, seed=q + k)
    args = (torch.from_numpy(qs).to(cuda_device),
            torch.from_numpy(x).to(cuda_device, torch.bfloat16),
            torch.from_numpy(bias).to(cuda_device), k)
    before = topk_pruned.launches
    s, i = topk_pruned(*args)
    torch.cuda.synchronize()
    assert topk_pruned.launches == before + 1
    ws, wi = topk_pruned_reference(*args)
    s, i, ws, wi = (t.cpu().numpy() for t in (s, i, ws, wi))
    for a in range(q):
        n = int((ws[a] > NEG_INF / 2).sum())
        assert int((s[a] > NEG_INF / 2).sum()) == n
        np.testing.assert_allclose(s[a, :n], ws[a, :n], atol=TOL)
        assert set(i[a, :n].tolist()) == set(wi[a, :n].tolist())
    assert i[0, : min(k, 5)].tolist() == [3, 101, 102, 103, 104][: min(k, 5)]


@pytest.mark.cuda
def test_kernel_rejects_out_of_contract(cuda_device):
    qs, x, bias = make_inputs(3, 128, seed=0)
    xd = torch.from_numpy(x).to(cuda_device, torch.bfloat16)
    qd, bd = torch.from_numpy(qs).to(cuda_device), torch.from_numpy(bias).to(cuda_device)
    with pytest.raises(ValueError):
        topk_pruned(qd, xd, bd, N + 1)  # k above the rows
    with pytest.raises(ValueError):
        topk_pruned(qd, xd.float(), bd, 10)
    with pytest.raises(ValueError):
        topk_pruned(qd, xd, bd.cpu(), 10)


QUANT = {
    "int8": (quantize_rows_int8, topk_int8_pruned, topk_int8_pruned_reference),
    "int4": (quantize_rows_int4, topk_int4_pruned, topk_int4_pruned_reference),
}


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["int8", "int4"])
@pytest.mark.parametrize("k", [1, 10, 50, 128, 256, 1024])
@pytest.mark.parametrize("q", [1, 8, 64])
def test_quantized_kernel_is_bit_equal_to_plain_version(cuda_device, tier, q, k):
    """The same quantized tensors through kernel and plain version: equal
    rows and bit-equal scores on live slots (exact integer dots and the
    same op-by-op f32 epilogue leave nothing to tolerate)."""
    quantize, kernel, plain = QUANT[tier]
    qs, x, bias = make_inputs(q, 512, seed=q * 7 + k)
    xq, xs = quantize(torch.from_numpy(x).to(cuda_device))
    args = (torch.from_numpy(qs).to(cuda_device), xq, xs, torch.from_numpy(bias).to(cuda_device), k)
    before = kernel.launches
    s, i = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ws, wi = plain(*args)
    s, i, ws, wi = (t.cpu().numpy() for t in (s, i, ws, wi))
    for a in range(q):
        n = int((ws[a] > NEG_INF / 2).sum())
        assert int((s[a] > NEG_INF / 2).sum()) == n
        np.testing.assert_array_equal(s[a, :n].view(np.uint32), ws[a, :n].view(np.uint32))
        np.testing.assert_array_equal(i[a, :n], wi[a, :n])
    assert i[0, : min(k, 5)].tolist() == [3, 101, 102, 103, 104][: min(k, 5)]


def assert_bit_equal(got, want):
    s, i, ws, wi = (t.cpu().numpy() for t in (*got, *want))
    for a in range(ws.shape[0]):
        n = int((ws[a] > NEG_INF / 2).sum())
        assert int((s[a] > NEG_INF / 2).sum()) == n
        np.testing.assert_array_equal(s[a, :n].view(np.uint32), ws[a, :n].view(np.uint32))
        np.testing.assert_array_equal(i[a, :n], wi[a, :n])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 64, 1024])
@pytest.mark.parametrize("n", [4099, 20011])
@pytest.mark.parametrize("d", [256, 768, 4096])
def test_int4_tensor_core_scorer_is_bit_equal(cuda_device, d, n, k):
    """The int4 scan's mma.sync scorer over 16-row warp tiles: row counts
    that are not a multiple of 16, one to 32 chunk rounds per row."""
    rng = np.random.default_rng(d + n + k)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[n - 5 :] = x[3]  # exact ties in the last, partial warp tile
    qs = rng.standard_normal((8, d)).astype(np.float32)
    qs[0] = x[3]
    bias = np.zeros(n, np.float32)
    bias[::9] = NEG_INF
    xq, xs = quantize_rows_int4(torch.from_numpy(x).to(cuda_device))
    args = (torch.from_numpy(qs).to(cuda_device), xq, xs, torch.from_numpy(bias).to(cuda_device), k)
    got = topk_int4_pruned(*args)
    torch.cuda.synchronize()
    assert_bit_equal(got, topk_int4_pruned_reference(*args))
    live = [r for r in [3] + list(range(n - 5, n)) if bias[r] == 0]
    assert got[1][0, : min(k, len(live))].tolist() == live[: min(k, len(live))]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 64, 1024, 2048])
@pytest.mark.parametrize("block_rows", [4, 8, 12, 1024])
def test_int4_ivf_warp_tiles_straddle_blocks(cuda_device, block_rows, k):
    """IVF int4 over probed blocks of 4, 8 and 12 rows: a 32-row stage of
    the ring, and a warp's 16-row group, take rows of several blocks, each
    block's run copied on its own."""
    n, d = 12288, 256
    rng = np.random.default_rng(block_rows + k)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    qs = rng.standard_normal((8, d)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    bias = np.zeros(n, np.float32)
    bias[::7] = NEG_INF
    xq, xs = quantize_rows_int4(torch.from_numpy(x).to(cuda_device))
    n_blocks = n // block_rows
    ids, nv = ivf_plan(n_blocks, n_blocks, n_blocks // 2, seed=k, device=cuda_device)
    args = (torch.from_numpy(qs).to(cuda_device), xq, xs, torch.from_numpy(bias).to(cuda_device),
            ids, nv, k)
    got = ivf_topk_int4_dma(*args, block_rows=block_rows)
    torch.cuda.synchronize()
    want = ivf_topk_int4_dma_reference(*args, block_rows=block_rows)
    assert_bit_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["int8", "int4"])
def test_quantized_kernel_rejects_out_of_contract(cuda_device, tier):
    quantize, kernel, _ = QUANT[tier]
    qs, x, bias = make_inputs(3, 256, seed=0)
    xq, xs = quantize(torch.from_numpy(x).to(cuda_device))
    qd, bd = torch.from_numpy(qs).to(cuda_device), torch.from_numpy(bias).to(cuda_device)
    with pytest.raises(ValueError):
        kernel(qd, xq, xs, bd, N + 1)  # k above the rows
    with pytest.raises(ValueError):
        kernel(qd, xq.float(), xs, bd, 10)
    with pytest.raises(ValueError):
        kernel(qd, xq[:, :64].contiguous(), xs, bd, 10)  # width off the 128 grid
    with pytest.raises(ValueError):
        kernel(qd, xq, xs.double(), bd, 10)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cosine", "l2", "ip"])
@pytest.mark.parametrize("tier", [("int8", 4.0), ("int4", 4.0), ("int4", 0.0)],
                         ids=["int8", "int4-rerank", "int4-raw"])
def test_quantized_cuda_index_answers_like_cpu_index(cuda_device, tier, metric):
    """Bit-equal kernels: the CUDA and CPU indexes return the same chunks
    with the same scores, through each tier's kernel."""
    storage_dtype, mult = tier
    kernel = QUANT[storage_dtype][1]
    rng = np.random.default_rng(1)
    embs = rng.standard_normal((700, 96)).astype(np.float32)
    chunks = [Chunk(f"c{i}", f"d{i % 7}", "", i, {"idx": i}) for i in range(700)]
    cfg = IndexConfig(metric=metric, min_capacity=256, block_rows=128,
                      storage_dtype=storage_dtype, int4_rerank_multiplier=mult)
    gpu, cpu = DeviceVectorIndex(96, cfg, device=cuda_device), DeviceVectorIndex(96, cfg, device="cpu")
    for ix in (gpu, cpu):
        ix.add(chunks, embs)
        ix.delete([f"c{i}" for i in range(0, 700, 9)])
    q = rng.standard_normal((70, 96)).astype(np.float32)  # > 64: two kernel launches
    before = kernel.launches
    for filters, top_k in ((None, 10), ({"idx": {"$lt": 300}}, 50), (None, 300)):
        got, want = gpu.search(q, top_k, filters), cpu.search(q, top_k, filters)
        assert [[(c.id, s) for c, s in h] for h in got] == [[(c.id, s) for c, s in h] for h in want]
    assert kernel.launches == before + 6


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cosine", "l2", "ip"])
def test_cuda_index_answers_like_cpu_index(cuda_device, metric):
    rng = np.random.default_rng(0)
    embs = rng.standard_normal((700, 96)).astype(np.float32)
    chunks = [Chunk(f"c{i}", f"d{i % 7}", "", i, {"idx": i}) for i in range(700)]
    cfg = IndexConfig(metric=metric, min_capacity=256, block_rows=128)
    gpu, cpu = DeviceVectorIndex(96, cfg, device=cuda_device), DeviceVectorIndex(96, cfg, device="cpu")
    for ix in (gpu, cpu):
        ix.add(chunks, embs)
        ix.delete([f"c{i}" for i in range(0, 700, 9)])
    q = rng.standard_normal((70, 96)).astype(np.float32)  # > 64: two kernel launches
    before = topk_pruned.launches
    for filters in (None, {"idx": {"$lt": 300}}):
        got, want = gpu.search(q, 50, filters), cpu.search(q, 50, filters)
        for g, w in zip(got, want):
            np.testing.assert_allclose([s for _, s in g], [s for _, s in w], atol=TOL)
            assert all(a.id == b.id or abs(sa - sb) <= TOL for (a, sa), (b, sb) in zip(g, w))
    assert topk_pruned.launches == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
def test_cuda_index_refuses_plain_backends(cuda_device, backend):
    """A CUDA index runs the kernel under "auto" and "pallas" and refuses
    the names of JAX's plain paths rather than run them on the card."""
    rng = np.random.default_rng(0)
    idx = DeviceVectorIndex(96, IndexConfig(min_capacity=256), device=cuda_device)
    idx.add([Chunk(f"c{i}", "d", "", i) for i in range(100)],
            rng.standard_normal((100, 96)).astype(np.float32))
    q = rng.standard_normal((2, 96)).astype(np.float32)
    before = topk_pruned.launches
    assert [len(h) for h in idx.search(q, 5, backend="auto")] == [5, 5]
    assert [len(h) for h in idx.search(q, 5, backend="pallas")] == [5, 5]
    assert topk_pruned.launches == before + 2
    with pytest.raises(ValueError, match="device='cpu'"):
        idx.search(q, 5, backend=backend)
    with pytest.raises(ValueError, match="unknown backend"):
        idx.search(q, 5, backend="triton")


ATTENTION = {"blockwise": (blockwise_attention, blockwise_attention_reference),
             "flash": (flash_attention, flash_attention_reference)}


def attention_inputs(b, h, t, hd, dtype, device, seed=0):
    """q, k, v on the card and the encoder's -1e9 bias: row 0 padded past
    t/2 + 3, the last batch row fully masked."""
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(b, h, t, hd, generator=g, device=device).to(dtype) for _ in range(3))
    mask = torch.ones(b, t, device=device)
    mask[0, t // 2 + 3 :] = 0
    mask[-1] = 0
    return q, k, v, (1.0 - mask) * -1e9


def assert_attention_close(got, want):
    """bf16: one bf16 ulp of the output (sums in another order, and flash's
    128-key tiles against JAX's key blocks, move a value across a bf16
    rounding); f32: the kernel's three-term bf16 split of each operand
    keeps ~f32 products, summed in another order."""
    if got.dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=2**-7, atol=2**-10)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("t", [256, 1024])
@pytest.mark.parametrize("kind", list(ATTENTION))
def test_attention_kernel_matches_plain_version(cuda_device, kind, t, hd, dtype):
    kernel, plain = ATTENTION[kind]
    args = attention_inputs(3, 2, t, hd, dtype, cuda_device, seed=t + hd)
    before = kernel.launches
    got = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.dtype == dtype and got.shape == args[0].shape and torch.isfinite(got).all()
    assert_attention_close(got, plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(ATTENTION))
def test_attention_kernel_reads_strided_heads(cuda_device, kind):
    """The encoder hands the kernel [B, T, H, hd] projections viewed as
    [B, H, T, hd]; the kernel reads them through their strides."""
    kernel, _ = ATTENTION[kind]
    q, k, v, bias = attention_inputs(2, 4, 512, 64, torch.bfloat16, cuda_device)
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    assert not views[0].is_contiguous()
    torch.testing.assert_close(kernel(*views, bias), kernel(q, k, v, bias), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("t", [256, 384, 640, 4224])
@pytest.mark.parametrize("kind", list(ATTENTION))
def test_hopper_attention_matches_plain_version(cuda_device, kind, t, hd):
    """bf16 runs the wgmma + TMA kernels: T = 256 has fewer key tiles than
    the ring has stages, 384 and 640 tile counts the stages do not divide;
    B·H = 6 gives 12 to 30 work items below T = 4224, so the persistent
    grid shrinks to that many CTAs (one item each), far below the SMs."""
    kernel, plain = ATTENTION[kind]
    args = attention_inputs(3, 2, t, hd, torch.bfloat16, cuda_device, seed=t + hd + 1)
    got = kernel(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert_attention_close(got, plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("kind", list(ATTENTION))
def test_hopper_attention_reads_strided_views(cuda_device, kind, hd):
    """q, k, v as views of one packed [B, T, 3, H, hd] projection (row
    stride 3·H·hd, head stride hd): the tensor maps take the strides."""
    kernel, plain = ATTENTION[kind]
    b, h, t = 2, 3, 512
    g = torch.Generator(device=cuda_device).manual_seed(hd)
    qkv = torch.randn(b, t, 3, h, hd, generator=g, device=cuda_device).to(torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    assert q.stride() == (t * 3 * h * hd, hd, 3 * h * hd, 1)
    bias = attention_inputs(b, h, t, hd, torch.bfloat16, cuda_device)[3]
    got = kernel(q, k, v, bias)
    torch.cuda.synchronize()
    assert_attention_close(got, plain(q, k, v, bias))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(ATTENTION))
def test_hopper_attention_walks_many_items_per_cta(cuda_device, kind):
    """[16, 12, 512, 64]: 384 work items over at most 132 CTAs, so each CTA
    walks several items through both Q slots and many turns of the ring."""
    kernel, plain = ATTENTION[kind]
    args = attention_inputs(16, 12, 512, 64, torch.bfloat16, cuda_device, seed=5)
    got = kernel(*args)
    torch.cuda.synchronize()
    assert_attention_close(got, plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(ATTENTION))
def test_hopper_attention_back_to_back_shapes(cuda_device, kind):
    """Two calls of other shapes, then the first again, enqueued without a
    sync: each launch carries its own tensor maps."""
    kernel, plain = ATTENTION[kind]
    a = attention_inputs(3, 2, 512, 64, torch.bfloat16, cuda_device, seed=1)
    b = attention_inputs(2, 4, 256, 128, torch.bfloat16, cuda_device, seed=2)
    got = [kernel(*a), kernel(*b), kernel(*a)]
    torch.cuda.synchronize()
    assert_attention_close(got[0], plain(*a))
    assert_attention_close(got[1], plain(*b))
    torch.testing.assert_close(got[2], got[0], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(ATTENTION))
def test_hopper_attention_on_a_side_stream(cuda_device, kind):
    """The launch goes to the current stream: on a side stream the result
    is ready once that stream is synchronized."""
    kernel, plain = ATTENTION[kind]
    args = attention_inputs(3, 2, 384, 64, torch.bfloat16, cuda_device, seed=3)
    side = torch.cuda.Stream(device=cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        got = kernel(*args)
    side.synchronize()
    assert_attention_close(got, plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(ATTENTION))
def test_attention_kernel_rejects_out_of_contract(cuda_device, kind):
    kernel, _ = ATTENTION[kind]
    q, k, v, bias = attention_inputs(2, 2, 256, 64, torch.bfloat16, cuda_device)
    with pytest.raises(ValueError):
        kernel(q[..., :32], k[..., :32], v[..., :32], bias)
    with pytest.raises(ValueError):
        kernel(q[:, :, :128], k[:, :, :128], v[:, :, :128], bias[:, :128])
    with pytest.raises(ValueError):
        kernel(q.half(), k.half(), v.half(), bias)
    with pytest.raises(ValueError):
        kernel(q, k, v, bias.cpu())


@pytest.mark.cuda
def test_committed_encoder_on_the_card_ranks_like_the_cpu(cuda_device):
    """yrt_tiny_lex served through the blockwise kernel on the card ranks
    the exact-identifier documents as on the CPU, with embeddings within
    3e-2 (the JAX package's bf16 encoder tolerance)."""
    import dataclasses
    import pathlib

    from youtu_rag_tpu_torch.models.embedder import TorchEmbedder

    weights = pathlib.Path(__file__).parents[1] / "benchmarks" / "models" / "yrt_tiny_lex"
    docs = ["Maintenance log for unit KL-4407. The inventory tag recorded for unit KL-4407 is "
            "88213. " + "Routine inspection notes follow. " * 40,
            "Maintenance log for unit QX-9911. The inventory tag recorded for unit QX-9911 is "
            "55120. " + "Routine inspection notes follow. " * 40,
            "An unrelated paragraph about glacier hydrology field surveys. " * 30]
    query = "What is the inventory tag recorded for KL-4407?"
    cpu = TorchEmbedder.from_weights_dir(weights, device="cpu")
    card = TorchEmbedder(config=dataclasses.replace(cpu.cfg, attention_impl="pallas"),
                         params=cpu.params, device=cuda_device)
    before = blockwise_attention.launches
    got = card.embed_batch(docs + [query])
    assert blockwise_attention.launches - before == cpu.cfg.n_layers  # the T = 256 batch
    want = cpu.embed_batch(docs + [query])
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-2)
    scores = got[:3] @ got[3]
    assert scores[0] > scores[1] > scores[2]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["embedder", "reranker"])
def test_pretrained_bert_on_the_card_matches_the_cpu(cuda_device, tmp_path, kind):
    """A BERT-family checkpoint (hd 64) served on the card from_pretrained:
    bf16 with the blockwise kernel at T >= 256 (n_layers launches per such
    forward, none below), within 3e-2 (the JAX package's bf16 encoder
    tolerance) of the CPU f32 forward of the same checkpoint."""
    from torch_bert_checkpoint import VOCAB, write_bert_dir

    from youtu_rag_tpu_torch.models.embedder import TorchEmbedder
    from youtu_rag_tpu_torch.models.reranker import TorchReranker

    d = write_bert_dir(tmp_path / kind, hidden=128, layers=2, heads=2, inter=256, max_pos=512,
                       num_labels=1 if kind == "reranker" else None,
                       pooling="cls" if kind == "embedder" else None)
    rng = np.random.default_rng(0)
    words = VOCAB[5:]
    long = [" ".join(rng.choice(words, size=int(n))) for n in (300, 420, 600)]
    short = ["the quick brown fox", "中国人 hello"]
    cls = TorchEmbedder if kind == "embedder" else TorchReranker
    card = cls.from_pretrained(d, device=cuda_device)
    cpu = cls.from_pretrained(d, dtype=torch.float32, device="cpu")
    assert card.cfg.attention_impl == "pallas" and card.cfg.dtype == torch.bfloat16
    for texts, want_launches in ((long, card.cfg.n_layers), (short, 0)):
        before = blockwise_attention.launches
        if kind == "embedder":
            got, want = card.embed_batch(texts), cpu.embed_batch(texts)
        else:
            got, want = (np.asarray(m.score("quick fox", texts)) for m in (card, cpu))
        torch.cuda.synchronize()
        assert blockwise_attention.launches - before == want_launches
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-2)


IVF = {
    "bf16": (None, ivf_topk_dma, ivf_topk_dma_reference),
    "int8": (quantize_rows_int8, ivf_topk_int8_dma, ivf_topk_int8_dma_reference),
    "int4": (quantize_rows_int4, ivf_topk_int4_dma, ivf_topk_int4_dma_reference),
}


def ivf_plan(n_blocks, max_blocks, n_valid, seed, device, block_rows=None, order="sorted"):
    """n_valid probed blocks in ascending id (or shuffled), blocks 0 and 1
    among them (with ``block_rows``: the blocks of make_inputs' exact ties,
    rows 3 and 101-104, instead), then garbage ids (out of range) that the
    kernel must never read."""
    rng = np.random.default_rng(seed)
    ids = np.full(max_blocks, 10**8, np.int32)
    first = [0, 1] if block_rows is None else sorted({r // block_rows for r in (3, *range(101, 105))})
    first = first[:n_valid]
    rest = np.setdiff1d(np.arange(n_blocks), first)
    chosen = first + list(rng.choice(rest, max(n_valid - len(first), 0), replace=False))
    ids[:n_valid] = np.sort(chosen) if order == "sorted" else rng.permutation(chosen)
    return (torch.from_numpy(ids).to(device),
            torch.tensor(n_valid, dtype=torch.int32, device=device))


def ivf_inputs(tier, q, seed, device, n=N, qdtype="f32"):
    """(queries, stored rows, extra (the scales), bias) of one tier on
    ``device``; queries in f32 or bf16."""
    quantize = IVF[tier][0]
    qs, x, bias = make_inputs(q, 256, seed=seed, n=n)
    xt = torch.from_numpy(x).to(device)
    extra = ()
    if quantize is None:
        xt = xt.to(torch.bfloat16)
    else:
        xt, xs = quantize(xt)
        extra = (xs,)
    qt = torch.from_numpy(qs).to(device)
    if qdtype == "bf16":
        qt = qt.to(torch.bfloat16)
    return qt, xt, extra, torch.from_numpy(bias).to(device)


def assert_ivf_equal(tier, got, want):
    """bf16 within TOL with the same row sets; int8/int4 bit-equal rows and
    scores; empty slots (NEG_INF, 0) in both."""
    s, i, ws, wi = (t.cpu().numpy() for t in (*got, *want))
    assert s.shape == ws.shape
    for a in range(s.shape[0]):
        n = int((ws[a] > NEG_INF / 2).sum())
        assert int((s[a] > NEG_INF / 2).sum()) == n
        assert (s[a, n:] == NEG_INF).all() and (i[a, n:] == 0).all()
        if tier == "bf16":
            np.testing.assert_allclose(s[a, :n], ws[a, :n], atol=TOL)
            assert set(i[a, :n].tolist()) == set(wi[a, :n].tolist())
        else:
            np.testing.assert_array_equal(s[a, :n].view(np.uint32), ws[a, :n].view(np.uint32))
            np.testing.assert_array_equal(i[a, :n], wi[a, :n])


IVF_N = 16384  # block_rows up to 4096: four blocks, two of them probed


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", ["f32", "bf16"])
@pytest.mark.parametrize("tier", list(IVF))
@pytest.mark.parametrize("k", [1, 10, 32, 33, 128, 129, 1024, 1025])
@pytest.mark.parametrize("q", [1, 7, 8, 9, 64, 65])
@pytest.mark.parametrize("block_rows", [4, 8, 12, 64, 1024, 4096])
def test_ivf_kernel_matches_plain_version(cuda_device, tier, q, k, block_rows, qdtype):
    """bf16 within TOL with the same row sets; int8/int4 bit-equal rows and
    scores (int8 with the kernel's own quantization of f32 queries); ties
    in row order; empty slots (NEG_INF, 0); one launch per 64 queries."""
    _, kernel, plain = IVF[tier]
    n = IVF_N - IVF_N % block_rows
    qt, xt, extra, bias = ivf_inputs(tier, q, q + k + block_rows, cuda_device, n, qdtype)
    n_blocks = n // block_rows
    ids, nv = ivf_plan(n_blocks, n_blocks, n_blocks // 2, seed=k, device=cuda_device,
                       block_rows=block_rows)
    args = (qt, xt, *extra, bias, ids, nv, k)
    before = kernel.launches
    got = kernel(*args, block_rows=block_rows)
    torch.cuda.synchronize()
    assert kernel.launches == before + -(-q // 64)
    want = plain(*args, block_rows=block_rows)
    assert_ivf_equal(tier, got, want)
    assert got[1][0, : min(k, 5)].tolist() == [3, 101, 102, 103, 104][: min(k, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("tier", list(IVF))
@pytest.mark.parametrize("n_valid", [0, 1, 64])
def test_ivf_kernel_plan_edges(cuda_device, tier, n_valid, order):
    """An empty plan, one block, every block (max_blocks), ids in any
    order; fewer live rows than k; a zero query row (its int8 scale
    1e-12 / 127), whose live rows all score 0 and come in row order."""
    _, kernel, plain = IVF[tier]
    qt, xt, extra, bias = ivf_inputs(tier, 8, n_valid, cuda_device)
    qt[1] = 0
    ids, nv = ivf_plan(64, 64, n_valid, seed=1, device=cuda_device, order=order)
    args = (qt, xt, *extra, bias, ids, nv, 100)
    got = kernel(*args, block_rows=64)
    want = plain(*args, block_rows=64)
    torch.cuda.synchronize()
    assert_ivf_equal(tier, got, want)
    if n_valid == 0:
        assert (got[0] == NEG_INF).all() and (got[1] == 0).all()
    else:
        live = got[0][1] > NEG_INF / 2
        assert (got[0][1][live] == 0).all()
        assert torch.equal(got[1][1][live], torch.sort(got[1][1][live]).values)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", list(IVF))
def test_ivf_kernel_two_streams_at_once(cuda_device, tier):
    """Two calls enqueued on two streams at once, each behind a spin of its
    stream so that they overlap on the card: each has its own counters and
    candidates, and each answers its own queries."""
    _, kernel, plain = IVF[tier]
    runs = []
    for seed in (11, 12):
        qt, xt, extra, bias = ivf_inputs(tier, 8, seed, cuda_device)
        ids, nv = ivf_plan(64, 64, 40, seed=seed, device=cuda_device)
        runs.append((qt, xt, *extra, bias, ids, nv, 10))
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in runs]
    got = []
    for args, st in zip(runs, streams):
        with torch.cuda.stream(st):
            torch.cuda._sleep(1_000_000)
            got.append(kernel(*args, block_rows=64))
    torch.cuda.synchronize()
    for args, res in zip(runs, got):
        assert_ivf_equal(tier, res, plain(*args, block_rows=64))


@pytest.mark.cuda
@pytest.mark.parametrize("tier", list(IVF))
@pytest.mark.parametrize("q", [1, 64, 65, 128, 130])
def test_ivf_kernel_launches_per_query_tile(cuda_device, tier, q):
    """One launch per 64 queries; every tier runs no other kernel than its
    scan (its queries are cast or quantized inside it, and merged there)
    and, past 64 queries, the join of the tiles."""
    _, kernel, plain = IVF[tier]
    qt, xt, extra, bias = ivf_inputs(tier, q, q, cuda_device)
    ids, nv = ivf_plan(64, 64, 32, seed=q, device=cuda_device)
    args = (qt, xt, *extra, bias, ids, nv, 10)
    kernel(*args, block_rows=64)  # builds and loads the library
    torch.cuda.synchronize()
    for _attempt in range(3):  # a profiler window that recorded no device event is run again
        before = kernel.launches
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            got = kernel(*args, block_rows=64)
            torch.cuda.synchronize()
        assert kernel.launches == before + -(-q // 64)
        counts = {e.key: e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "memset" not in e.key.lower() and "memcpy" not in e.key.lower()}
        if counts:
            break
    assert_ivf_equal(tier, got, plain(*args, block_rows=64))
    # the scan kernel once per tile; past one tile the tiles' results are
    # joined (torch.cat), and nothing else runs
    scans = sum(c for name, c in counts.items() if "ivf_tma_kernel" in name)
    others = [name for name in counts if "ivf_tma_kernel" not in name]
    assert scans == -(-q // 64), counts
    assert all("Cat" in name for name in others) and (q > 64 or not others), counts


@pytest.mark.cuda
@pytest.mark.parametrize("tier", list(IVF))
def test_ivf_kernel_rejects_out_of_contract(cuda_device, tier):
    quantize, kernel, plain = IVF[tier]
    qs, x, bias = make_inputs(3, 256, seed=0)
    xt, extra = torch.from_numpy(x).to(cuda_device), ()
    if quantize is None:
        xt = xt.to(torch.bfloat16)
    else:
        xt, xs = quantize(xt)
        extra = (xs,)
    qd, bd = torch.from_numpy(qs).to(cuda_device), torch.from_numpy(bias).to(cuda_device)
    ids, nv = ivf_plan(62, 8, 4, seed=0, device=cuda_device)
    # JAX asks only that block_rows divide the rows: 66 (not a multiple of
    # 4) over 4092 rows, and a bias one element in, answer as the plain
    # version does
    n66 = 66 * 62
    shifted = torch.zeros(n66 + 1, device=cuda_device)[1:]
    shifted.copy_(bd[:n66])
    args = (qd, xt[:n66], *(e[:n66] for e in extra), shifted, ids, nv, 10)
    got = kernel(*args, block_rows=66)
    torch.cuda.synchronize()
    assert_ivf_equal(tier, got, plain(*args, block_rows=66))
    ids, nv = ivf_plan(64, 8, 4, seed=0, device=cuda_device)
    with pytest.raises(ValueError):
        kernel(qd, xt, *extra, bd, ids, nv, 10, block_rows=66)  # does not divide 4096
    with pytest.raises(ValueError):
        kernel(qd, xt, *extra, bd, ids.long(), nv, 10, block_rows=64)
    with pytest.raises(ValueError):
        kernel(qd, xt, *extra, bd, ids, nv.cpu(), 10, block_rows=64)
    with pytest.raises(ValueError):
        kernel(qd, xt, *extra, bd, ids, nv, 0, block_rows=64)


def _offset(t):
    """A copy of ``t`` that starts one element (4 bytes) past a 16-byte boundary."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("tier", list(IVF))
@pytest.mark.parametrize("block_rows", [1, 2, 6, 66, 1026])
def test_ivf_kernel_takes_any_block_rows_and_alignment(cuda_device, tier, block_rows, offset):
    """The three DMA entries at block_rows off 4-row boundaries and with
    bias and scales 4 bytes past a 16-byte boundary, k up to block_rows:
    the plain version's answer (bf16 within TOL, int8/int4 bit-equal)."""
    quantize, kernel, plain = IVF[tier]
    n = block_rows * max(8, 8208 // block_rows)
    qt, xt, extra, bias = ivf_inputs(tier, 9, block_rows, cuda_device, n)
    if offset:
        bias, extra = _offset(bias), tuple(_offset(e) for e in extra)
    n_blocks = n // block_rows
    ids, nv = ivf_plan(n_blocks, n_blocks, n_blocks // 2, seed=block_rows, device=cuda_device,
                       block_rows=block_rows)
    for k in sorted({1, min(10, block_rows), block_rows}):
        args = (qt, xt, *extra, bias, ids, nv, k)
        got = kernel(*args, block_rows=block_rows)
        torch.cuda.synchronize()
        assert_ivf_equal(tier, got, plain(*args, block_rows=block_rows))


C2_WIDTHS = (128, 768, 1024, 2048, 4096, 8192)
C2_KS = (1, 10, 128, 1024, 2048, 4096)
TMA_ENTRIES = {"ivf_topk_bf16": ivf_topk_dma, "ivf_topk_int8": ivf_topk_int8_dma,
               "ivf_topk_int4": ivf_topk_int4_dma, "ivf_blocks_bf16": ivf_topk,
               "ivf_blocks_int8": ivf_topk_int8}


def c2_width(entry, d):
    """int4 takes d % 256 == 0: its d = 128 cell is d = 256."""
    return 256 if entry.endswith("int4") and d == 128 else d


@pytest.mark.cuda
@pytest.mark.parametrize("entry", list(TMA_ENTRIES))
def test_ivf_scan_has_a_plan_for_every_width_and_k(cuda_device, entry):
    """Every (d, k) of the grid has a shared-memory plan and a CTA fits an
    SM (csrc/ivf_scan_tma.cuh, make_plan); at d = 768 the plans the
    adaptive-plan searches use are the narrow ones (int4: 7 stages, two
    CTAs on an SM at the search's k = 64)."""
    from youtu_rag_tpu_torch.ops.ivf import _ctas_per_sm, scan_plan

    for d in (c2_width(entry, d) for d in C2_WIDTHS):
        for k in C2_KS:
            rows, stages, _, wide = scan_plan(entry, d, k)
            assert rows > 0 and stages > 0, (d, k)
            assert _ctas_per_sm(entry, d, k) >= 1, (d, k)
            assert not wide or (entry.endswith("bf16") and d > 4096), (d, k)
    stages = 7 if entry.endswith("int4") else 4
    assert scan_plan(entry, 768, 10)[:2] == (32, stages) and not any(scan_plan(entry, 768, 10)[2:])
    if entry.endswith("int4"):
        assert _ctas_per_sm(entry, 768, 64) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("d, k", [(4096, 1024), (8192, 1024), (8192, 10), (4096, 4096),
                                  (8192, 4096), (2048, 2048), (128, 4096)])
@pytest.mark.parametrize("entry", list(TMA_ENTRIES))
def test_ivf_kernel_answers_wide_rows_and_large_k(cuda_device, entry, d, k):
    """Where the lists or the query tile outgrow shared memory (device
    lists, the wide plan): the plain version's answer on two probed blocks
    of 4096 rows (bf16 within TOL, a row giving way to one whose plain
    score is within TOL; int8 and int4 bit-equal; every slot no live row
    fills as the plain version's)."""
    kernel = TMA_ENTRIES[entry]
    plain = {ivf_topk_dma: ivf_topk_dma_reference, ivf_topk_int8_dma: ivf_topk_int8_dma_reference,
             ivf_topk_int4_dma: ivf_topk_int4_dma_reference, ivf_topk: ivf_topk_reference,
             ivf_topk_int8: ivf_topk_int8_reference}[kernel]
    d = c2_width(entry, d)
    g = torch.Generator(device=cuda_device).manual_seed(d + k)
    n, br = 3 * 4096, 4096
    x = torch.randn(n, d, generator=g, device=cuda_device)
    x /= x.norm(dim=1, keepdim=True)
    qd = torch.randn(9, d, generator=g, device=cuda_device)
    qd /= qd.norm(dim=1, keepdim=True)
    bias = torch.zeros(n, device=cuda_device)
    bias[::5] = NEG_INF
    bias[7::13] = float("-inf")
    if entry.endswith("bf16"):
        xt, extra = x.to(torch.bfloat16), ()
    else:
        xq, xs = (quantize_rows_int4 if entry.endswith("int4") else quantize_rows_int8)(x)
        xt, extra = xq, (xs,)
    ids = torch.tensor([2, 0, 1], dtype=torch.int32, device=cuda_device)
    args = (qd, xt, *extra, bias, ids, torch.tensor(2, dtype=torch.int32, device=cuda_device), k)
    before = kernel.launches
    gs, gi = kernel(*args, block_rows=br)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ws, wi = plain(*args, block_rows=br)
    gs, gi, ws, wi = (a.cpu() for a in (gs, gi, ws, wi))
    assert not torch.isnan(gs).any()
    live = ws > NEG_INF / 2
    assert torch.equal(gs > NEG_INF / 2, live)
    assert torch.equal(gi[~live], wi[~live])
    assert torch.equal(gs[~live].view(torch.int32), ws[~live].view(torch.int32))
    if not entry.endswith("bf16"):
        assert torch.equal(gi, wi) and torch.equal(gs.view(torch.int32), ws.view(torch.int32))
        return
    torch.testing.assert_close(gs[live], ws[live], rtol=0, atol=TOL)
    full = (qd.to(torch.bfloat16).float() @ xt.float().T + bias).cpu()
    swapped = live & (gi != wi)
    rows = torch.arange(gs.shape[0])[:, None].expand(-1, k)
    assert ((full[rows[swapped], gi[swapped].long()] - ws[swapped]).abs() <= TOL).all()


@pytest.mark.cuda
@pytest.mark.parametrize("tier", [("bfloat16", 4.0), ("int8", 4.0), ("int4", 4.0), ("int4", 0.0)],
                         ids=["bf16", "int8", "int4-rerank", "int4-raw"])
def test_cuda_ivf_index_answers_like_cpu_index(cuda_device, tier):
    """The same IVF plan on both devices (tight clusters: the k-means
    assignment is unambiguous), then the same answers through the IVF
    kernel; no brute launch."""
    storage_dtype, mult = tier
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((16, 96)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    embs = np.concatenate([c + 0.05 * rng.standard_normal((64, 96)).astype(np.float32)
                           for c in centers])
    chunks = [Chunk(f"c{i}", f"d{i % 7}", "", i, {"idx": i}) for i in range(len(embs))]
    cfg = IndexConfig(min_capacity=1024, block_rows=64, n_lists=16, n_probe=3, kmeans_iters=6,
                      storage_dtype=storage_dtype, int4_rerank_multiplier=mult)
    gpu, cpu = DeviceVectorIndex(96, cfg, device=cuda_device), DeviceVectorIndex(96, cfg, device="cpu")
    for ix in (gpu, cpu):
        ix.add(chunks, embs)
        ix.build_ivf()
        ix.delete([f"c{i}" for i in range(0, len(embs), 9)])
    for name in ("cluster_block_start", "cluster_block_count"):
        assert torch.equal(getattr(gpu._ivf, name).cpu(), getattr(cpu._ivf, name))
    kernel = {"bfloat16": ivf_topk_dma, "int8": ivf_topk_int8_dma, "int4": ivf_topk_int4_dma}[storage_dtype]
    brute = {"bfloat16": topk_pruned, "int8": topk_int8_pruned, "int4": topk_int4_pruned}[storage_dtype]
    q = centers[:5] + 0.05 * rng.standard_normal((5, 96)).astype(np.float32)
    before, brute_before = kernel.launches, brute.launches
    for filters, top_k in ((None, 10), ({"idx": {"$lt": 300}}, 50)):
        got, want = gpu.search(q, top_k, filters), cpu.search(q, top_k, filters)
        for g, w in zip(got, want):
            np.testing.assert_allclose([s for _, s in g], [s for _, s in w], atol=TOL)
            assert all(a.id == b.id or abs(sa - sb) <= TOL for (a, sa), (b, sb) in zip(g, w))
    assert kernel.launches == before + 2 and brute.launches == brute_before


BLOCKS = {  # name: (quantizer, kernel, plain version, takes a plan)
    "topk": (None, topk, topk_reference, False),
    "topk_int8": (quantize_rows_int8, topk_int8, topk_int8_reference, False),
    "ivf_topk": (None, ivf_topk, ivf_topk_reference, True),
    "ivf_topk_int8": (quantize_rows_int8, ivf_topk_int8, ivf_topk_int8_reference, True),
}


def blocks_bias(kind):
    """make_inputs' mixed bias, or: sparse (three live rows, rows 0-2 -inf,
    the rest NEG_INF), allinf0 (block 0 of 256 rows -inf, the rest mixed)."""
    _, _, bias = make_inputs(1, 128, seed=0)
    if kind == "sparse":
        bias[:] = NEG_INF
        bias[:3] = -np.inf
        bias[[300, 1500, 3000]] = 0.0
    elif kind == "allinf0":
        bias[:256] = -np.inf
    return bias


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mixed", "sparse", "allinf0"])
@pytest.mark.parametrize("k", [1, 10, 129])
@pytest.mark.parametrize("name", list(BLOCKS))
def test_per_block_kernel_matches_plain_version(cuda_device, name, k, kind):
    """Every candidate slot [blocks, q, k_pad]: the fill past the live rows
    and the (NEG_INF, 0) pad past k equal the plain version's bit for bit;
    live slots hold the same rows (bf16: the same set per list, scores
    within TOL; int8: the same order, bit-equal scores)."""
    quantize, kernel, plain, ivf = BLOCKS[name]
    qs, x, _ = make_inputs(8, 256, seed=k)
    bias = torch.from_numpy(blocks_bias(kind)).to(cuda_device)
    xt = torch.from_numpy(x).to(cuda_device)
    extra = ()
    if quantize is None:
        xt = xt.to(torch.bfloat16)
    else:
        xt, xs = quantize(xt)
        extra = (xs,)
    plan = ()
    if ivf:  # 12 of the 16 blocks listed, block 0 first, 9 probed in shuffled order
        ids = [0] + list(np.random.default_rng(k).permutation(np.arange(1, 16))[:11])
        plan = (torch.tensor(ids, dtype=torch.int32, device=cuda_device),
                torch.tensor(9, dtype=torch.int32, device=cuda_device))
    args = (torch.from_numpy(qs).to(cuda_device), xt, *extra, bias, *plan, k)
    before = kernel.launches
    s, i = kernel(*args, block_rows=256, candidates=True)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ws, wi = plain(*args, block_rows=256, candidates=True)
    s, i, ws, wi = (a.cpu() for a in (s, i, ws, wi))
    assert s.shape == ws.shape == (12 if ivf else 16, 8, -(-k // 128) * 128)
    live = ws > NEG_INF / 2
    assert torch.equal(s > NEG_INF / 2, live)
    assert torch.equal(i[~live], wi[~live])
    assert torch.equal(s[~live].view(torch.int32), ws[~live].view(torch.int32))
    if quantize is None:
        assert not live.any() or float((s[live] - ws[live]).abs().max()) <= TOL
        for b in range(s.shape[0]):
            for a in range(8):
                assert set(i[b, a][live[b, a]].tolist()) == set(wi[b, a][live[b, a]].tolist())
    else:
        assert torch.equal(i, wi) and torch.equal(s.view(torch.int32), ws.view(torch.int32))
    got = kernel(*args, block_rows=256)
    want = plain(*args, block_rows=256)
    torch.cuda.synchronize()
    gs, gi, ws, wi = (a.cpu() for a in (*got, *want))
    live = ws > NEG_INF / 2
    assert gs.shape == (8, k) and torch.equal(gs > NEG_INF / 2, live)
    assert torch.equal(gi[~live], wi[~live])  # the merged fill slots


@pytest.mark.cuda
def test_fused_topk_auto_launches_the_kernel_on_a_large_index(cuda_device):
    qs, x, bias = make_inputs(70, 256, seed=5)  # 70 queries: two launches
    args = (torch.from_numpy(qs).to(cuda_device), torch.from_numpy(x).to(cuda_device, torch.bfloat16),
            torch.from_numpy(bias).to(cuda_device), 10)
    before = topk.launches
    s, i = fused_topk(*args)  # N = 4096 >= 4 x 1024
    torch.cuda.synchronize()
    assert topk.launches == before + 2 and s.shape == (70, 10)
    ws, wi = fused_topk(*args, backend="pallas_interpret")
    assert torch.equal(s.cpu() > NEG_INF / 2, ws.cpu() > NEG_INF / 2)
    np.testing.assert_allclose(s.cpu().numpy(), ws.cpu().numpy(), atol=TOL)
    fused_topk(*args, block_rows=2048)  # N < 4 x 2048: the XLA path, no launch
    assert topk.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(BLOCKS))
def test_per_block_kernel_rejects_out_of_contract(cuda_device, name):
    quantize, kernel, _, ivf = BLOCKS[name]
    qs, x, bias = make_inputs(3, 256, seed=0)
    xt, extra = torch.from_numpy(x).to(cuda_device), ()
    if quantize is None:
        xt = xt.to(torch.bfloat16)
    else:
        xt, xs = quantize(xt)
        extra = (xs,)
    qd, bd = torch.from_numpy(qs).to(cuda_device), torch.from_numpy(bias).to(cuda_device)
    ids = torch.arange(4, dtype=torch.int32, device=cuda_device)
    plan = (ids, torch.tensor(2, dtype=torch.int32, device=cuda_device)) if ivf else ()
    with pytest.raises(ValueError):
        kernel(qd, xt, *extra, bd, *plan, 300, block_rows=256)  # k > block_rows
    with pytest.raises(ValueError):
        kernel(qd, xt, *extra, bd, *plan, 10, block_rows=1000)  # does not divide N
    if ivf:
        with pytest.raises(ValueError):
            kernel(qd, xt, *extra, bd, ids, plan[1].cpu(), 10, block_rows=256)


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tier", ["bf16", "int8"])
@pytest.mark.parametrize("case", [*IVF_CASES, *IVF_WIDE_CASES])
def test_ivf_blocks_merged_matches_plain_version(cuda_device, case, tier, qdtype):
    """The merged per-block call (``csrc/ivf_topk.cu``'s ``ivf_blocks_*``
    entries) on the IVF cases the CPU parity tests share, against
    ``ivf_topk*_reference`` on the same card tensors: one launch per 64
    queries; every slot no live row fills (the tail) the same row and score
    bits; live slots the same rows, int8 scores bit-equal, bf16 within TOL
    (a row may give way to one whose plain score is within TOL)."""
    kind, ids, n_valid, block_rows, k, q, n = {**IVF_CASES, **IVF_WIDE_CASES}[case]
    qs, x, bias = ivf_case_inputs(q, 128, n, kind, seed=len(case))
    kernel, plain = (ivf_topk, ivf_topk_reference) if tier == "bf16" else (
        ivf_topk_int8, ivf_topk_int8_reference)
    xt = torch.from_numpy(x).to(cuda_device)
    extra = ()
    if tier == "bf16":
        xt = xt.to(torch.bfloat16)
    else:
        xt, xs = quantize_rows_int8(xt)
        extra = (xs,)
    qd = torch.from_numpy(qs).to(cuda_device, qdtype)
    bd = torch.from_numpy(bias).to(cuda_device)
    args = (qd, xt, *extra, bd, torch.tensor(ids, dtype=torch.int32, device=cuda_device),
            torch.tensor(n_valid, dtype=torch.int32, device=cuda_device), k)
    before = kernel.launches
    gs, gi = kernel(*args, block_rows=block_rows)
    torch.cuda.synchronize()
    assert kernel.launches == before + -(-q // 64)
    ws, wi = plain(*args, block_rows=block_rows)
    gs, gi, ws, wi = (a.cpu() for a in (gs, gi, ws, wi))
    assert gs.shape == gi.shape == (q, k)
    live = ws > NEG_INF / 2
    assert torch.equal(gs > NEG_INF / 2, live)
    assert torch.equal(gi[~live], wi[~live])
    assert torch.equal(gs[~live].view(torch.int32), ws[~live].view(torch.int32))
    if tier == "int8":
        assert torch.equal(gi, wi) and torch.equal(gs.view(torch.int32), ws.view(torch.int32))
        return
    torch.testing.assert_close(gs[live], ws[live], rtol=0, atol=TOL)
    full = (qd.to(torch.bfloat16).float() @ xt.float().T + bd).cpu()
    swapped = live & (gi != wi)
    rows = torch.arange(q)[:, None].expand(q, k)
    assert ((full[rows[swapped], gi[swapped].long()] - ws[swapped]).abs() <= TOL).all()


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_ivf_blocks_merged_reads_unaligned_bias_and_scales(cuda_device, tier):
    """Bias and scales that start off a 16-byte boundary (views at offset 1)
    and block_rows 6: the kernel copies them element by element."""
    qs, x, bias = ivf_case_inputs(8, 128, 1027, "mixed", seed=11)
    kernel, plain = (ivf_topk, ivf_topk_reference) if tier == "bf16" else (
        ivf_topk_int8, ivf_topk_int8_reference)
    xt = torch.from_numpy(x[1:]).to(cuda_device)
    extra = ()
    if tier == "bf16":
        xt = xt.to(torch.bfloat16)
    else:
        xt, xs = quantize_rows_int8(xt)
        extra = (torch.cat([xs[:1], xs])[1:],)  # a view one element in
    bd = torch.from_numpy(bias).to(cuda_device)[1:]
    assert bd.data_ptr() % 16 and all(e.data_ptr() % 16 for e in extra)
    ids = torch.tensor([3, 170, 0, 99, 5], dtype=torch.int32, device=cuda_device)
    args = (torch.from_numpy(qs).to(cuda_device), xt, *extra, bd, ids,
            torch.tensor(4, dtype=torch.int32, device=cuda_device), 6)
    gs, gi = kernel(*args, block_rows=6)
    ws, wi = plain(*args, block_rows=6)
    torch.cuda.synchronize()
    live = ws > NEG_INF / 2
    assert torch.equal(gs > NEG_INF / 2, live) and torch.equal(gi, wi)
    torch.testing.assert_close(gs, ws, rtol=0, atol=0 if tier == "int8" else TOL)


# ---------------------------------------------------------------------------
# the ring hop, any query count, k above 1024, the long-document embedder
# ---------------------------------------------------------------------------


def stats_inputs(b, h, t, t_kv, hd, device, seed, layout="contiguous", kind="mixed",
                 dtype=torch.bfloat16):
    """q [B, H, T, hd], k, v [B, H, T_kv, hd] and the encoder's -1e9 bias
    [B, T_kv]: "mixed" pads row 0 past T_kv/2 + 3 and masks the last batch
    row, "allpad" masks every key; "strided" gives [B, T, H, hd] tensors
    seen as [B, H, T, hd], as the encoder passes them."""
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(rows):
        if layout == "strided":
            return torch.randn(b, rows, h, hd, generator=g, device=device).to(dtype).transpose(1, 2)
        return torch.randn(b, h, rows, hd, generator=g, device=device).to(dtype)

    q, k, v = draw(t), draw(t_kv), draw(t_kv)
    mask = torch.ones(b, t_kv, device=device)
    if kind == "mixed":
        mask[0, t_kv // 2 + 3 :] = 0
        mask[-1] = 0
    else:
        mask[:] = 0
    return q, k, v, (1.0 - mask) * -1e9


def assert_stats_close(got, want, dtype=torch.bfloat16):
    """(acc, m, l) of one hop: m within f32 summation order, l and acc / l
    within the attention tolerance (bf16: one bf16 ulp, the kernel's key
    tiles against JAX's 1024-key blocks)."""
    (acc, m, l), (wa, wm, wl) = got, want
    assert all(torch.isfinite(x).all() for x in (acc, m, l))
    torch.testing.assert_close(m, wm, rtol=1e-6, atol=1e-5)
    rtol = 2**-7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(l, wl, rtol=rtol, atol=0)
    torch.testing.assert_close(acc / l[..., None], wa / wl[..., None], rtol=rtol,
                               atol=2**-10 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mixed", "allpad"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("t, t_kv", [(256, 256), (1024, 512), (512, 2048), (128, 128),
                                     (1024, 128), (128, 1024), (1024, 4096)])
def test_stats_kernel_matches_plain_version(cuda_device, t, t_kv, hd, dtype, kind):
    """(acc, m, l) of one hop (bf16 on the wgmma kernel's stats entry):
    padded keys and a fully masked row, or a span whose every key is
    padding (m near -1e9); one key tile (T_kv = 128, the peeled tile is
    also the last), T above and below T_kv."""
    args = stats_inputs(3, 2, t, t_kv, hd, cuda_device, seed=t + t_kv + hd, kind=kind,
                        dtype=dtype)
    before = flash_attention_stats.launches
    got = flash_attention_stats(*args)
    torch.cuda.synchronize()
    assert flash_attention_stats.launches == before + 1
    assert_stats_close(got, flash_attention_stats_reference(*args), dtype)
    if kind == "allpad":
        assert (got[1] < -9e8).all() and (got[1] > -1.1e9).all()


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
def test_hopper_stats_reads_strided_views(cuda_device, hd):
    """The encoder's [B, T, H, hd] views reach the hop through their
    strides (no copy): the same result as on contiguous copies."""
    q, k, v, bias = stats_inputs(2, 3, 512, 1024, hd, cuda_device, seed=hd, layout="strided")
    assert not q.is_contiguous()
    got = flash_attention_stats(q, k, v, bias)
    dense = flash_attention_stats(q.contiguous(), k.contiguous(), v.contiguous(), bias)
    torch.cuda.synchronize()
    for a, b in zip(got, dense):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert_stats_close(got, flash_attention_stats_reference(q, k, v, bias))


@pytest.mark.cuda
def test_hopper_stats_walks_many_items_per_cta(cuda_device):
    """[32, 12, 1024, 64] against 1024 keys, the ring's hop at T = 4096,
    sp 4: 3,072 work items, about 23 rounds of the persistent grid."""
    args = stats_inputs(32, 12, 1024, 1024, 64, cuda_device, seed=7)
    got = flash_attention_stats(*args)
    torch.cuda.synchronize()
    assert_stats_close(got, flash_attention_stats_reference(*args))


@pytest.mark.cuda
def test_hopper_stats_on_a_side_stream(cuda_device):
    args = stats_inputs(3, 2, 384, 640, 64, cuda_device, seed=3)
    side = torch.cuda.Stream(device=cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        got = flash_attention_stats(*args)
    side.synchronize()
    assert_stats_close(got, flash_attention_stats_reference(*args))


@pytest.mark.cuda
def test_stats_kernel_rejects_out_of_contract(cuda_device):
    q, k, v, bias = attention_inputs(2, 2, 256, 64, torch.bfloat16, cuda_device)
    with pytest.raises(ValueError):
        flash_attention_stats(q, k[:, :, :192], v[:, :, :192], bias[:, :192])
    with pytest.raises(ValueError):
        flash_attention_stats(q[..., :32], k[..., :32], v[..., :32], bias)
    with pytest.raises(ValueError):
        flash_attention_stats(q, k, v, bias.cpu())


def _all_wrappers(device):
    """Every top-k wrapper with its plain version, its arguments (after
    the queries, before k) and keywords, over one 4096-row index."""
    _, x, bias = make_inputs(1, 256, seed=5)
    xd, bd = torch.from_numpy(x).to(device), torch.from_numpy(bias).to(device)
    x8, s8 = quantize_rows_int8(xd)
    x4, s4 = quantize_rows_int4(xd)
    ids, nv = ivf_plan(64, 8, 4, seed=0, device=device)
    blocks = (torch.arange(4, dtype=torch.int32, device=device),
              torch.tensor(2, dtype=torch.int32, device=device))
    xb = xd.to(torch.bfloat16)
    return {
        "topk_pruned": (topk_pruned, topk_pruned_reference, (xb, bd), {}),
        "topk_int8_pruned": (topk_int8_pruned, topk_int8_pruned_reference, (x8, s8, bd), {}),
        "topk_int4_pruned": (topk_int4_pruned, topk_int4_pruned_reference, (x4, s4, bd), {}),
        "ivf_topk_dma": (ivf_topk_dma, ivf_topk_dma_reference, (xb, bd, ids, nv),
                         {"block_rows": 64}),
        "ivf_topk_int8_dma": (ivf_topk_int8_dma, ivf_topk_int8_dma_reference,
                              (x8, s8, bd, ids, nv), {"block_rows": 64}),
        "ivf_topk_int4_dma": (ivf_topk_int4_dma, ivf_topk_int4_dma_reference,
                              (x4, s4, bd, ids, nv), {"block_rows": 64}),
        "topk": (topk, topk_reference, (xb, bd), {"block_rows": 1024}),
        "topk_int8": (topk_int8, topk_int8_reference, (x8, s8, bd), {"block_rows": 1024}),
        "ivf_topk": (ivf_topk, ivf_topk_reference, (xb, bd, *blocks), {"block_rows": 1024}),
        "ivf_topk_int8": (ivf_topk_int8, ivf_topk_int8_reference, (x8, s8, bd, *blocks),
                          {"block_rows": 1024}),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("qn", [0, 100])
@pytest.mark.parametrize("name", ["topk_pruned", "topk_int8_pruned", "topk_int4_pruned",
                                  "ivf_topk_dma", "ivf_topk_int8_dma", "ivf_topk_int4_dma",
                                  "topk", "topk_int8", "ivf_topk", "ivf_topk_int8"])
def test_every_wrapper_takes_any_query_count(cuda_device, name, qn):
    """0 queries: an empty [0, k] result and no launch; 100: two launches
    (64 + 36) and the plain version's live slots."""
    kernel, plain, args, kw = _all_wrappers(cuda_device)[name]
    g = torch.Generator(device=cuda_device).manual_seed(qn)
    queries = torch.randn(qn, 256, generator=g, device=cuda_device)
    queries /= queries.norm(dim=1, keepdim=True).clamp_min(1e-12)
    before = kernel.launches
    s, i = kernel(queries, *args, 10, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + (0 if qn == 0 else 2)
    assert tuple(s.shape) == tuple(i.shape) == (qn, 10)
    ws, _ = plain(queries, *args, 10, **kw)
    live = ws > NEG_INF / 2
    assert torch.equal(s > NEG_INF / 2, live)
    torch.testing.assert_close(s[live], ws[live], rtol=0, atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("tier, k", [("bf16", 2048), ("int8", 8192), ("int4", 2048)])
def test_pruned_kernels_take_k_above_1024(cuda_device, tier, k):
    """The device-memory list class: the plain version's rows (bf16 scores
    within TOL, int8/int4 bit-equal)."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((16384, 256)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    xd = torch.from_numpy(x).to(cuda_device)
    qd = torch.from_numpy(x[:8] + 0.1 * rng.standard_normal((8, 256)).astype(np.float32))
    qd = qd.to(cuda_device)
    bd = torch.zeros(16384, device=cuda_device)
    bd[::9] = NEG_INF
    if tier == "bf16":
        args, kernel, plain = (xd.to(torch.bfloat16), bd), topk_pruned, topk_pruned_reference
    else:
        quantize, kernel, plain = QUANT[tier]
        args = (*quantize(xd), bd)
    s, i = kernel(qd, *args, k)
    torch.cuda.synchronize()
    ws, wi = plain(qd, *args, k)
    if tier == "bf16":
        torch.testing.assert_close(s, ws, rtol=0, atol=TOL)
        for a in range(8):
            assert len(set(i[a].tolist()) ^ set(wi[a].tolist())) <= 2  # a near-tie at the k-th
    else:
        assert torch.equal(i, wi) and torch.equal(s.view(torch.int32), ws.view(torch.int32))


@pytest.mark.cuda
def test_index_answers_top_k_2000_on_the_card_like_the_cpu(cuda_device):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3000, 96)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    hits = []
    for device in (cuda_device, "cpu"):
        idx = DeviceVectorIndex(96, IndexConfig(storage_dtype="int8"), device=device)
        idx.add([Chunk(f"c{i}", "doc", "", i) for i in range(3000)], x)
        hits.append(idx.search(x[:3], top_k=2000))
    assert [len(h) for h in hits[0]] == [2000] * 3
    assert [[c.id for c, _ in h] for h in hits[0]] == [[c.id for c, _ in h] for h in hits[1]]


@pytest.mark.cuda
def test_long_document_embedder_launches_the_hop_kernel(cuda_device):
    """TorchEmbedder(sp_mesh=4) on the card embeds a text past max_len
    whole through flash_attention_stats (Tl >= 256), as its CPU twin does;
    a change in the tail moves the embedding."""
    from youtu_rag_tpu_torch.models.embedder import TorchEmbedder
    from youtu_rag_tpu_torch.models.encoder import EncoderConfig

    cfg = EncoderConfig(d_model=128, n_layers=2, n_heads=2, d_ff=256, out_dim=64, max_len=256,
                        attention_impl="pallas")
    emb = TorchEmbedder(config=cfg, device=cuda_device, sp_mesh=4)
    twin = TorchEmbedder(config=cfg, params=emb.params, device="cpu", sp_mesh=4)
    words = [f"w{i}" for i in range(900)]
    texts = [" ".join(words), " ".join(words[:-5] + ["zebra"] * 5)]
    before = flash_attention_stats.launches
    got = emb.embed_batch(texts)
    torch.cuda.synchronize()
    assert flash_attention_stats.launches - before == cfg.n_layers * 4
    np.testing.assert_allclose(got, twin.embed_batch(texts), atol=3e-2)
    assert np.abs(got[0] - got[1]).max() > 1e-4


@pytest.mark.cuda
def test_long_document_embedder_raises_where_the_hop_kernel_refuses(cuda_device):
    """A head width the kernel does not take (192) raises from the hop
    wrapper; nothing falls back to the plain version."""
    from youtu_rag_tpu_torch.models.embedder import TorchEmbedder
    from youtu_rag_tpu_torch.models.encoder import EncoderConfig

    cfg = EncoderConfig(d_model=384, n_layers=1, n_heads=2, d_ff=256, out_dim=64, max_len=256,
                        attention_impl="pallas")
    emb = TorchEmbedder(config=cfg, device=cuda_device, sp_mesh=4)
    with pytest.raises(ValueError, match="head dim"):
        emb.embed_batch([" ".join(f"w{i}" for i in range(900))])
