"""The port's long-document path (``TorchEmbedder(sp_mesh=...)``) against
the JAX package's ``TpuEmbedder(sp_mesh=get_mesh({"sp": 4}))``, on the CPU.

The three cases of ``tests/models/test_embedder_long.py`` on the port, and
parity with JAX on the same texts and parameters: both tokenize alike
(the port's ``HashTokenizer`` is a copy of JAX's), bucket alike and run
the same ring; f32 embeddings agree within 2e-5 (JAX's own tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youtu_rag_tpu.models.embedder import TpuEmbedder
from youtu_rag_tpu.models.encoder import EncoderConfig as JaxConfig
from youtu_rag_tpu.parallel.mesh import get_mesh
from youtu_rag_tpu_torch.models.convert import encoder_params_from_numpy
from youtu_rag_tpu_torch.models.embedder import TorchEmbedder
from youtu_rag_tpu_torch.models.encoder import EncoderConfig, encode_tokens
from torch_native_helpers import jax_tracer_restored  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("jax_tracer_restored")

KW = dict(vocab_size=4096, d_model=32, n_layers=2, n_heads=4, d_ff=64, max_len=32, out_dim=16)
CFG = EncoderConfig(**KW, dtype=torch.float32)
TOL = 2e-5


def _words(n, seed=0):
    rng = np.random.default_rng(seed)
    return " ".join(f"w{rng.integers(0, 500)}" for _ in range(n))


def twins(seed: int):
    """JAX's long-path embedder and the port's on its parameters (CPU)."""
    jax_emb = TpuEmbedder(config=JaxConfig(**KW, dtype=jnp.float32),
                          sp_mesh=get_mesh({"sp": 4}), seed=seed)
    params = encoder_params_from_numpy(jax.tree.map(np.asarray, jax_emb.params), CFG)
    return jax_emb, TorchEmbedder(config=CFG, params=params, device="cpu", sp_mesh=4)


def test_long_text_routes_through_sp_and_keeps_tail_content():
    jax_emb, emb_sp = twins(0)
    emb_plain = TorchEmbedder(config=CFG, params=emb_sp.params, device="cpu")

    short = _words(8)
    long = _words(120)  # 120 tokens ≫ max_len 32
    long_tail_changed = long[:-12] + " zebra unique"

    # short texts agree between the two embedders (same params, same path)
    np.testing.assert_allclose(emb_sp.embed_batch([short]), emb_plain.embed_batch([short]),
                               atol=1e-5)
    v_long = emb_sp.embed_batch([long])[0]
    v_tail = emb_sp.embed_batch([long_tail_changed])[0]
    # tail content past max_len moves the SP embedding…
    assert np.abs(v_long - v_tail).max() > 1e-6
    # …but not the truncated plain embedding
    np.testing.assert_allclose(emb_plain.embed_batch([long])[0],
                               emb_plain.embed_batch([long_tail_changed])[0], atol=1e-6)
    np.testing.assert_allclose(v_tail, jax_emb.embed_batch([long_tail_changed])[0], atol=TOL)


def test_long_path_matches_unsharded_full_length():
    jax_emb, emb_sp = twins(1)
    long = _words(100, seed=3)
    got = emb_sp.embed_batch([long])[0]

    seqs = [emb_sp.tokenizer.encode(long, emb_sp._long_max)]
    t_b = emb_sp._bucket(len(seqs[0]), 64)
    ids = np.zeros((1, t_b), np.int64)
    mask = np.zeros((1, t_b), np.float32)
    ids[0, : len(seqs[0])] = seqs[0]
    mask[0, : len(seqs[0])] = 1.0
    want, _ = encode_tokens(emb_sp.params, torch.from_numpy(ids), torch.from_numpy(mask), CFG)
    np.testing.assert_allclose(got, want[0].numpy(), atol=TOL)
    np.testing.assert_allclose(got, jax_emb.embed_batch([long])[0], atol=TOL)


def test_mixed_batch_preserves_row_order():
    jax_emb, emb = twins(2)
    texts = [_words(6, 1), _words(90, 2), _words(7, 3)]
    mixed = emb.embed_batch(texts)
    solo = np.stack([emb.embed_batch([t])[0] for t in texts])
    np.testing.assert_allclose(mixed, solo, atol=1e-5)
    assert mixed.shape == (3, CFG.out_dim)
    np.testing.assert_allclose(mixed, jax_emb.embed_batch(texts), atol=TOL)


@pytest.mark.parametrize("batch_size", [8, 128])
def test_long_waves_and_buckets_match_jax(batch_size):
    """Several long texts of different lengths, in waves of
    max(batch_size // 8, 1), beside short ones, and a text past
    ``long_max_len`` (cut there, as in JAX)."""
    jax_emb, emb = twins(3)
    jax_emb.batch_size = emb.batch_size = batch_size
    texts = [_words(n, seed=n) for n in (40, 5, 70, 130, 300, 12, 64)]
    got = emb.embed_batch(texts)
    np.testing.assert_allclose(got, jax_emb.embed_batch(texts), atol=TOL)
    assert emb._long_max == jax_emb._long_max == 8 * KW["max_len"]


def test_sp_mesh_with_plain_attention_and_bf16_on_the_cpu():
    """The config's defaults (bf16, attention_impl "xla"): the long path
    runs the plain ring, stops at ``long_max_len``, and returns unit
    vectors."""
    emb = TorchEmbedder(config=EncoderConfig(**KW), device="cpu", sp_mesh=4, long_max_len=96)
    out = emb.embed_batch([_words(80), _words(4)])
    assert out.shape == (2, KW["out_dim"]) and np.isfinite(out).all()
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-3)


def test_long_path_raises_where_the_hop_kernel_refuses():
    """The hop wrapper checks its range on every device: a head width the
    kernel does not take (192, Tl >= 256) raises on the CPU as on the card,
    rather than falling back to the plain ring."""
    cfg = EncoderConfig(vocab_size=4096, d_model=384, n_layers=1, n_heads=2, d_ff=64,
                        max_len=256, out_dim=16, dtype=torch.float32, attention_impl="pallas")
    emb = TorchEmbedder(config=cfg, device="cpu", sp_mesh=4)
    with pytest.raises(ValueError, match="head dim"):
        emb.embed_batch([_words(900)])
