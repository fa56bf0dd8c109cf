"""The port's encoder, embedder and tokenizer against the JAX package's, on
the CPU.

The JAX package's parameters are carried across with
``encoder_params_from_numpy``, so both packages compute the same function
on the same numpy inputs. Tolerances:
- f32 ("the algorithm"): embeddings within 1e-5 (unit vectors; 2e-7
  seen), the CLS hidden state within 1e-4 (values up to ~4; 5e-6 seen);
- bf16: embeddings within 3e-2, the JAX package's own bf16 tolerance for
  the encoder (``tests/ops/test_attention.py:41``; 7e-4 seen); the CLS
  hidden state, a bf16 value below 8, within 2^-4 (two bf16 ulps at its
  magnitude): the two frameworks round bf16 at other places (XLA keeps
  some fused elementwise chains in f32, cuBLAS/MKL sum in other orders).
"""

import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import youtu_rag_tpu.models.tokenizer as jax_tokenizer_mod
from youtu_rag_tpu.core.config import EmbeddingConfig as JaxEmbeddingConfig
from youtu_rag_tpu.models import encoder as jax_encoder
from youtu_rag_tpu.models.embedder import EmbedderFactory as JaxEmbedderFactory
from youtu_rag_tpu.models.embedder import TpuEmbedder
from youtu_rag_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from youtu_rag_tpu_torch.core.config import EmbeddingConfig
from youtu_rag_tpu_torch.models import encoder as port_encoder
from youtu_rag_tpu_torch.models.convert import encoder_params_from_numpy
from youtu_rag_tpu_torch.models.embedder import EmbedderFactory, TorchEmbedder
from youtu_rag_tpu_torch.models.tokenizer import HashTokenizer
from torch_native_helpers import jax_tracer_restored  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("jax_tracer_restored")

WEIGHTS = pathlib.Path(__file__).parents[1] / "benchmarks" / "models" / "yrt_tiny_lex"
SMALL = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=2, d_ff=256, max_len=512, out_dim=32)
VARIANTS = {
    "plain": {},
    "lex_proj": {"lex_pool": True},
    "lex_buckets": {"lex_pool": True, "lex_buckets": 64},
}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
IDENTIFIER_DOCS = [  # tests/models/test_weights_dir.py:34-45
    "Maintenance log for unit KL-4407. The inventory tag recorded for "
    "unit KL-4407 is 88213.",
    "Maintenance log for unit QX-9911. The inventory tag recorded for "
    "unit QX-9911 is 55120.",
    "An unrelated paragraph about glacier hydrology field surveys.",
]
IDENTIFIER_QUERY = "What is the inventory tag recorded for KL-4407?"


def configs(variant="plain", dtype="float32", impl="xla", **over):
    kw = {**SMALL, **VARIANTS[variant], "attention_impl": impl, **over}
    jdt, tdt = DTYPES[dtype]
    return jax_encoder.EncoderConfig(**kw, dtype=jdt), port_encoder.EncoderConfig(**kw, dtype=tdt)


def carried_params(jcfg, tcfg, seed=1):
    """JAX's initial parameters plus numpy noise (so the LayerNorms, the
    FFN biases and the lexical weights all matter), in both packages."""
    tree = jax.tree.map(np.asarray, jax_encoder.init_encoder_params(jcfg, seed=seed))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda a: (a + rng.normal(scale=0.1, size=a.shape)).astype(np.float32), tree)
    return jax.tree.map(jnp.asarray, tree), encoder_params_from_numpy(tree, tcfg)


def assert_outputs_close(got, want, dtype):
    (emb, cls), (jemb, jcls) = got, want
    assert emb.dtype == torch.float32 and emb.shape == jemb.shape
    emb_tol, cls_tol = (1e-5, 1e-4) if dtype == "float32" else (3e-2, 2**-4)
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), rtol=0, atol=emb_tol)
    np.testing.assert_allclose(cls.numpy(), np.asarray(jcls), rtol=0, atol=cls_tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_encode_tokens_matches_jax(variant, impl, t, dtype):
    """T = 128 takes plain attention in both packages; T = 256 with
    "pallas_interpret" takes the blockwise kernel's plain version (the port)
    and the interpret-mode Pallas kernel (JAX). Row 1 is padded, row 2 is
    all padding (a padded batch row)."""
    jcfg, tcfg = configs(variant, dtype, impl)
    jparams, tparams = carried_params(jcfg, tcfg)
    rng = np.random.default_rng(t)
    ids = rng.integers(4, SMALL["vocab_size"], (3, t)).astype(np.int32)
    mask = (np.arange(t)[None, :] < np.array([[t], [t // 2 + 5], [0]])).astype(np.float32)
    want = jax_encoder.encode_tokens(jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg)
    got = port_encoder.encode_tokens(tparams, torch.from_numpy(ids), torch.from_numpy(mask), tcfg)
    assert_outputs_close(got, want, dtype)
    assert torch.isfinite(got[0]).all()


class Spy:
    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, q, k, v, bias):
        self.calls.append(q.shape[2])
        return self.fn(q, k, v, bias)


@pytest.mark.parametrize("impl, t, used", [
    ("xla", 256, None),
    ("pallas", 128, None),  # below 256: plain attention
    ("pallas", 384, "blockwise_attention"),
    ("pallas", 4096, "blockwise_attention"),
    ("pallas", 4224, "flash_attention"),  # above 4096
    ("flash", 256, "flash_attention"),
    ("pallas_interpret", 256, "blockwise_attention_reference"),
    ("pallas_interpret", 4224, "blockwise_attention_reference"),  # interpret: always blockwise
])
def test_attention_dispatch_follows_jax(monkeypatch, impl, t, used):
    spies = {}
    for name in ("blockwise_attention", "flash_attention", "blockwise_attention_reference"):
        spies[name] = Spy(getattr(port_encoder, name))
        monkeypatch.setattr(port_encoder, name, spies[name])
    _, tcfg = configs(impl=impl, max_len=8192)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 1, t, 64)).astype(np.float32))
               for _ in range(3))
    out = port_encoder._attention_core(q, k, v, torch.ones(1, t), tcfg)
    assert out.shape == q.shape
    assert {n: s.calls for n, s in spies.items() if s.calls} == ({used: [t]} if used else {})


def test_head_dim_off_the_kernel_grid_takes_plain_attention(monkeypatch):
    """hd % 64 != 0 takes the plain path by the dispatch rule (hd 32 here)."""
    spy = Spy(port_encoder.blockwise_attention)
    monkeypatch.setattr(port_encoder, "blockwise_attention", spy)
    jcfg, tcfg = configs(impl="pallas", n_heads=4)
    jcfg = dataclasses.replace(jcfg, attention_impl="xla")
    jparams, tparams = carried_params(jcfg, tcfg)
    ids = np.random.default_rng(2).integers(4, 512, (2, 256)).astype(np.int32)
    mask = np.ones((2, 256), np.float32)
    want = jax_encoder.encode_tokens(jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg)
    got = port_encoder.encode_tokens(tparams, torch.from_numpy(ids), torch.from_numpy(mask), tcfg)
    assert spy.calls == []
    assert_outputs_close(got, want, "float32")


def test_config_round_trips_across_packages(tmp_path):
    jcfg, tcfg = configs("lex_buckets", "bfloat16", "pallas")
    jax_encoder.save_encoder_config(jcfg, tmp_path / "j.json")
    port_encoder.save_encoder_config(tcfg, tmp_path / "p.json")
    assert json.loads((tmp_path / "j.json").read_text()) == json.loads((tmp_path / "p.json").read_text())
    assert port_encoder.load_encoder_config(tmp_path / "j.json") == tcfg
    assert jax_encoder.load_encoder_config(tmp_path / "p.json") == jcfg
    committed = port_encoder.load_encoder_config(WEIGHTS / "encoder_config.json")
    assert committed.dtype == torch.bfloat16 and committed.attention_impl == "xla"
    assert committed.embed_dim == 128 + 1024


def test_params_npz_round_trips_across_packages(tmp_path):
    jcfg, tcfg = configs("lex_proj")
    jparams, tparams = carried_params(jcfg, tcfg)
    jax_encoder.save_params_npz(jparams, tmp_path / "j.npz")
    port_encoder.save_params_npz(tparams, tmp_path / "p.npz")
    from_jax = port_encoder.load_params_npz(tmp_path / "j.npz")
    from_port = jax_encoder.load_params_npz(tmp_path / "p.npz")
    flat_j = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jparams))[0]
    assert len(flat_j) == len(jax.tree.leaves(from_port))
    for path, want in flat_j:
        keys = [p.key for p in path]
        got_t, got_j = from_jax, from_port
        for key in keys:
            got_t, got_j = got_t[key], got_j[key]
        np.testing.assert_array_equal(got_t.numpy(), want)
        np.testing.assert_array_equal(np.asarray(got_j), want)


def test_init_has_the_jax_tree_and_is_seeded():
    for variant in VARIANTS:
        jcfg, tcfg = configs(variant)
        jtree = jax.tree.map(np.asarray, jax_encoder.init_encoder_params(jcfg))
        ours = port_encoder.init_encoder_params(tcfg, torch.Generator().manual_seed(3))
        assert (jax.tree.map(np.shape, jtree)
                == jax.tree.map(lambda t: tuple(t.shape), ours))
        again = port_encoder.init_encoder_params(tcfg, torch.Generator().manual_seed(3))
        assert torch.equal(ours["tok_emb"], again["tok_emb"])
        # the port's own tree loads through the converter unchanged
        encoder_params_from_numpy(jax.tree.map(lambda t: t.numpy(), ours), tcfg)


def test_converter_rejects_a_tree_the_config_does_not_give():
    jcfg, tcfg = configs()
    tree = jax.tree.map(np.asarray, jax_encoder.init_encoder_params(jcfg))
    with pytest.raises(ValueError, match="layers/w1 has shape"):
        encoder_params_from_numpy(tree, dataclasses.replace(tcfg, d_ff=128))
    del tree["out_proj"]
    with pytest.raises(ValueError, match="out_proj is missing"):
        encoder_params_from_numpy(tree, tcfg)


def test_bert_arch_waits_for_a_later_slice():
    """The bert arch has landed (``tests/test_torch_pretrained.py`` holds it
    against the JAX package): a seeded bert trunk has the JAX tree's shapes
    and encodes; an arch neither package knows raises."""
    cfg = port_encoder.EncoderConfig(arch="bert", **SMALL)
    params = port_encoder.init_encoder_params(cfg, torch.Generator().manual_seed(0))
    jtree = jax_encoder.init_encoder_params(jax_encoder.EncoderConfig(arch="bert", **SMALL))
    assert jax.tree.map(np.shape, jtree) == jax.tree.map(lambda t: tuple(t.shape), params)
    emb, cls = port_encoder.encode_tokens(params, torch.zeros(1, 4, dtype=torch.int32),
                                          torch.ones(1, 4), cfg)
    assert emb.shape == cls.shape == (1, SMALL["d_model"])  # no out_proj: the pooled width
    with pytest.raises(ValueError, match="arch"):
        port_encoder.init_encoder_params(dataclasses.replace(cfg, arch="t5"))


TEXTS = [
    "what bandwidth does v5e HBM have?",
    "ünïcödé 中文 tokens!",
    "",
    " ".join(f"w{i % 97}" for i in range(200)),  # the T = 256 bucket
    " ".join(f"v{i % 89}" for i in range(400)),  # the T = 512 bucket
    " ".join(f"u{i}" for i in range(700)),  # truncated to max_len
] + IDENTIFIER_DOCS


@pytest.mark.parametrize("native", [True, False], ids=["jax-native", "jax-python"])
def test_tokenizer_matches_jax(monkeypatch, native):
    monkeypatch.setattr(jax_tokenizer_mod, "_USE_NATIVE", native)
    jt, pt = JaxHashTokenizer(32768, 512), HashTokenizer(32768, 512)
    for got, want in zip(pt.batch(TEXTS), jt.batch(TEXTS)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(pt.batch(TEXTS, max_length=64, pad_to=80), jt.batch(TEXTS, 64, 80)):
        np.testing.assert_array_equal(got, want)
    for a, b in zip(TEXTS, TEXTS[1:] + TEXTS[:1]):
        assert pt.encode_pair(a, b) == jt.encode_pair(a, b)
        assert pt.encode_pair(a, b, max_length=40) == jt.encode_pair(a, b, max_length=40)
        assert pt.encode(a, 16) == jt.encode(a, 16)


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_embedder_matches_tpu_embedder(impl):
    """The same texts through ``TorchEmbedder`` and ``TpuEmbedder`` with
    the same f32 parameters: the length buckets (16..512), the batch
    buckets (at least 8, batch_size 4 splits the texts) and the truncation
    agree."""
    jcfg, tcfg = configs("lex_buckets", "float32", impl)
    jparams, tparams = carried_params(jcfg, tcfg)
    want = TpuEmbedder(config=jcfg, params=jparams, batch_size=4).embed_batch(TEXTS)
    emb = TorchEmbedder(config=tcfg, params=tparams, batch_size=4, device="cpu")
    got = emb.embed_batch(TEXTS)
    assert got.shape == (len(TEXTS), tcfg.embed_dim) and emb.dimension == tcfg.embed_dim
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def yrt_embedders():
    jax_emb = JaxEmbedderFactory.create(
        JaxEmbeddingConfig(provider="tpu", weights_dir=str(WEIGHTS), batch_size=8))
    port_emb = EmbedderFactory.create(
        EmbeddingConfig(provider="tpu", weights_dir=str(WEIGHTS), batch_size=8), device="cpu")
    return jax_emb, port_emb


def test_committed_model_matches_jax(yrt_embedders):
    jax_emb, port_emb = yrt_embedders
    assert isinstance(port_emb, TorchEmbedder) and port_emb.device.type == "cpu"
    assert port_emb.cfg.attention_impl == "xla" and port_emb.dimension == jax_emb.dimension == 1152
    texts = TEXTS + [IDENTIFIER_QUERY]
    got = port_emb.embed_batch(texts)
    np.testing.assert_allclose(got, jax_emb.embed_batch(texts), rtol=0, atol=3e-2)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_committed_model_ranks_the_exact_identifier(yrt_embedders, impl):
    """tests/models/test_weights_dir.py's ranking, on the port, as the
    config says (xla) and through the kernels' dispatch ("pallas": on the
    CPU the blockwise plain version at T >= 256)."""
    _, port_emb = yrt_embedders
    emb = TorchEmbedder(config=dataclasses.replace(port_emb.cfg, attention_impl=impl),
                        params=port_emb.params, device="cpu")
    vecs = emb.embed_batch(IDENTIFIER_DOCS + [IDENTIFIER_QUERY])
    scores = vecs[:3] @ vecs[3]
    assert scores[0] > scores[1] > scores[2]


def test_weights_dir_with_a_vocabulary_waits_for_wordpiece(tmp_path):
    """WordPiece has landed: a weights dir with a vocab.txt tokenizes with it
    (``tests/test_torch_pretrained.py`` holds the embeddings against JAX)."""
    from youtu_rag_tpu_torch.models.wordpiece import WordPieceTokenizer

    jcfg, tcfg = configs(vocab_size=16)
    jax_encoder.save_params_npz(jax_encoder.init_encoder_params(jcfg), tmp_path / "encoder_params.npz")
    jax_encoder.save_encoder_config(jcfg, tmp_path / "encoder_config.json")
    (tmp_path / "vocab.txt").write_text("[PAD]\n[UNK]\n[CLS]\n[SEP]\nfox\n")
    emb = TorchEmbedder.from_weights_dir(tmp_path, device="cpu")
    assert isinstance(emb.tokenizer, WordPieceTokenizer) and emb.cfg == tcfg
    assert emb.tokenizer.encode("fox wolf") == [2, 4, 1, 3]


def test_default_embedder_is_the_full_width_encoder():
    emb = TorchEmbedder(device="cpu")
    assert emb.cfg == port_encoder.EncoderConfig(attention_impl="xla")  # the CPU default
    assert emb.cfg.d_model == 768 and emb.cfg.n_layers == 12 and emb.dimension == 768
    assert emb.params["layers"]["w1"].shape == (12, 768, 3072)
    vec = emb.embed_batch(["one short text"])
    assert vec.shape == (1, 768) and abs(float(np.linalg.norm(vec)) - 1.0) < 1e-5
