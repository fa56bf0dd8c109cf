"""Pretrained BERT-family checkpoints through the port, against the JAX
package, on the CPU: the safetensors reader, ``convert_bert_params``,
``load_pretrained_encoder``, the bert trunk (``encode_tokens``,
``rerank_scores``), ``TorchEmbedder.from_pretrained`` / ``from_weights_dir``
and a KB served from a ``pretrained_dir``.

Checkpoints are tiny (hidden 32, 2 layers; hidden 64 with one head of 64
where the attention kernel's branch must be taken), written by
``transformers`` as ``tests/models/test_pretrained.py`` writes them, or by
``tests/torch_bert_checkpoint.py``'s numpy writer. Tolerances:
- loading: arrays equal (bf16 checkpoints widen exactly to f32);
- f32 forward: embeddings within 1e-5 of the JAX package's (unit vectors;
  sums in another order), scores and CLS states within 1e-4 (values up to
  ~4), and within 1e-4 of ``transformers`` (the JAX package's own gate);
- bf16 forward: embeddings within 3e-2, the JAX package's bf16 encoder
  tolerance (``tests/test_torch_encoder.py``): the two frameworks round
  bf16 at other places.
"""

import asyncio
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youtu_rag_tpu.core.config import EmbeddingConfig as JaxEmbeddingConfig
from youtu_rag_tpu.core.config import RAGConfig as JaxRAGConfig
from youtu_rag_tpu.models import encoder as jax_encoder
from youtu_rag_tpu.models import pretrained as jax_pretrained
from youtu_rag_tpu.models.embedder import TpuEmbedder
from youtu_rag_tpu.retrieval.kb import KnowledgeBase as JaxKnowledgeBase
from youtu_rag_tpu_torch.core.config import EmbeddingConfig, RAGConfig
from youtu_rag_tpu_torch.core.types import Document
from youtu_rag_tpu_torch.models import encoder as port_encoder
from youtu_rag_tpu_torch.models import pretrained as port_pretrained
from youtu_rag_tpu_torch.models.convert import encoder_params_from_numpy
from youtu_rag_tpu_torch.models.embedder import EmbedderFactory, TorchEmbedder
from youtu_rag_tpu_torch.models.wordpiece import WordPieceTokenizer
from youtu_rag_tpu_torch.retrieval.kb import KnowledgeBase

sys.path.insert(0, os.path.dirname(__file__))
from torch_bert_checkpoint import VOCAB, write_bert_dir, write_safetensors  # noqa: E402

F32_EMB, F32_SCORE, BF16_EMB = 1e-5, 1e-4, 3e-2


def hf_dir(tmp_path, num_labels=None, seed=0, name=None, **over):
    """A tiny random HF BERT checkpoint saved by ``transformers`` (safetensors)
    with the test vocabulary; returns (dir, model)."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(seed)
    kw = dict(vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=64, max_position_embeddings=64, type_vocab_size=2,
              hidden_act="gelu", layer_norm_eps=1e-12)
    kw.update(over)
    cfg = transformers.BertConfig(**kw)
    if num_labels is None:
        model = transformers.BertModel(cfg)
    else:
        cfg.num_labels = num_labels
        model = transformers.BertForSequenceClassification(cfg)
    model.eval()
    d = tmp_path / (name or ("reranker" if num_labels else "encoder"))
    model.save_pretrained(str(d), safe_serialization=True)
    (d / "vocab.txt").write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    return d, model


def both_trees(d, dtype="float32", **kw):
    """(JAX params, JAX cfg, port params, port cfg) of one checkpoint."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jp, jcfg, _ = jax_pretrained.load_pretrained_encoder(d, dtype=jdt, **kw)
    tree, tcfg, _ = port_pretrained.load_pretrained_encoder(d, dtype=tdt, **kw)
    return jp, jcfg, encoder_params_from_numpy(tree, tcfg), tcfg


def inputs(rng, b, t, pad_row=1, pad_from=None):
    ids = rng.integers(5, len(VOCAB), size=(b, t)).astype(np.int32)
    mask = np.ones((b, t), np.float32)
    if pad_from is not None:
        mask[pad_row, pad_from:] = 0.0
        ids[pad_row, pad_from:] = 0
    return ids, mask


# ---------------------------------------------------------------------------
# the reader and the converter
# ---------------------------------------------------------------------------


def assert_same_arrays(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k], np.float32), err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_safetensors_reader_matches_jax(tmp_path, dtype):
    d, model = hf_dir(tmp_path, num_labels=1, seed=1)
    model.to(getattr(torch, dtype)).save_pretrained(str(d), safe_serialization=True)
    got = port_pretrained.load_safetensors(d / "model.safetensors")
    assert all(v.dtype == np.float32 for v in got.values())
    assert_same_arrays(got, jax_pretrained.load_safetensors(d / "model.safetensors"))
    sd = model.state_dict()
    for k, v in got.items():  # bf16 and f16 widen exactly
        np.testing.assert_array_equal(v, sd[k].float().numpy(), err_msg=k)


@pytest.mark.parametrize("layout", ["sharded", "pytorch_model.bin", "numpy-writer-bf16"])
def test_raw_weights_layouts_match_jax(tmp_path, layout):
    d, model = hf_dir(tmp_path, seed=2)
    if layout == "sharded":
        (d / "model.safetensors").unlink()
        model.save_pretrained(str(d), safe_serialization=True, max_shard_size="20KB")
        assert (d / "model.safetensors.index.json").exists()
    elif layout == "pytorch_model.bin":
        (d / "model.safetensors").unlink()
        torch.save(model.state_dict(), d / "pytorch_model.bin")
    else:
        sd = {k: v.numpy() for k, v in model.state_dict().items()}
        write_safetensors(d / "model.safetensors", sd, "BF16")
    got = port_pretrained._load_raw_weights(d)
    assert_same_arrays(got, jax_pretrained._load_raw_weights(d))
    p_tree = port_pretrained.convert_bert_params(got)
    j_tree = jax_pretrained.convert_bert_params(jax_pretrained._load_raw_weights(d))
    assert_same_arrays(p_tree["layers"], j_tree["layers"])


@pytest.mark.parametrize("num_labels", [None, 1, 2])
@pytest.mark.parametrize("prefix", ["", "model."])
def test_convert_bert_params_matches_jax(tmp_path, num_labels, prefix):
    d, model = hf_dir(tmp_path, num_labels=num_labels, seed=3)
    raw = {prefix + k.removeprefix("bert."): v.numpy() for k, v in model.state_dict().items()}
    got = port_pretrained.convert_bert_params(raw)
    want = jax_pretrained.convert_bert_params(raw)
    assert_same_arrays(got["layers"], want["layers"])
    assert_same_arrays({k: v for k, v in got.items() if k != "layers"},
                       {k: v for k, v in want.items() if k != "layers"})
    assert ("score_head" in got) == (num_labels is not None)


def test_convert_bert_params_refusals(tmp_path):
    d, model = hf_dir(tmp_path, num_labels=5, seed=4)
    raw = {k: v.numpy() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="labels"):
        port_pretrained.convert_bert_params(raw)
    with pytest.raises(ValueError, match="labels"):
        port_pretrained.load_pretrained_encoder(d)
    with pytest.raises((KeyError, ValueError)):
        port_pretrained.convert_bert_params({"transformer.h.0.attn.weight": np.zeros((4, 4))})
    del raw["bert.encoder.layer.1.output.dense.bias"]
    with pytest.raises(KeyError, match="layer.1.output.dense.bias"):
        port_pretrained.convert_bert_params(raw)
    with pytest.raises(FileNotFoundError):
        port_pretrained._load_raw_weights(tmp_path)


def test_load_pretrained_encoder_matches_jax(tmp_path):
    d, _ = hf_dir(tmp_path, seed=5)
    (d / "1_Pooling").mkdir()
    (d / "1_Pooling" / "config.json").write_text(json.dumps({"pooling_mode_mean_tokens": True}))
    _, jcfg, jtok = jax_pretrained.load_pretrained_encoder(d, max_len=48)
    tree, tcfg, ttok = port_pretrained.load_pretrained_encoder(d, max_len=48)
    want = dataclasses.asdict(jcfg)
    got = dataclasses.asdict(tcfg)
    assert got.pop("dtype") == torch.bfloat16 and want.pop("dtype") == jnp.bfloat16
    assert got == want and tcfg.pooling == "mean" and tcfg.max_len == 48
    assert isinstance(ttok, WordPieceTokenizer) and ttok.max_length == jtok.max_length == 48
    assert ttok.encode("The quick fox, 中国") == jtok.encode("The quick fox, 中国")
    assert tree["pos_emb"].shape == (64, 32)  # the whole table; max_len only bounds T


# ---------------------------------------------------------------------------
# the bert trunk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("types", [False, True], ids=["no-types", "types"])
@pytest.mark.parametrize("pooling", ["cls", "mean"])
def test_bert_encode_matches_jax_and_transformers(tmp_path, pooling, types):
    d, model = hf_dir(tmp_path, seed=6)
    jp, jcfg, tp, tcfg = both_trees(d, pooling=pooling)
    ids, mask = inputs(np.random.default_rng(6), 3, 12, pad_from=7)
    tt = np.zeros_like(ids)
    if types:
        tt[:, 5:] = 1
    kw_j = {"type_ids": jnp.asarray(tt)} if types else {}
    kw_t = {"type_ids": torch.from_numpy(tt)} if types else {}
    want_emb, want_cls = jax_encoder.encode_tokens(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                                                   **kw_j)
    emb, cls = port_encoder.encode_tokens(tp, torch.from_numpy(ids), torch.from_numpy(mask), tcfg,
                                          **kw_t)
    np.testing.assert_allclose(emb.numpy(), np.asarray(want_emb), rtol=0, atol=F32_EMB)
    np.testing.assert_allclose(cls.numpy(), np.asarray(want_cls), rtol=0, atol=F32_SCORE)
    with torch.no_grad():
        hidden = model(input_ids=torch.from_numpy(ids).long(),
                       attention_mask=torch.from_numpy(mask).long(),
                       token_type_ids=torch.from_numpy(tt).long()).last_hidden_state.numpy()
    np.testing.assert_allclose(cls.numpy(), hidden[:, 0], rtol=0, atol=F32_SCORE)


@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_attention_dispatch_matches_jax(tmp_path, dtype, impl):
    """hd 64 at T = 256: the attention kernels' branch of ``_attention_core``
    (on the CPU the port runs the blockwise plain version for "pallas" and
    "pallas_interpret"; JAX its interpret-mode kernel for
    "pallas_interpret"), with a padded row and a fully padded one."""
    d, _ = hf_dir(tmp_path, seed=7, hidden_size=64, num_attention_heads=1,
                  intermediate_size=128, max_position_embeddings=256)
    jp, jcfg, tp, tcfg = both_trees(d, dtype)
    jcfg = dataclasses.replace(jcfg, attention_impl="xla" if impl == "pallas" else impl)
    tcfg = dataclasses.replace(tcfg, attention_impl=impl)
    ids, mask = inputs(np.random.default_rng(7), 3, 256, pad_from=180)
    mask[2] = 0.0
    want, _ = jax_encoder.encode_tokens(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg)
    got, _ = port_encoder.encode_tokens(tp, torch.from_numpy(ids), torch.from_numpy(mask), tcfg)
    assert torch.isfinite(got).all()
    tol = F32_EMB if dtype == "float32" else BF16_EMB
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


def test_bert_over_length_raises(tmp_path):
    d, _ = hf_dir(tmp_path, seed=8)
    _, _, tp, tcfg = both_trees(d)
    ids = torch.zeros((1, 100), dtype=torch.int32)  # max_position_embeddings = 64
    with pytest.raises(ValueError, match="position table"):
        port_encoder.encode_tokens(tp, ids, torch.ones(1, 100), tcfg)


@pytest.mark.parametrize("num_labels", [1, 2])
def test_rerank_scores_match_jax_and_transformers(tmp_path, num_labels):
    d, model = hf_dir(tmp_path, num_labels=num_labels, seed=9)
    jp, jcfg, tp, tcfg = both_trees(d)
    ids, mask = inputs(np.random.default_rng(9), 4, 12, pad_from=9)
    tt = np.zeros_like(ids)
    tt[:, 6:] = 1
    want = jax_encoder.rerank_scores(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                                     type_ids=jnp.asarray(tt))
    got = port_encoder.rerank_scores(tp, torch.from_numpy(ids), torch.from_numpy(mask), tcfg,
                                     type_ids=torch.from_numpy(tt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_SCORE)
    with torch.no_grad():
        logits = model(input_ids=torch.from_numpy(ids).long(),
                       attention_mask=torch.from_numpy(mask).long(),
                       token_type_ids=torch.from_numpy(tt).long()).logits.numpy()
    ref = logits[:, 0] if num_labels == 1 else logits[:, 1] - logits[:, 0]
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=F32_SCORE)


def test_seeded_bert_init_has_the_jax_tree(tmp_path):
    cfg_kw = dict(arch="bert", vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
                  max_len=48, out_dim=32)
    jtree = jax.tree.map(np.asarray, jax_encoder.init_encoder_params(
        jax_encoder.EncoderConfig(**cfg_kw, dtype=jnp.float32)))
    tcfg = port_encoder.EncoderConfig(**cfg_kw, dtype=torch.float32)
    ttree = port_encoder.init_encoder_params(tcfg, torch.Generator().manual_seed(0))
    assert jax.tree.structure(jtree) == jax.tree.structure(
        jax.tree.map(lambda t: t.numpy(), ttree))
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(jtree),
                                 jax.tree_util.tree_leaves_with_path(ttree)):
        assert a.shape == tuple(b.shape), path
    # the JAX tree carried across computes the JAX function
    ids, mask = inputs(np.random.default_rng(10), 2, 16)
    want, _ = jax_encoder.encode_tokens(jtree, jnp.asarray(ids), jnp.asarray(mask),
                                        jax_encoder.EncoderConfig(**cfg_kw, dtype=jnp.float32))
    got, _ = port_encoder.encode_tokens(encoder_params_from_numpy(jtree, tcfg),
                                        torch.from_numpy(ids), torch.from_numpy(mask), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_EMB)


def test_bert_tree_checks(tmp_path):
    tree, tcfg, _ = port_pretrained.load_pretrained_encoder(hf_dir(tmp_path, seed=11)[0])
    assert "score_head" not in encoder_params_from_numpy(tree, tcfg)  # an optional key
    short = dict(tree, pos_emb=tree["pos_emb"][:8])
    with pytest.raises(ValueError, match="pos_emb"):
        encoder_params_from_numpy(short, tcfg)
    with pytest.raises(ValueError, match="type_emb is missing"):
        encoder_params_from_numpy({k: v for k, v in tree.items() if k != "type_emb"}, tcfg)


# ---------------------------------------------------------------------------
# the embedder and the KB
# ---------------------------------------------------------------------------

TEXTS = ["the quick brown fox", "hello world", "中国人", "", "lazy dog " * 30,
         "unwanted running jumps over the lazy dog!"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedder_from_pretrained_matches_tpu_embedder(tmp_path, dtype):
    d, _ = hf_dir(tmp_path, seed=12)
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "float32" else (torch.bfloat16,
                                                                       jnp.bfloat16)
    want = TpuEmbedder.from_pretrained(d, dtype=jdt, batch_size=4).embed_batch(TEXTS)
    emb = TorchEmbedder.from_pretrained(d, dtype=tdt, batch_size=4, device="cpu")
    assert emb.cfg.attention_impl == "xla" and emb.dimension == 32
    assert isinstance(emb.tokenizer, WordPieceTokenizer)
    got = emb.embed_batch(TEXTS)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_EMB if dtype == "float32" else BF16_EMB)


def test_weights_dir_with_a_vocabulary_matches_jax(tmp_path):
    """A ``train_embedder``-style directory that carries a WordPiece vocab:
    the JAX package's npz and config, served by both packages."""
    cfg_kw = dict(vocab_size=len(VOCAB), d_model=32, n_layers=2, n_heads=2, d_ff=64,
                  max_len=64, out_dim=16)
    jcfg = jax_encoder.EncoderConfig(**cfg_kw, dtype=jnp.float32)
    jax_encoder.save_params_npz(jax_encoder.init_encoder_params(jcfg, seed=3),
                                tmp_path / "encoder_params.npz")
    jax_encoder.save_encoder_config(jcfg, tmp_path / "encoder_config.json")
    (tmp_path / "vocab.txt").write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    want = TpuEmbedder.from_weights_dir(tmp_path, batch_size=4).embed_batch(TEXTS)
    emb = TorchEmbedder.from_weights_dir(tmp_path, batch_size=4, device="cpu")
    assert isinstance(emb.tokenizer, WordPieceTokenizer)
    np.testing.assert_allclose(emb.embed_batch(TEXTS), want, rtol=0, atol=F32_EMB)


DOCS = {
    "fox.md": "# Foxes\nThe quick brown fox jumps over the lazy dog.",
    "hello.md": "# Greetings\nhello world, hello again world!",
    "cjk.md": "# 中国\n中国人 中国",
    "run.md": "# Running\nunwanted running, a b c 1 2 3.",
}
QUERIES = ["quick brown fox", "hello world", "中国人", "running"]


def _documents():
    return [Document(id=name, content=text, metadata={"source": name})
            for name, text in DOCS.items()]


def assert_same_ranking(got, want, tol):
    """Per query the same documents in the same order, but for a swap of two
    documents whose reference scores lie within ``tol``; scores within
    ``tol``."""
    for g, w in zip(got, want):
        assert [doc for doc, _ in g] != [] and len(g) == len(w)
        ref = dict(w)
        for (doc, score), (want_doc, want_score) in zip(g, w):
            assert doc in ref and abs(score - ref[doc]) <= tol
            assert doc == want_doc or abs(ref[doc] - want_score) <= tol


@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_kb_with_pretrained_dir_ranks_like_jax(tmp_path, pooling):
    """``EmbeddingConfig(provider="tpu", pretrained_dir=...)`` (bf16, as
    served) through a CPU KB of each package: the same top documents for
    every query, but where two documents' scores lie within the bf16
    tolerance (random weights: CLS states of a random trunk barely differ)."""
    d = write_bert_dir(tmp_path / "bge", seed=13, pooling=pooling)
    from youtu_rag_tpu.core.types import Document as JaxDocument

    def top_docs(kb, docs):
        asyncio.run(kb.build_documents(docs))
        return [[(r.chunk.document_id, r.score)
                 for r in asyncio.run(kb.search(q, top_k=len(DOCS)))] for q in QUERIES]

    jcfg = JaxRAGConfig(name="kb")
    jcfg.knowledge_builder.embedding = JaxEmbeddingConfig(provider="tpu", pretrained_dir=str(d))
    want = top_docs(JaxKnowledgeBase("kb", jcfg),
                    [JaxDocument(id=x.id, content=x.content, metadata=x.metadata)
                     for x in _documents()])
    cfg = RAGConfig(name="kb")
    cfg.knowledge_builder.embedding = EmbeddingConfig(provider="tpu", pretrained_dir=str(d))
    kb = KnowledgeBase("kb", cfg, device="cpu")
    assert isinstance(kb.embedder, TorchEmbedder) and kb.embedder.cfg.arch == "bert"
    got = top_docs(kb, _documents())
    assert_same_ranking(got, want, BF16_EMB)
    if pooling == "mean":  # token overlap decides: the documents that share the query's words
        assert [g[0][0] for g in got] == ["fox.md", "hello.md", "cjk.md", "run.md"]


def test_factory_serves_pretrained_dir(tmp_path):
    d = write_bert_dir(tmp_path / "m", seed=14, pooling="mean")
    emb = EmbedderFactory.create(EmbeddingConfig(provider="tpu", pretrained_dir=str(d),
                                                 batch_size=16), device="cpu")
    assert isinstance(emb, TorchEmbedder) and emb.cfg.pooling == "mean"
    assert emb.cfg.dtype == torch.bfloat16 and emb.batch_size == 16
    with pytest.raises(FileNotFoundError):
        EmbedderFactory.create(EmbeddingConfig(provider="tpu", pretrained_dir="/nowhere"),
                               device="cpu")


def test_numpy_writer_checkpoint_loads_in_transformers(tmp_path):
    """The checkpoint writer the tests and the chip smoke use writes the
    standard HF layout: ``transformers`` loads it and computes what the port
    computes."""
    transformers = pytest.importorskip("transformers")
    d = write_bert_dir(tmp_path / "rr", seed=15, num_labels=1)
    model = transformers.BertForSequenceClassification.from_pretrained(str(d)).eval()
    _, _, tp, tcfg = both_trees(d)
    ids, mask = inputs(np.random.default_rng(15), 3, 10, pad_from=6)
    with torch.no_grad():
        want = model(input_ids=torch.from_numpy(ids).long(),
                     attention_mask=torch.from_numpy(mask).long()).logits[:, 0].numpy()
    got = port_encoder.rerank_scores(tp, torch.from_numpy(ids), torch.from_numpy(mask), tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_SCORE)


def test_ring_with_a_bert_config_fails_as_in_jax(tmp_path):
    """JAX's sequence-parallel ring is the preln_rope trunk: built for a bert
    config it fails on the bert tree's missing keys when called, and so does
    the port's."""
    from youtu_rag_tpu.parallel.mesh import get_mesh
    from youtu_rag_tpu.parallel.sequence_parallel import make_sp_encoder as jax_sp
    from youtu_rag_tpu_torch.parallel.sequence_parallel import make_sp_encoder as port_sp

    d, _ = hf_dir(tmp_path, seed=16)
    jp, jcfg, tp, tcfg = both_trees(d)
    ids, mask = inputs(np.random.default_rng(16), 2, 32)
    with pytest.raises(KeyError):
        jax_sp(jcfg, get_mesh({"sp": 2}, devices=jax.devices()[:2]))(jp, ids, mask)
    with pytest.raises(KeyError):
        port_sp(tcfg, 2)(tp, torch.from_numpy(ids), torch.from_numpy(mask))
