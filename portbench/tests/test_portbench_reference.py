"""The plain reference against the program at tiny widths on the CPU, in
f32: the BERT embedder and cross-encoder read from the same checkpoint
(``TorchEmbedder`` / ``TorchReranker.from_pretrained``), WordPiece ids,
the recursive splitter, and exact top-k."""

import numpy as np
import torch

from portbench.bench import textgen, weights
from portbench.reference import chunker, topk
from portbench.reference.bert import Bert
from portbench.reference.wordpiece import Tokenizer
from youtu_rag_tpu_torch.ingest.chunker import RecursiveTextSplitter
from youtu_rag_tpu_torch.models.embedder import TorchEmbedder
from youtu_rag_tpu_torch.models.reranker import TorchReranker
from youtu_rag_tpu_torch.models.wordpiece import WordPieceTokenizer

from .conftest import TINY_MODEL

LEX = textgen.Lexicon()


def texts(n, chars, seed=3):
    return textgen.pool_texts(LEX, np.random.default_rng(seed), n, chars)


def test_tokenizer_matches_the_program():
    tok = Tokenizer(LEX.vocab)
    vocab = {w: i for i, w in enumerate(LEX.vocab)}
    for use_fast in (False, True):
        wp = WordPieceTokenizer(vocab, use_fast=use_fast)
        for t in texts(20, 1000) + ["Hello, World!  Ünïcode: a-b (c)."]:
            assert wp.tokenize(t) == tok.tokenize(t)
            assert wp.encode_pair("a question here", t) == tok.encode_pair("a question here", t)[0]


def test_embedder_and_cross_encoder_match_the_program(tmp_path):
    tok = Tokenizer(LEX.vocab)
    docs = texts(6, 300)
    flat, lay = weights.make(TINY_MODEL, False, 5, "cpu", 0.05)
    weights.write(str(tmp_path / "e"), TINY_MODEL, flat, lay, LEX.vocab, head=False)
    prog = TorchEmbedder.from_pretrained(str(tmp_path / "e"), device="cpu", dtype=torch.float32)
    ref = Bert(weights.state(flat, lay), TINY_MODEL, "cpu")
    got = prog.embed_batch(docs)
    want = ref.embed([tok.encode(d) for d in docs]).numpy()
    assert np.abs(got - want).max() < 2e-5

    flat, lay = weights.make(TINY_MODEL, True, 6, "cpu", 0.05)
    weights.write(str(tmp_path / "c"), TINY_MODEL, flat, lay, LEX.vocab, head=True)
    ce = TorchReranker.from_pretrained(str(tmp_path / "c"), device="cpu", dtype=torch.float32)
    ref_ce = Bert(weights.state(flat, lay), TINY_MODEL, "cpu")
    got = np.asarray(ce.score("which one", docs))
    enc = [tok.encode_pair("which one", d) for d in docs]
    want = ref_ce.score([e[0] for e in enc], [e[1] for e in enc]).numpy()
    assert np.abs(got - want).max() < 2e-5


def test_fp8_control_is_further_off():
    tok = Tokenizer(LEX.vocab)
    flat, lay = weights.make(TINY_MODEL, False, 5, "cpu", 0.05)
    seqs = [tok.encode(d) for d in texts(4, 300)]
    f32 = Bert(weights.state(flat, lay), TINY_MODEL, "cpu").embed(seqs)
    fp8 = Bert(weights.state(flat, lay), TINY_MODEL, "cpu", "fp8").embed(seqs)
    assert 1e-3 < float((f32 - fp8).norm(dim=1).max()) < 0.5


def test_chunker_matches_the_program():
    split = RecursiveTextSplitter()
    rng = np.random.default_rng(4)
    paras = textgen.paragraphs(LEX, rng, 32, 50, 2500)
    for _ in range(40):
        doc = textgen.document(paras, rng, 6000, 0.8, 30000)
        assert chunker.split(doc, 1000, 200) == split.split_text(doc)
    assert chunker.split("x" * 2500, 1000, 200) == split.split_text("x" * 2500)


def test_exact_topk_over_slices():
    g = torch.Generator().manual_seed(0)
    x = torch.nn.functional.normalize(torch.randn(1000, 32, generator=g), dim=1)
    q = torch.nn.functional.normalize(torch.randn(3, 32, generator=g), dim=1)
    for tier in ("bfloat16", "int8", "int4", "float8"):
        s, i = topk.exact_topk(q, ((a, x[a:a + 300]) for a in range(0, 1000, 300)), tier, 7)
        full = q @ topk.stored(x, tier).T
        want_s, want_i = full.topk(7, dim=1)
        assert torch.equal(i, want_i) and torch.allclose(s, want_s)
    q8 = topk.stored(x[:2], "int8")
    assert torch.allclose(q8, x[:2], atol=1.0 / 127)


def test_bm25_terms_match_the_program():
    from collections import Counter

    from portbench.reference import terms
    from youtu_rag_tpu_torch.models.tokenizer import HashTokenizer

    tok = HashTokenizer(vocab_size=2**30)
    for t in texts(20, 1000) + ["Hello, World!  Ünïcode: a-b (c). 中文 x_1"]:
        ids = tok.tokenize(t)
        assert terms.record(t) == (len(ids), dict(Counter(ids)))
