"""The inputs repeat from the seed: texts, questions, documents, weights
and rows; another seed gives other inputs of the same sizes."""

import numpy as np
import torch

from portbench.bench import spec, textgen, weights
from portbench.bench.fixture import Fixture

from .conftest import TINY_MODEL, tiny_config, tiny_traffic


def test_texts_repeat():
    lex = textgen.Lexicon()
    assert len(lex.vocab) == textgen.VOCAB_SIZE == len(set(lex.vocab))
    assert textgen.Lexicon().vocab == lex.vocab
    a = textgen.pool_texts(lex, np.random.default_rng(2**31 + 5), 8, 1000)
    b = textgen.pool_texts(lex, np.random.default_rng(2**31 + 5), 8, 1000)
    c = textgen.pool_texts(lex, np.random.default_rng(2**31 + 6), 8, 1000)
    assert a == b and a != c
    assert all(900 <= len(t) <= 1000 for t in a + c)


def test_weights_repeat():
    a, lay = weights.make(TINY_MODEL, True, 2**40 + 3, "cpu")
    b, _ = weights.make(TINY_MODEL, True, 2**40 + 3, "cpu")
    c, _ = weights.make(TINY_MODEL, True, 2**40 + 4, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    st = weights.state(a, lay)
    assert float(st["bert.embeddings.LayerNorm.weight"].min()) == 1.0
    assert st["classifier.weight"].shape == (1, 64)


QA = spec.driver(spec.BENCH_DIR, "qa")
INGEST = spec.driver(spec.BENCH_DIR, "ingest")


def fixture(seed, tmp_path):
    fx = Fixture(tiny_config("pretrained-bge-base"), tiny_traffic("rerank-qa-c32"), seed, "cpu",
                 str(tmp_path))
    return fx.build()


def test_fixture_and_streams_repeat(tmp_path):
    a, b = fixture(2**31 + 1, tmp_path / "a"), fixture(2**31 + 1, tmp_path / "b")
    c = fixture(2**31 + 2, tmp_path / "c")
    assert torch.equal(a.rows(4096, 4096), b.rows(4096, 4096))
    assert not torch.equal(a.rows(0, 4096), c.rows(0, 4096))
    assert torch.allclose(a.rows(0, 4096).norm(dim=1), torch.ones(4096))
    qs = QA.question_stream(a, 3, 500)
    assert qs == QA.question_stream(b, 3, 500) and qs != QA.question_stream(c, 3, 500)
    lengths = [len(q.split()) for q in qs]
    assert min(lengths) >= 3 and max(lengths) <= a.traffic["question"]["max_words"]
    assert 10 <= sorted(lengths)[250] <= 14  # median 12 words
    assert a.kb.store.index.count() == a.n_rows
    ids = {a.row_ids_text(i) for i in range(0, a.n_rows, a.n_centres)}
    assert len(ids) == a.n_rows // a.n_centres  # one cluster's rows hold different texts


def test_documents_repeat(tmp_path):
    fx = Fixture(tiny_config("pretrained-bge-base"), tiny_traffic("ingest-docs"), 9, "cpu",
                 str(tmp_path))
    lex = textgen.Lexicon()
    paras = textgen.paragraphs(lex, np.random.default_rng(1), 64, 200, 1500)
    a = [d.content for d in INGEST.documents(fx, paras, 0, 5, 3, "d")]
    assert a == [d.content for d in INGEST.documents(fx, paras, 0, 5, 3, "d")]
    # document j is the same whichever call sends it
    assert a[3:] == [d.content for d in INGEST.documents(fx, paras, 3, 2, 3, "d")]
    assert a != [d.content for d in INGEST.documents(fx, paras, 0, 5, 4, "d")]
    assert all(len(t) <= fx.traffic["doc"]["max_chars"] for t in a)
