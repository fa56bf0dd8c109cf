"""The port's WordPiece tokenizer against the JAX package's, on the CPU:
the same ids (exact) on the pure-Python path and on the ``tokenizers``
fast path, the same vocabularies from ``build_wordpiece_vocab``, and the
same pair layout as ``transformers.BertTokenizer``."""

import os
import sys

import numpy as np
import pytest

from youtu_rag_tpu.models import wordpiece as jax_wp
from youtu_rag_tpu_torch.models import wordpiece as port_wp
from torch_native_helpers import jax_tracer_restored  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("jax_tracer_restored")

sys.path.insert(0, os.path.dirname(__file__))
from torch_bert_checkpoint import VOCAB  # noqa: E402

TEXTS = {
    "ascii": "The quick brown fox jumps over the lazy dog",
    "case-punct": "UNwanted, running!",
    "spaces-dots": "hello   world...",
    "cjk": "中国人 hello",
    "unknown": "zyzzyva unknowable",
    "digits": "abc 123 a1b2",
    "accents": "naïve café",
    "empty": "",
    "controls": "hello\x00world​\tfox\r\ndog�",
    "symbols": "$5 ^caret_ `tick` ~tilde ¿qué? «quoted» — dash",
    "over-long": "a" * 101 + " fox " + "b" * 100,
    "mixed-script": "Ünïcödé 中文 tokens! 国人a1",
}
PAIRS = [("quick fox", "lazy dog"), ("中国", "the " * 200), ("", "hello"), ("want", "")]


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("wp") / "vocab.txt"
    path.write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    return path


def tokenizers(vocab_file, use_fast, lowercase=True):
    port = port_wp.WordPieceTokenizer(vocab_file, lowercase=lowercase, use_fast=use_fast,
                                      max_length=48)
    jax = jax_wp.WordPieceTokenizer(vocab_file, lowercase=lowercase, use_fast=use_fast,
                                    max_length=48)
    assert (port._fast is None) == (jax._fast is None)
    return port, jax


@pytest.mark.parametrize("lowercase", [True, False], ids=["lower", "cased"])
@pytest.mark.parametrize("use_fast", [False, True], ids=["pure", "fast"])
@pytest.mark.parametrize("name", list(TEXTS))
def test_ids_match_jax(vocab_file, name, use_fast, lowercase):
    port, jax = tokenizers(vocab_file, use_fast, lowercase)
    text = TEXTS[name]
    assert port.tokenize_words(text) == jax.tokenize_words(text)
    assert port.tokenize(text) == jax.tokenize(text)
    assert port.encode(text) == jax.encode(text)
    assert port.encode(text, max_length=6) == jax.encode(text, max_length=6)
    for a, b in PAIRS:
        assert port.encode_pair(text or a, b) == jax.encode_pair(text or a, b)


@pytest.mark.parametrize("use_fast", [False, True], ids=["pure", "fast"])
def test_batches_match_jax(vocab_file, use_fast):
    port, jax = tokenizers(vocab_file, use_fast)
    texts = list(TEXTS.values())
    for args in ((texts,), (texts, 8), (texts, 8, 20)):
        for got, want in zip(port.batch(*args), jax.batch(*args)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
    for args in ((PAIRS,), (PAIRS, 16), (PAIRS, 16, 40)):
        for got, want in zip(port.batch_pairs(*args), jax.batch_pairs(*args)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype


def test_fast_and_pure_paths_give_the_same_ids(vocab_file):
    fast = port_wp.WordPieceTokenizer(vocab_file, use_fast=True)
    pure = port_wp.WordPieceTokenizer(vocab_file, use_fast=False)
    if fast._fast is None:
        pytest.skip("the tokenizers package is not installed")
    for text in TEXTS.values():
        assert fast.tokenize(text) == pure.tokenize(text), text
    for got, want in zip(fast.batch(list(TEXTS.values())), pure.batch(list(TEXTS.values()))):
        np.testing.assert_array_equal(got, want)


def test_pairs_match_bert_tokenizer(vocab_file):
    """Ids and token types of a pair as ``transformers.BertTokenizer`` lays
    them out; single texts as it tokenizes them."""
    transformers = pytest.importorskip("transformers")
    theirs = transformers.BertTokenizer(str(vocab_file), do_lower_case=True)
    ours = port_wp.WordPieceTokenizer(vocab_file, use_fast=False)
    for name in ("ascii", "case-punct", "cjk", "unknown", "accents", "digits"):
        assert ours.tokenize_words(TEXTS[name]) == theirs.tokenize(TEXTS[name])
        assert ours.encode(TEXTS[name]) == theirs.encode(TEXTS[name])
    enc = theirs("quick fox", "lazy dog")
    ids, mask, types = ours.batch_pairs([("quick fox", "lazy dog")])
    n = int(mask[0].sum())
    assert ids[0, :n].tolist() == enc["input_ids"]
    assert types[0, :n].tolist() == enc["token_type_ids"]


def test_over_long_word_is_one_unk(vocab_file):
    tok = port_wp.WordPieceTokenizer(vocab_file, use_fast=False, max_chars_per_word=5)
    assert tok.wordpiece("abcdef") == ["[UNK]"]
    assert tok.wordpiece("abc") == ["a", "##b", "##c"]
    assert tok.wordpiece("zzz") == ["[UNK]"]


CORPUS = [
    "Maintenance log for unit KL-4407. The inventory tag recorded is 88213.",
    "Maintenance log for unit QX-9911; the inventory tag recorded is 55120.",
    "naïve café owners log their inventory daily 中文 文本",
    "running runners run; unwanted wants want",
] * 3


@pytest.mark.parametrize("vocab_size, min_pair_freq", [(60, 2), (200, 2), (120, 1)])
def test_build_wordpiece_vocab_matches_jax(tmp_path, vocab_size, min_pair_freq):
    got = port_wp.build_wordpiece_vocab(CORPUS, vocab_size, min_pair_freq=min_pair_freq)
    want = jax_wp.build_wordpiece_vocab(CORPUS, vocab_size, min_pair_freq=min_pair_freq)
    assert got == want
    port_wp.save_vocab(got, tmp_path / "v.txt")
    assert port_wp.load_vocab(tmp_path / "v.txt") == jax_wp.load_vocab(tmp_path / "v.txt") == got
    tok = port_wp.WordPieceTokenizer(got, use_fast=False)
    assert tok.unk_id not in tok.tokenize(CORPUS[0])  # every unit is in the vocabulary
