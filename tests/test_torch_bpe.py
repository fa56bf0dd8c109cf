"""The port's BPE tokenizer (``youtu_rag_tpu_torch/models/bpe.py``) against
the JAX package's ``BPETokenizer`` on the same inputs, on the CPU.

Tolerance: none. Token ids, decoded text, the special ids and the word
split are equal, on the committed ``yrt_tiny_chat`` tokenizer.json (the
local chat model's) and on a byte-level BPE trained in-test with
``tokenizers`` (as ``tests/models/test_bpe.py`` does), through both of its
exports (tokenizer.json; vocab.json + merges.txt), and on a metaspace
(LLaMA-style) vocabulary with byte fallback."""

import json
from pathlib import Path

import pytest

from youtu_rag_tpu.models.bpe import BPETokenizer as JaxBPE
from youtu_rag_tpu.models.bpe import _gpt2_word_split as jax_split
from youtu_rag_tpu_torch.models.bpe import BPETokenizer, _gpt2_word_split, bytes_to_unicode
from torch_native_helpers import jax_tracer_restored  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("jax_tracer_restored")

CHAT = Path(__file__).resolve().parent.parent / "benchmarks" / "models" / "yrt_tiny_chat"

TEXTS = [
    "Hello, world!",
    "it's we've they'll I'd you're can't",
    "  leading spaces and   runs",
    "trailing space ",
    "tabs\tbetween\twords",
    "multi\n\nnewlines\n",
    "numbers 123 mixed42 with7text",
    "unicode: 中文 → ∑ π émigré naïve",
    "emoji 🚀🔥 multi-byte",
    "quotes \"double\" and 'single'",
    "",
    " ",
    # the chat model's own format: a ReAct turn and a fact sentence
    "system: You are a helpful assistant.\nuser: What is the color of Zoka-12?\nassistant:",
    'Thought: I should look this up in the knowledge base.\nAction: kb_embedding_search\n'
    'Action Input: {"query": " What is the color of Zoka-12?"}',
    "The mass of Bifu is 230 kg. For Lemo, the code is KT-4410.",
]

CORPUS = [
    "The quick brown fox jumps over the lazy dog.",
    "hello world, hello tokenizer! it's a test isn't it?",
    "Numbers: 12345 67 8.9 and units like 10km or 3x4.",
    "def f(x):\n    return x * 2  # comment\n",
    "中文混合 English text avec français und Deutsch.",
    "spaces   and\ttabs\nand newlines",
] * 4


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A small byte-level BPE trained with ``tokenizers``: (dir, hf tokenizer)."""
    tokenizers = pytest.importorskip("tokenizers")
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=420, special_tokens=["<|endoftext|>"],
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
                                  show_progress=False)
    tok.train_from_iterator(CORPUS, trainer)
    d = tmp_path_factory.mktemp("bpe")
    tok.save(str(d / "tokenizer.json"))
    assert tokenizers is not None
    return d, tok


@pytest.mark.parametrize("add_bos", [False, True])
@pytest.mark.parametrize("text", TEXTS, ids=range(len(TEXTS)))
def test_chat_tokenizer_matches_jax(text, add_bos):
    ours, theirs = BPETokenizer.from_dir(CHAT), JaxBPE.from_dir(CHAT)
    ids = ours.encode(text, add_bos=add_bos)
    assert ids == theirs.encode(text, add_bos=add_bos)
    assert ours.decode(ids) == theirs.decode(ids)
    assert ours.decode(ids + [ours.eos_id], skip_special=False) == theirs.decode(
        ids + [theirs.eos_id], skip_special=False)


def test_chat_tokenizer_specials_match_jax():
    ours, theirs = BPETokenizer.from_dir(CHAT), JaxBPE.from_dir(CHAT)
    assert (ours.vocab_size, ours.eos_id, ours.bos_id) == (theirs.vocab_size, theirs.eos_id,
                                                           theirs.bos_id)
    assert ours.added == theirs.added and ours.scheme == theirs.scheme
    assert ours.eos_id == json.loads((CHAT / "decoder_config.json").read_text())["eos_token_id"]


@pytest.mark.parametrize("text", TEXTS + CORPUS[:6], ids=range(len(TEXTS) + 6))
def test_trained_tokenizer_matches_jax_and_hf(trained, text):
    d, hf = trained
    ours = BPETokenizer.from_tokenizer_json(d / "tokenizer.json")
    theirs = JaxBPE.from_tokenizer_json(d / "tokenizer.json")
    ids = ours.encode(text)
    assert ids == theirs.encode(text) == hf.encode(text).ids
    assert ours.decode(ids) == theirs.decode(ids) == text


def test_vocab_json_merges_txt_matches_jax(trained, tmp_path):
    d, _ = trained
    tj = json.loads((d / "tokenizer.json").read_text(encoding="utf-8"))
    (tmp_path / "vocab.json").write_text(json.dumps(tj["model"]["vocab"]), encoding="utf-8")
    merges = [m if isinstance(m, str) else " ".join(m) for m in tj["model"]["merges"]]
    (tmp_path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n",
                                         encoding="utf-8")
    ours, theirs = BPETokenizer.from_dir(tmp_path), JaxBPE.from_dir(tmp_path)
    for text in TEXTS:
        assert ours.encode(text) == theirs.encode(text)
        assert ours.decode(ours.encode(text)) == theirs.decode(theirs.encode(text))


def test_metaspace_byte_fallback_matches_jax():
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2, "▁": 3, "▁he": 4, "llo": 5,
             "▁world": 6, "h": 7, "e": 8, "l": 9, "o": 10, "▁h": 11}
    for i in range(256):
        vocab[f"<0x{i:02X}>"] = 12 + i
    merges = [("▁", "h"), ("▁h", "e"), ("l", "l"), ("ll", "o"), ("▁", "world")]
    kw = dict(scheme="metaspace", added_tokens={"<s>": 1, "</s>": 2, "<unk>": 0},
              eos_token="</s>", bos_token="<s>")
    ours, theirs = BPETokenizer(vocab, merges, **kw), JaxBPE(vocab, merges, **kw)
    for text in ("hello", "héllo world", "hello world", "  two  spaces", "<s>hello</s>"):
        for add_bos in (False, True):
            ids = ours.encode(text, add_bos=add_bos)
            assert ids == theirs.encode(text, add_bos=add_bos)
            assert ours.decode(ids) == theirs.decode(ids)


def test_word_split_and_byte_table_match_jax():
    from youtu_rag_tpu.models.bpe import bytes_to_unicode as jax_table

    assert bytes_to_unicode() == jax_table()
    for text in TEXTS + ["a  b", "x   y", "end ", "num 123x", "中文ab"]:
        assert _gpt2_word_split(text) == jax_split(text)
