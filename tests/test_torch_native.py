"""The port's native host kernels (``youtu_rag_tpu_torch/native``) against
the JAX package's, on the same texts.

The port builds the same C source (a byte-for-byte copy of
``youtu_rag_tpu/native/fasthash.c``) with the host compiler through
ctypes, where the JAX package builds it through cffi. Token ids equal both
of the JAX package's paths; hash embeddings are bit-equal to its native
path and, on these texts, within 1 ulp of its Python path (the C kernel
sums a dimension's weights in hash-table order, the Python path in
first-seen order; longer texts, with more tokens to a dimension, can land
2 ulp apart)."""

import importlib.util
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import youtu_rag_tpu.native as jax_native
from youtu_rag_tpu.models import tokenizer as jax_tok_mod
from youtu_rag_tpu.models.embedder import HashEmbedder as JaxHashEmbedder
from youtu_rag_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from youtu_rag_tpu_torch import native
from youtu_rag_tpu_torch.models import tokenizer as tok_mod
from youtu_rag_tpu_torch.models.embedder import HashEmbedder
from youtu_rag_tpu_torch.models.tokenizer import HashTokenizer
from torch_native_helpers import jax_lib, jax_tracer_restored  # noqa: F401 - fixtures

pytestmark = pytest.mark.usefixtures("jax_tracer_restored")

REPO = Path(__file__).resolve().parent.parent


def _native_tokenizer_cases() -> list[str]:
    """``CASES`` of the JAX package's native tokenizer tests."""
    path = REPO / "tests" / "models" / "test_native_tokenizer.py"
    spec = importlib.util.spec_from_file_location("jax_native_tokenizer_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return list(mod.CASES)


CASES = _native_tokenizer_cases()
UNICODE_BATCH = [
    "中文分词：知识库检索增强生成。",
    "emoji 🚀🔥 rocket fire 👩‍💻 coder",
    "nbsp ideographic　nel\u0085line sep para narrow math",
    "file\x1cgroup\x1drecord\x1eunit\x1fseps",
    "İstanbul ΣΊΣΥΦΟΣ straße ǅ ﬁ",  # lowering changes the length
    "tab\tnew\nline\r\nvertical\x0bform\x0c",
    "",
    "   ",
    "日本語のテキストと한국어 텍스트",
    "mixed_under_score123 and-hyphen.dot/slash",
]
EMBED_TEXTS = CASES + UNICODE_BATCH + [
    "repeated repeated repeated words words tf weighting",
    "x" * 500,
    " ".join(f"tok{i % 97}" for i in range(3000)),
]


def jax_python_ids(text: str, n_buckets: int, monkeypatch) -> list[int]:
    monkeypatch.setattr(jax_tok_mod, "_USE_NATIVE", False)
    return JaxHashTokenizer(n_buckets + 4).tokenize(text)


@pytest.mark.parametrize("text", CASES + UNICODE_BATCH, ids=range(len(CASES) + len(UNICODE_BATCH)))
@pytest.mark.parametrize("n_buckets", [32764, (1 << 30) - 4])
def test_tokenize_ids_native_matches_jax(jax_lib, text, n_buckets, monkeypatch):
    got = native.tokenize_ids_native(text, max(len(text), 1), n_buckets, 4)
    assert got == jax_native.tokenize_ids_native(text, max(len(text), 1), n_buckets, 4)
    assert got == jax_python_ids(text, n_buckets, monkeypatch)


@pytest.mark.parametrize("max_len", [1, 6, 62, 600])
def test_tokenize_ids_batch_native_matches_jax(jax_lib, max_len):
    texts = CASES + UNICODE_BATCH
    ids, counts = native.tokenize_ids_batch_native(texts, max_len, 4092, 4)
    want_ids, want_counts = jax_native.tokenize_ids_batch_native(texts, max_len, 4092, 4)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(counts, want_counts)
    assert ids.dtype == np.int32 and counts.dtype == np.int32
    for row, n, text in zip(ids, counts, texts):
        assert row[:n].tolist() == native.tokenize_ids_native(text, len(text) + 1, 4092, 4)[:max_len]
        assert not row[n:].any()


@pytest.mark.parametrize("pad_to", [None, 80])
@pytest.mark.parametrize("max_length", [8, 64])
def test_hash_tokenizer_paths_match_jax(jax_lib, monkeypatch, max_length, pad_to):
    """The port's tokenizer on its C and Python paths gives the JAX
    package's ids and mask (the C path fills them with numpy, no loop)."""
    texts = CASES[:6] + UNICODE_BATCH + ["short", "much longer text " * 30]
    monkeypatch.setattr(jax_tok_mod, "_USE_NATIVE", False)
    want_ids, want_mask = JaxHashTokenizer(4096, 64).batch(texts, max_length, pad_to)
    want_toks = [JaxHashTokenizer(4096).tokenize(t) for t in texts]
    for use_native in (True, False):
        monkeypatch.setattr(tok_mod, "_USE_NATIVE", use_native)
        ids, mask = HashTokenizer(4096, 64).batch(texts, max_length, pad_to)
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(mask, want_mask)
        assert ids.dtype == np.int32 and mask.dtype == np.float32
        assert [HashTokenizer(4096).tokenize(t) for t in texts] == want_toks


def test_tokenizer_defaults_to_native(monkeypatch):
    assert tok_mod._USE_NATIVE  # YRT_NATIVE_TOKENIZER is not set to 0 here
    calls = []
    real = native.tokenize_ids_batch_native
    monkeypatch.setattr(native, "tokenize_ids_batch_native",
                        lambda *a: calls.append(a) or real(*a))
    HashTokenizer(4096, 16).batch(["one two", "three"])
    assert len(calls) == 1


@pytest.mark.parametrize("dim", [64, 256, 768])
def test_hash_embed_batch_native_bit_equal_to_jax(jax_lib, dim):
    got = native.hash_embed_batch_native(EMBED_TEXTS, dim)
    np.testing.assert_array_equal(got, jax_native.hash_embed_batch_native(EMBED_TEXTS, dim))
    python = JaxHashEmbedder(dim, use_native=False).embed_batch(EMBED_TEXTS)
    ulps = np.abs(got.view(np.int32).astype(np.int64) - python.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1


@pytest.mark.parametrize("use_native", [True, False])
def test_hash_embedder_matches_jax(jax_lib, use_native):
    got = HashEmbedder(256, use_native=use_native).embed_batch(EMBED_TEXTS)
    np.testing.assert_array_equal(
        got, JaxHashEmbedder(256, use_native=use_native).embed_batch(EMBED_TEXTS))
    assert HashEmbedder(256)._use_native


def test_tf_table_overflow_reembeds_like_jax(jax_lib):
    """A text of more than 4096 distinct tokens overflows the C kernel's tf
    table; the kernel zeroes its row and both packages re-embed it on the
    Python path. Blank texts stay zero."""
    wide = " ".join(f"w{i}" for i in range(5000))
    texts = ["small text", wide, "", "  \n", wide + " tail"]
    raw = native.hash_embed_batch_native(texts, 128)
    assert not raw[1].any() and not raw[4].any() and raw[0].any()
    got = HashEmbedder(128).embed_batch(texts)
    np.testing.assert_array_equal(got, JaxHashEmbedder(128).embed_batch(texts))
    np.testing.assert_array_equal(got[1], HashEmbedder(128).embed_one(wide))
    assert not got[2].any() and not got[3].any()
    np.testing.assert_allclose(np.linalg.norm(got[[0, 1, 4]], axis=1), 1.0, atol=1e-6)


@pytest.mark.parametrize("length", [1, 7, 63, 64, 127, 128, 129, 255, 256, 300])
def test_blake2b_matches_hashlib(length):
    """The C blake2b-8 against hashlib across the 128-byte block edges: with
    2**30 buckets an id shows the digest mod 2**30."""
    import hashlib

    word = "w" * length
    digest = int.from_bytes(hashlib.blake2b(word.encode(), digest_size=8).digest(),
                            "little", signed=True)
    assert native.tokenize_ids_native(word, length, (1 << 30) - 4, 4) == \
        [4 + digest % ((1 << 30) - 4)]


def test_batch_over_the_offset_limit_raises(monkeypatch):
    monkeypatch.setattr(native, "_MAX_BUFFER", 10)
    with pytest.raises(ValueError, match="split the batch"):
        native.hash_embed_batch_native(["0123456", "789abc"], 16)


def test_failed_build_raises_with_the_compilers_output(monkeypatch, tmp_path):
    broken = tmp_path / "fasthash.c"
    broken.write_text("this is not C\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="building native/fasthash.c failed") as err:
        native.load()
    assert "error" in str(err.value)
    assert not list((tmp_path / "_build").iterdir())  # no library, no temporary file left
    with pytest.raises(RuntimeError):  # and the embedder does not fall back to Python
        HashEmbedder(16).embed_batch(["text"])


def test_no_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    with pytest.raises((RuntimeError, OSError)):
        native.load()


def test_source_is_the_jax_packages_byte_for_byte():
    assert native.SOURCE.read_bytes() == (REPO / "youtu_rag_tpu" / "native" / "fasthash.c").read_bytes()
    assert native.SOURCE.parent == REPO / "youtu_rag_tpu_torch" / "native"


BUILDER = """
import sys, time
from pathlib import Path
import youtu_rag_tpu_torch.native as native
native.BUILD_DIR = Path(sys.argv[1])
go = Path(sys.argv[2])
while not go.exists():
    time.sleep(0.005)
native.load()
print(native.hash_embed_batch_native(["the same text", "中文 🚀"], 32).tobytes().hex())
print(native.tokenize_ids_native("the same text", 13, 32764, 4))
"""


def test_six_processes_build_one_cache_at_once(tmp_path):
    """Six processes start building into one empty directory together; all
    load a whole library and agree, and one library is left there."""
    cache, go = tmp_path / "cache", tmp_path / "go"
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen([sys.executable, "-c", BUILDER, str(cache), str(go)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    time.sleep(1.0)  # let them reach the start line
    go.touch()
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(out)
    assert len(set(outs)) == 1
    want = native.hash_embed_batch_native(["the same text", "中文 🚀"], 32).tobytes().hex()
    assert outs[0].split("\n")[0] == want
    assert [p.name for p in cache.iterdir()] == [native.library_path().name]
