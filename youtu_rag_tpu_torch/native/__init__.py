"""Native host kernels: ``fasthash.c`` built with the host C compiler and
loaded with ctypes.

``fasthash.c`` is a byte-for-byte copy of the JAX package's source: the
hash embedder's hot loop (``hash_embed_batch``) and the hashing
tokenizer's (``tokenize_ids``, ``tokenize_ids_batch``). It compiles at
first use, never at import, with ``$CC`` (else ``cc`` on ``PATH``) and
CFLAGS into ``_build/fasthash-<hash>.so``; the hash covers the source and
the flags, so an edited source rebuilds. Each build writes a file of its
own and renames it into place, so processes that build at once all load
one whole library. A failed build raises with the compiler's output: the
callers do not fall back to their Python paths unless asked to
(``HashEmbedder(use_native=False)``, ``YRT_NATIVE_TOKENIZER=0``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "fasthash.c"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# the JAX package's flags (-O3 -fno-math-errno) and those of a shared library
CFLAGS = ["-O3", "-fno-math-errno", "-shared", "-fPIC"]
LDLIBS = ["-lm"]
_MAX_BUFFER = 2**31 - 1  # the C offsets are int

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "hash_embed_one": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int, _f32p, ctypes.c_int]),
    "hash_embed_batch": (None, [ctypes.c_char_p, _i32p, ctypes.c_int, _f32p, ctypes.c_int]),
    "tokenize_ids": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int, _i32p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int]),
    "tokenize_ids_batch": (None, [ctypes.c_char_p, _i32p, ctypes.c_int, _i32p, _i32p,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int]),
}


def compiler() -> str:
    """``$CC``, else ``cc`` on ``PATH``."""
    cc = os.environ.get("CC") or shutil.which("cc")
    if not cc:
        raise RuntimeError("no host C compiler for native/fasthash.c: set CC or put cc on PATH")
    return cc


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CFLAGS + LDLIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"fasthash-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``fasthash.c`` unless the library is built already; return
    its path. Raises RuntimeError with the compiler's output on failure."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [compiler(), *CFLAGS, "-o", str(tmp), str(SOURCE), *LDLIBS]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building native/fasthash.c failed (exit {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout.decode(errors='replace')}")
    os.replace(tmp, lib)  # atomic: a concurrent builder never sees half a file
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built at the first call in this process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def _concat(encoded: list[bytes]) -> tuple[bytes, np.ndarray]:
    """The texts back to back and their int32 offsets ([n + 1])."""
    offsets = np.zeros(len(encoded) + 1, np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    if offsets[-1] > _MAX_BUFFER:
        raise ValueError(f"{offsets[-1]} bytes of text in one native call; the limit is "
                         f"{_MAX_BUFFER}: split the batch")
    return b"".join(encoded) or b"\x00", offsets.astype(np.int32)


def tokenize_ids_native(text: str, max_out: int, n_buckets: int, n_special: int) -> list[int]:
    """Hashed token ids of one string (at most ``max_out``). ``text`` is
    lowercased here: full-Unicode case folding stays in Python, and the C
    scanner takes folded input."""
    lib = load()
    lowered = text.lower()
    enc = lowered.encode("utf-8")
    # lowercasing can add codepoints ('İ' → 'i' + a combining dot), so the
    # caller's bound from the text before lowering can be short
    max_out = max(max_out, len(lowered), 1)
    out = np.empty(max_out, np.int32)
    n = lib.tokenize_ids(enc, len(enc), out.ctypes.data_as(_i32p), max_out, n_buckets, n_special)
    return out[:n].tolist()


def tokenize_ids_batch_native(texts: list[str], max_len: int, n_buckets: int,
                              n_special: int) -> tuple[np.ndarray, np.ndarray]:
    """Tokenize a batch: (ids [n, max_len] int32, counts [n] int32); row i
    holds its first ``counts[i]`` ids, then zeros."""
    lib = load()
    buf, offsets = _concat([t.lower().encode("utf-8") for t in texts])
    out = np.zeros((len(texts), max_len), np.int32)
    counts = np.zeros(len(texts), np.int32)
    lib.tokenize_ids_batch(buf, offsets.ctypes.data_as(_i32p), len(texts),
                           out.ctypes.data_as(_i32p), counts.ctypes.data_as(_i32p),
                           max_len, n_buckets, n_special)
    return out, counts


def hash_embed_batch_native(texts: list[str], dim: int) -> np.ndarray:
    """Feature-hash embeddings [n, dim] f32. A row is all zeros where its
    text has more than 4096 distinct tokens (the C tf table's size)."""
    lib = load()
    buf, offsets = _concat([t.encode("utf-8") for t in texts])
    out = np.zeros((len(texts), dim), np.float32)
    lib.hash_embed_batch(buf, offsets.ctypes.data_as(_i32p), len(texts),
                         out.ctypes.data_as(_f32p), dim)
    return out
