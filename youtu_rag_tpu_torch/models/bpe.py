"""Byte-level / metaspace BPE tokenizer for causal-LM checkpoints: a copy
of ``youtu_rag_tpu/models/bpe.py`` (pure Python; the port keeps its own).

Reads the HF ``tokenizer.json`` (or the older ``vocab.json`` +
``merges.txt`` pair) that ships next to GPT-2-family and LLaMA-family
weights, with no ``tokenizers`` wheel and no network. Two pre-tokenization
schemes cover those families:

- ``byte_level`` (GPT-2/RoBERTa): text splits on the GPT-2 word pattern,
  each piece maps bytes to printable unicode (the standard 256-entry
  table), then BPE merges by rank;
- ``metaspace`` (LLaMA/sentencepiece-style BPE): spaces become ``▁`` with a
  prefix space, byte-fallback tokens ``<0xNN>`` cover unknown bytes.

The GPT-2 split regex uses ``\\p{L}``/``\\p{N}`` Unicode classes that
stdlib ``re`` lacks; ``_gpt2_word_split`` reimplements it as a scanner over
``unicodedata`` categories. Added and special tokens split out first;
``encode(add_bos=)`` and ``decode`` are the JAX package's.
"""

from __future__ import annotations

import json
import unicodedata
from functools import lru_cache
from pathlib import Path


@lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte→printable-char table (avoids control chars
    so every byte sequence round-trips through a unicode string)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch).startswith("L")


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch).startswith("N")


_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _gpt2_word_split(text: str) -> list[str]:
    """The GPT-2 pre-tokenizer pattern as an explicit scanner.

    Pattern: ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+|``
    `` ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``."""
    out: list[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        nxt = text[i : i + 3]  # GPT-2's contraction alternates are lowercase-only
        hit = next((c for c in _CONTRACTIONS if nxt.startswith(c)), None)
        if ch == "'" and hit:
            out.append(text[i : i + len(hit)])
            i += len(hit)
            continue
        j = i
        lead = ""
        if ch == " " and i + 1 < n and (_is_letter(text[i + 1]) or _is_number(text[i + 1]) or not text[i + 1].isspace()):
            lead = " "
            j = i + 1
            ch = text[j]
        if _is_letter(ch):
            k = j
            while k < n and _is_letter(text[k]):
                k += 1
            out.append(lead + text[j:k])
            i = k
            continue
        if _is_number(ch):
            k = j
            while k < n and _is_number(text[k]):
                k += 1
            out.append(lead + text[j:k])
            i = k
            continue
        if not ch.isspace():
            k = j
            while k < n and not text[k].isspace() and not _is_letter(text[k]) and not _is_number(text[k]):
                k += 1
            out.append(lead + text[j:k])
            i = k
            continue
        # whitespace run: `\s+(?!\S)` eats all but a final space that
        # prefixes the next word; `\s+` otherwise
        k = i
        while k < n and text[k].isspace():
            k += 1
        if k < n and k - i > 1:
            out.append(text[i : k - 1])
            i = k - 1
        else:
            out.append(text[i:k])
            i = k
    return out


def train_bpe(
    texts: list[str], vocab_size: int, specials: list[str] | None = None
) -> "BPETokenizer":
    """Learn byte-level BPE merges from a corpus (standard count-and-merge).

    Fills the tokenizer-training slot the reference delegates to remote
    model vendors: base vocab = the 256-entry byte alphabet, then
    ``vocab_size - 256 - len(specials)`` highest-count adjacent-pair merges
    over the GPT-2-pretokenized corpus. Returns a ready ``BPETokenizer``
    whose ``save_json`` output round-trips through ``from_tokenizer_json``."""
    specials = list(specials or ["<|endoftext|>"])
    alphabet = list(bytes_to_unicode().values())
    vocab: dict[str, int] = {ch: i for i, ch in enumerate(alphabet)}
    n_merges = max(0, vocab_size - len(vocab) - len(specials))

    # word frequency table in byte-alphabet space
    freqs: dict[tuple[str, ...], int] = {}
    enc = bytes_to_unicode()
    for text in texts:
        for w in _gpt2_word_split(text):
            key = tuple(enc[b] for b in w.encode("utf-8"))
            if key:
                freqs[key] = freqs.get(key, 0) + 1

    merges: list[tuple[str, str]] = []
    words = {k: list(k) for k in freqs}
    # pair counts maintained incrementally: recount only words that change
    pair_counts: dict[tuple[str, str], int] = {}
    pair_words: dict[tuple[str, str], set] = {}
    for key, parts in words.items():
        f = freqs[key]
        for p in zip(parts, parts[1:]):
            pair_counts[p] = pair_counts.get(p, 0) + f
            pair_words.setdefault(p, set()).add(key)
    for _ in range(n_merges):
        if not pair_counts:
            break
        # deterministic argmax (count, then lexicographic) for stable vocabs
        best = max(pair_counts.items(), key=lambda kv: (kv[1], kv[0]))[0]
        if pair_counts[best] < 2:
            break
        merges.append(best)
        merged = best[0] + best[1]
        vocab[merged] = len(vocab)
        for key in list(pair_words.get(best, ())):
            parts = words[key]
            f = freqs[key]
            for p in zip(parts, parts[1:]):
                pair_counts[p] -= f
                if pair_counts.get(p, 0) <= 0:
                    pair_counts.pop(p, None)
                ws = pair_words.get(p)
                if ws is not None:
                    ws.discard(key)
            out = []
            i = 0
            while i < len(parts):
                if i + 1 < len(parts) and (parts[i], parts[i + 1]) == best:
                    out.append(merged)
                    i += 2
                else:
                    out.append(parts[i])
                    i += 1
            words[key] = out
            for p in zip(out, out[1:]):
                pair_counts[p] = pair_counts.get(p, 0) + f
                pair_words.setdefault(p, set()).add(key)
    added = {}
    for s in specials:
        added[s] = len(vocab)
        vocab[s] = added[s]
    eos = specials[0] if specials else None
    return BPETokenizer(
        vocab, merges, scheme="byte_level", added_tokens=added, eos_token=eos
    )


class BPETokenizer:
    """BPE encode/decode from an HF tokenizer.json / vocab+merges pair."""

    def __init__(
        self,
        vocab: dict[str, int],
        merges: list[tuple[str, str]],
        scheme: str = "byte_level",
        added_tokens: dict[str, int] | None = None,
        eos_token: str | None = None,
        bos_token: str | None = None,
    ):
        self.vocab = vocab
        self.ids = {v: k for k, v in vocab.items()}
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.scheme = scheme
        self.added = dict(added_tokens or {})
        for tok, tid in self.added.items():
            self.vocab.setdefault(tok, tid)
            self.ids.setdefault(tid, tok)
        self.eos_token = eos_token
        self.bos_token = bos_token
        self._cache: dict[str, list[str]] = {}
        self._byte_enc = bytes_to_unicode()
        self._byte_dec = {c: b for b, c in self._byte_enc.items()}

    # -------------------------------------------------------------- factory

    @classmethod
    def from_dir(cls, model_dir) -> "BPETokenizer":
        model_dir = Path(model_dir)
        tj = model_dir / "tokenizer.json"
        if tj.exists():
            return cls.from_tokenizer_json(tj)
        vj, mt = model_dir / "vocab.json", model_dir / "merges.txt"
        if vj.exists() and mt.exists():
            with open(vj, encoding="utf-8") as f:
                vocab = json.load(f)
            merges = []
            with open(mt, encoding="utf-8") as f:
                for line in f:
                    line = line.rstrip("\n")
                    if not line or line.startswith("#version"):
                        continue
                    a, _, b = line.partition(" ")
                    merges.append((a, b))
            return cls(vocab, merges, scheme="byte_level")
        raise FileNotFoundError(f"no tokenizer.json or vocab.json+merges.txt in {model_dir}")

    @classmethod
    def from_tokenizer_json(cls, path) -> "BPETokenizer":
        with open(path, encoding="utf-8") as f:
            tj = json.load(f)
        model = tj.get("model", {})
        if model.get("type") != "BPE":
            raise ValueError(f"tokenizer.json model.type {model.get('type')!r} != 'BPE'")
        vocab = dict(model["vocab"])
        merges = []
        for m in model.get("merges", []):
            if isinstance(m, str):
                a, _, b = m.partition(" ")
            else:
                a, b = m
            merges.append((a, b))
        pre = json.dumps(tj.get("pre_tokenizer") or {})
        norm = json.dumps(tj.get("normalizer") or {})
        scheme = "byte_level" if "ByteLevel" in pre else (
            "metaspace" if ("Metaspace" in pre or "Metaspace" in norm or "Replace" in norm) else "byte_level"
        )
        added = {
            t["content"]: t["id"]
            for t in tj.get("added_tokens", [])
            if isinstance(t, dict) and "content" in t
        }
        eos = bos = None
        for name in ("</s>", "<|endoftext|>", "<|im_end|>", "<eos>"):
            if name in added or name in vocab:
                eos = name
                break
        for name in ("<s>", "<|im_start|>", "<bos>"):
            if name in added or name in vocab:
                bos = name
                break
        return cls(vocab, merges, scheme=scheme, added_tokens=added,
                   eos_token=eos, bos_token=bos)

    def save_json(self, path) -> None:
        """Write an HF-layout tokenizer.json that ``from_tokenizer_json``
        (and the ``tokenizers`` wheel) reads back identically."""
        base = {k: v for k, v in self.vocab.items() if k not in self.added}
        doc = {
            "version": "1.0",
            "added_tokens": [
                {"id": tid, "content": tok, "special": True}
                for tok, tid in sorted(self.added.items(), key=lambda kv: kv[1])
            ],
            "pre_tokenizer": (
                {"type": "ByteLevel", "add_prefix_space": False}
                if self.scheme == "byte_level"
                else {"type": "Metaspace"}
            ),
            "decoder": {"type": "ByteLevel"} if self.scheme == "byte_level" else None,
            "model": {
                "type": "BPE",
                "vocab": base,
                "merges": [f"{a} {b}" for a, b in self.ranks],
            },
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f, ensure_ascii=False)

    # ------------------------------------------------------------------ bpe

    def _bpe(self, piece: str) -> list[str]:
        if piece in self._cache:
            return self._cache[piece]
        parts = list(piece)
        while len(parts) > 1:
            best, best_rank = None, None
            for i in range(len(parts) - 1):
                r = self.ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            parts = parts[:best] + [parts[best] + parts[best + 1]] + parts[best + 2 :]
        if len(self._cache) < 65536:
            self._cache[piece] = parts
        return parts

    # --------------------------------------------------------------- encode

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        out: list[int] = []
        if add_bos and self.bos_token:
            out.append(self.vocab[self.bos_token])
        if self.scheme == "metaspace":
            pieces = [("▁" + text.replace(" ", "▁")) if text else ""]
        else:
            pieces = [
                "".join(self._byte_enc[b] for b in w.encode("utf-8"))
                for w in _gpt2_word_split(text)
            ]
        unk = self.vocab.get("<unk>")
        for piece in pieces:
            if not piece:
                continue
            for tok in self._bpe(piece):
                tid = self.vocab.get(tok)
                if tid is not None:
                    out.append(tid)
                elif self.scheme == "metaspace":
                    # sentencepiece byte-fallback: <0xNN> per utf-8 byte
                    for b in tok.encode("utf-8"):
                        fid = self.vocab.get(f"<0x{b:02X}>")
                        out.append(fid if fid is not None else (unk or 0))
                elif unk is not None:
                    out.append(unk)
        return out

    # --------------------------------------------------------------- decode

    def decode(self, ids: list[int], skip_special: bool = True) -> str:
        toks: list[str] = []
        for i in ids:
            tok = self.ids.get(int(i))
            if tok is None:
                continue
            if skip_special and tok in self.added:
                continue
            toks.append(tok)
        if self.scheme == "metaspace":
            buf: list[bytes] = []
            for tok in toks:
                if len(tok) == 6 and tok.startswith("<0x") and tok.endswith(">"):
                    buf.append(bytes([int(tok[3:5], 16)]))
                else:
                    buf.append(tok.encode("utf-8"))
            text = b"".join(buf).decode("utf-8", errors="replace")
            return text.replace("▁", " ").lstrip(" ")
        # chars outside the byte-level alphabet (special tokens kept in the
        # main vocab, non-byte-level vocabs read as byte_level) fall back to
        # their own utf-8 bytes instead of raising
        data = b"".join(
            bytes([self._byte_dec[c]]) if c in self._byte_dec else c.encode("utf-8")
            for tok in toks
            for c in tok
        )
        return data.decode("utf-8", errors="replace")

    @property
    def vocab_size(self) -> int:
        return max(self.vocab.values()) + 1

    @property
    def eos_id(self) -> int | None:
        return self.vocab.get(self.eos_token) if self.eos_token else None

    @property
    def bos_id(self) -> int | None:
        return self.vocab.get(self.bos_token) if self.bos_token else None
