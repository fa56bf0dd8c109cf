"""WordPiece tokenizer (BERT family), offline and vocab.txt-driven: a copy
of ``youtu_rag_tpu/models/wordpiece.py`` for the port.

Pretrained bge/gte/e5-style encoders (``models/pretrained.py``) need the
exact token ids their checkpoints were trained with. The pipeline is the
standard BERT one: text cleanup, CJK isolation, lowercase and accent
stripping, punctuation splitting, then greedy longest-match-first
WordPiece, matching ``transformers.BertTokenizer``.

The pure-Python path is the reference and is what runs where the
``tokenizers`` package is missing (the port does not require it); with
``tokenizers`` installed, ``tokenize`` and ``batch`` go through its Rust
WordPiece, which gives the same ids (``tests/test_torch_wordpiece.py``).
Interface-compatible with ``HashTokenizer`` (tokenize, encode,
encode_pair, batch), so ``TorchEmbedder`` and ``TorchReranker`` take
either; ``batch_pairs`` also returns the token-type ids of a pair.
"""

from __future__ import annotations

import unicodedata

import numpy as np


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII punctuation ranges (treat like BERT: includes ^ _ ` $ etc.)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def build_wordpiece_vocab(
    texts,
    vocab_size: int = 8192,
    lowercase: bool = True,
    min_pair_freq: int = 2,
) -> dict[str, int]:
    """Train a WordPiece vocabulary from raw texts (BPE merge algorithm).

    Words come from the same basic tokenization the tokenizer applies at
    encode time (cleanup, lowercase+accent strip, punctuation isolation),
    so train/serve tokenization agrees. Every byte-ish unit (single char
    and its '##'-continuation form) is included first — no word can hit
    [UNK] — then BPE merges grow frequent subwords until ``vocab_size``.

    A corpus vocabulary decomposes unseen identifiers ("ZX-9917-Q") into
    trained subwords where the hashing tokenizer gives them untrained
    random rows.
    """
    helper = WordPieceTokenizer.__new__(WordPieceTokenizer)
    helper.lowercase = lowercase

    word_freq: dict[str, int] = {}
    for t in texts:
        for w in WordPieceTokenizer.basic_tokenize(helper, t):
            word_freq[w] = word_freq.get(w, 0) + 1

    # each word = tuple of units; first unit bare, rest '##'-prefixed
    words: list[tuple[list[str], int]] = []
    unit_freq: dict[str, int] = {}
    for w, f in word_freq.items():
        units = [w[0]] + ["##" + c for c in w[1:]]
        words.append((units, f))
        for u in units:
            unit_freq[u] = unit_freq.get(u, 0) + f

    vocab_list = list(SPECIAL_TOKENS) + sorted(unit_freq)
    seen = set(vocab_list)

    # incremental BPE: pair counts, a pair -> word-index occurrence map so a
    # merge only reprocesses the words containing it, and a lazy max-heap so
    # picking the next merge is O(log P) instead of a full scan
    import heapq

    pair_freq: dict[tuple[str, str], int] = {}
    pair_words: dict[tuple[str, str], set[int]] = {}
    heap: list[tuple[int, tuple[str, str]]] = []

    def bump(pair: tuple[str, str], delta: int, word_i: int | None = None) -> None:
        f = pair_freq.get(pair, 0) + delta
        pair_freq[pair] = f
        if word_i is not None:
            pair_words.setdefault(pair, set()).add(word_i)
        if f > 0:
            # push on every change (also decrements) so the live count is
            # always somewhere in the heap; stale entries skip on pop
            heapq.heappush(heap, (-f, pair))

    def word_pairs(i: int, sign: int) -> None:
        units, f = words[i]
        for a, b in zip(units, units[1:]):
            bump((a, b), sign * f, i if sign > 0 else None)

    for i in range(len(words)):
        word_pairs(i, +1)

    while len(vocab_list) < vocab_size and heap:
        negf, (a, b) = heapq.heappop(heap)
        f = pair_freq.get((a, b), 0)
        if f != -negf or f <= 0:
            continue  # stale heap entry
        if f < min_pair_freq:
            break
        merged = a + b[2:] if b.startswith("##") else a + b
        if merged not in seen:
            vocab_list.append(merged)
            seen.add(merged)
        for i in list(pair_words.get((a, b), ())):
            units, wf = words[i]
            word_pairs(i, -1)
            out = []
            j = 0
            while j < len(units):
                if j + 1 < len(units) and units[j] == a and units[j + 1] == b:
                    out.append(merged)
                    j += 2
                else:
                    out.append(units[j])
                    j += 1
            words[i] = (out, wf)
            word_pairs(i, +1)
        pair_freq.pop((a, b), None)
        pair_words.pop((a, b), None)

    return {tok: i for i, tok in enumerate(vocab_list[:vocab_size])}


def save_vocab(vocab: dict[str, int], path) -> None:
    """vocab.txt in id order (BERT convention; load_vocab round-trips)."""
    items = sorted(vocab.items(), key=lambda kv: kv[1])
    with open(path, "w", encoding="utf-8") as f:
        for tok, _ in items:
            f.write(tok + "\n")


def load_vocab(path) -> dict[str, int]:
    """vocab.txt → {token: id} (id = line number, BERT convention)."""
    vocab: dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok and tok not in vocab:
                vocab[tok] = i
    return vocab



def _fast_wordpiece(vocab: dict[str, int], lowercase: bool, unk_token: str,
                    max_chars_per_word: int):
    """The ``tokenizers`` (Rust) WordPiece with BERT's normalizer and
    pre-tokenizer, or None where the package is missing."""
    try:
        from tokenizers import Tokenizer
        from tokenizers.models import WordPiece
        from tokenizers.normalizers import BertNormalizer
        from tokenizers.pre_tokenizers import BertPreTokenizer
    except ImportError:
        return None
    tk = Tokenizer(WordPiece(vocab, unk_token=unk_token,
                             max_input_chars_per_word=max_chars_per_word))
    tk.normalizer = BertNormalizer(lowercase=lowercase, strip_accents=lowercase,
                                   handle_chinese_chars=True, clean_text=True)
    tk.pre_tokenizer = BertPreTokenizer()
    return tk


class WordPieceTokenizer:
    """BERT basic + WordPiece tokenization over a fixed vocabulary."""

    def __init__(
        self,
        vocab: dict[str, int] | str,
        lowercase: bool = True,
        max_length: int = 512,
        unk_token: str = "[UNK]",
        cls_token: str = "[CLS]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
        max_chars_per_word: int = 100,
        use_fast: bool = True,
    ):
        if isinstance(vocab, (str, bytes)) or hasattr(vocab, "__fspath__"):
            vocab = load_vocab(vocab)
        self.vocab = vocab
        self.lowercase = lowercase
        self.max_length = max_length
        self.max_chars_per_word = max_chars_per_word
        self.unk_id = vocab[unk_token]
        self.cls_id = vocab[cls_token]
        self.sep_id = vocab[sep_token]
        self.pad_id = vocab.get(pad_token, 0)
        self.vocab_size = max(vocab.values()) + 1
        # the Rust WordPiece where `tokenizers` is installed; the pure-Python
        # pipeline below stays the reference (the same ids)
        self._fast = (_fast_wordpiece(vocab, lowercase, unk_token, max_chars_per_word)
                      if use_fast else None)

    # -- basic tokenization -------------------------------------------------

    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            if _is_cjk(cp):
                out.append(f" {ch} ")
            elif _is_whitespace(ch):
                out.append(" ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(token: str) -> str:
        return "".join(
            ch for ch in unicodedata.normalize("NFD", token)
            if unicodedata.category(ch) != "Mn"
        )

    def basic_tokenize(self, text: str) -> list[str]:
        tokens: list[str] = []
        for word in self._clean(text).split():
            if self.lowercase:
                word = self._strip_accents(word.lower())
            # split each punctuation char into its own token
            cur: list[str] = []
            for ch in word:
                if _is_punctuation(ch):
                    if cur:
                        tokens.append("".join(cur))
                        cur = []
                    tokens.append(ch)
                else:
                    cur.append(ch)
            if cur:
                tokens.append("".join(cur))
        return tokens

    # -- wordpiece ----------------------------------------------------------

    def wordpiece(self, word: str) -> list[str]:
        """Greedy longest-match-first subword split; [UNK] on failure."""
        if len(word) > self.max_chars_per_word:
            return ["[UNK]"]
        pieces: list[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return ["[UNK]"]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize_words(self, text: str) -> list[str]:
        """Full pipeline → wordpiece strings (BertTokenizer.tokenize parity)."""
        out: list[str] = []
        for word in self.basic_tokenize(text):
            out.extend(self.wordpiece(word))
        return out

    # -- HashTokenizer-compatible interface ---------------------------------

    def tokenize(self, text: str) -> list[int]:
        if self._fast is not None:
            return list(self._fast.encode(text).ids)
        return [self.vocab.get(p, self.unk_id) for p in self.tokenize_words(text)]

    def encode(self, text: str, max_length: int | None = None) -> list[int]:
        """[CLS] tokens [SEP], truncated to max_length."""
        max_length = max_length or self.max_length
        toks = self.tokenize(text)[: max_length - 2]
        return [self.cls_id] + toks + [self.sep_id]

    def encode_pair(self, a: str, b: str, max_length: int | None = None) -> list[int]:
        """[CLS] a [SEP] b [SEP] — cross-encoder input (query gets ≤1/3)."""
        max_length = max_length or self.max_length
        ta = self.tokenize(a)
        tb = self.tokenize(b)
        budget = max_length - 3
        ta = ta[: budget // 3]
        tb = tb[: budget - len(ta)]
        return [self.cls_id] + ta + [self.sep_id] + tb + [self.sep_id]

    def batch(
        self, texts: list[str], max_length: int | None = None, pad_to: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Encode + pad a batch → (ids [B, T] int32, mask [B, T] f32).
        One Rust encode_batch call when the fast backend is active."""
        max_length = max_length or self.max_length
        if self._fast is not None:
            encs = self._fast.encode_batch(texts)
            seqs = [
                [self.cls_id] + list(e.ids[: max_length - 2]) + [self.sep_id]
                for e in encs
            ]
        else:
            seqs = [self.encode(t, max_length) for t in texts]
        t = pad_to or max(len(s) for s in seqs)
        ids = np.full((len(seqs), t), self.pad_id, np.int32)
        mask = np.zeros((len(seqs), t), np.float32)
        for i, s in enumerate(seqs):
            ids[i, : len(s)] = s
            mask[i, : len(s)] = 1.0
        return ids, mask

    def batch_pairs(
        self, pairs: list[tuple[str, str]], max_length: int | None = None,
        pad_to: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Encode (a, b) pairs → (ids, mask, type_ids): segment 1 starts
        after the first [SEP] (BERT token-type convention)."""
        max_length = max_length or self.max_length
        seqs = [self.encode_pair(a, b, max_length) for a, b in pairs]
        t = pad_to or max(len(s) for s in seqs)
        ids = np.full((len(seqs), t), self.pad_id, np.int32)
        mask = np.zeros((len(seqs), t), np.float32)
        types = np.zeros((len(seqs), t), np.int32)
        for i, s in enumerate(seqs):
            ids[i, : len(s)] = s
            mask[i, : len(s)] = 1.0
            first_sep = s.index(self.sep_id)
            types[i, first_sep + 1 : len(s)] = 1
        return ids, mask, types
