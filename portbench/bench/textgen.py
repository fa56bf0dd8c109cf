"""Synthetic English-like text from a seed: the vocabulary, the pool of
chunk texts, the questions drawn from them, and the documents an uploader
sends.

The vocabulary stands in for bge-base's published ``vocab.txt``: 30,522
entries (the special tokens, punctuation, letters and their ``##``
pieces, whole words and ``##`` suffixes, then ``[unusedN]``). It is the
same for every seed (``VOCAB_SEED``), as a published one is. Words are
built from syllables; a third of the words a text uses carry one or two
suffixes that are not whole words in the vocabulary, so WordPiece splits
them, as it splits rarer English words. Word frequencies follow Zipf's
law. A 1,000-character text holds about 300 WordPiece tokens.

Every function here is pure host code over ``numpy.random.Generator``;
nothing reads the clock or the program."""

from __future__ import annotations

import numpy as np

VOCAB_SIZE = 30522
VOCAB_SEED = 20240521
SPECIAL = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
PUNCT = list(".,;:?!'()-")
LETTERS = list("abcdefghijklmnopqrstuvwxyz0123456789")
N_WORDS = 24576
N_SUFFIX = 512
_ONSET = [""] * 4 + list("bcdfghjklmnprstvwz") + ["ch", "sh", "th", "st", "tr"]
_VOWEL = list("aeiouaeiou") + ["ai", "ea", "ou"]
_CODA = [""] * 12 + list("nrstl")


def _syllable(rng: np.random.Generator) -> str:
    return (_ONSET[rng.integers(len(_ONSET))] + _VOWEL[rng.integers(len(_VOWEL))]
            + _CODA[rng.integers(len(_CODA))])


class Lexicon:
    """The vocabulary and the word inventory texts draw from."""

    def __init__(self):
        rng = np.random.default_rng(VOCAB_SEED)
        words: dict[str, None] = {}
        while len(words) < N_WORDS:
            n = min(int(rng.geometric(0.45)), 4)
            words["".join(_syllable(rng) for _ in range(n))] = None
        suffixes: dict[str, None] = {}
        while len(suffixes) < N_SUFFIX:
            suffixes[_syllable(rng)] = None
        # the most frequent words are the shortest, as in English
        self.words = sorted(words, key=len)
        self.suffixes = list(suffixes)
        base = SPECIAL + PUNCT + LETTERS + ["##" + c for c in LETTERS]
        vocab = list(dict.fromkeys(base + self.words + ["##" + s for s in self.suffixes]))
        if len(vocab) > VOCAB_SIZE:
            raise ValueError(f"{len(vocab)} entries do not fit a vocabulary of {VOCAB_SIZE}")
        self.vocab = vocab + [f"[unused{i}]" for i in range(VOCAB_SIZE - len(vocab))]
        rank = np.arange(1, N_WORDS + 1, dtype=np.float64)
        p = 1.0 / (rank + 2.7)
        self.word_cdf = np.cumsum(p / p.sum())

    def sentences(self, rng: np.random.Generator, n_chars: int) -> str:
        """Text of at least ``n_chars`` characters: sentences of 6-24
        words, a comma now and then, ending in full stops."""
        parts: list[str] = []
        total = 0
        while total < n_chars:
            n = int(rng.integers(6, 25))
            ids = np.minimum(np.searchsorted(self.word_cdf, rng.random(n)), N_WORDS - 1)
            suf = rng.random(n)
            s1, s2 = rng.integers(N_SUFFIX, size=(2, n))
            comma = rng.random(n) < 0.08
            words = []
            for j in range(n):
                word = self.words[ids[j]]
                if suf[j] < 0.55:
                    word += self.suffixes[s1[j]]
                    if suf[j] < 0.2:
                        word += self.suffixes[s2[j]]
                if comma[j] and 2 <= j < n - 2:
                    word += ","
                words.append(word)
            s = " ".join(words).capitalize() + "."
            parts.append(s)
            total += len(s) + 1
        return " ".join(parts)


def cut(text: str, n_chars: int) -> str:
    """``text`` cut to at most ``n_chars`` characters at a word boundary."""
    if len(text) <= n_chars:
        return text
    return text[: text.rfind(" ", 0, n_chars + 1)]


def pool_texts(lex: Lexicon, rng: np.random.Generator, n: int, chars: int) -> list[str]:
    """``n`` texts of just under ``chars`` characters (the KB's chunks)."""
    return [cut(lex.sentences(rng, chars + 200), chars) for _ in range(n)]


def questions(pool: list[list[str]], rng: np.random.Generator, n: int, median_words: float,
              sigma: float, max_words: int, min_words: int) -> list[str]:
    """``n`` spans of the pool texts' words: a text drawn uniformly, a
    lognormal length (median ``median_words``) clipped to [min, max] and
    to the text, a uniform start."""
    topic = rng.integers(len(pool), size=n)
    size = np.array([len(pool[t]) for t in topic])
    want = np.rint(median_words * np.exp(sigma * rng.standard_normal(n)))
    k = np.clip(want, min_words, np.minimum(max_words, size)).astype(np.int64)
    start = (rng.random(n) * (size - k + 1)).astype(np.int64)
    return [" ".join(pool[t][s:s + m])
            for t, s, m in zip(topic.tolist(), start.tolist(), k.tolist())]


def paragraphs(lex: Lexicon, rng: np.random.Generator, n: int, lo: int, hi: int) -> list[str]:
    """``n`` paragraphs of ``lo``-``hi`` characters."""
    return [cut(lex.sentences(rng, int(rng.integers(lo, hi)) + 100), hi)
            for _ in range(n)]


def document(paras: list[str], rng: np.random.Generator, median_chars: float, sigma: float,
             max_chars: int) -> str:
    """A document of lognormal length (median ``median_chars``, at most
    ``max_chars``): paragraphs of the shared pool in a seeded order, blank
    lines between them."""
    want = min(median_chars * float(np.exp(sigma * rng.standard_normal())), max_chars)
    out: list[str] = []
    total = 0
    while total < want:
        p = paras[int(rng.integers(len(paras)))]
        out.append(p)
        total += len(p) + 2
    return cut("\n\n".join(out), max_chars)
