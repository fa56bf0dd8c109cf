"""Synthetic paraphrase corpus: zero query↔document lexical overlap.

A copy of ``youtu_rag_tpu/models/paraphrase_synth.py``: the same seed
gives the same lexicon, pairs and fixture in both packages, ``TRAIN_SEED``
included (``python -m youtu_rag_tpu_torch.train_embedder --paraphrase``).

The reference rides production embedding services whose *semantic* quality
comes from pretraining — "vessel" retrieves documents that only say "ship"
(``utu/rag/embeddings/service_embedder.py:16-177``). The in-repo encoder's
committed wins ride a sparse lexical channel (models/encoder.py lex_buckets),
which proves exact-identifier recall but says nothing about the contextual
half. This module makes that half measurable:

- a deterministic LEXICON of concept pairs ``(a_form, b_form)`` — two
  pseudo-word vocabularies naming the same concepts;
- documents written exclusively in a-forms, queries exclusively in b-forms
  (plus disjoint template/filler words), so BM25 and the hash embedder
  score at chance BY CONSTRUCTION;
- training pairs (query_b → passage_a) for the encoder finetune
  (scripts/train_embedder.py --paraphrase): InfoNCE aligns the two forms
  the way co-occurrence pretraining aligns real synonyms.

Honesty note: the lexicon is shared between training and evaluation —
synonym knowledge has to come from somewhere, exactly as a production
embedder knows ship≈vessel from pretraining. What is held out is every
evaluation DOCUMENT, QUERY, and concept COMBINATION: the fixture seed is
disjoint from the training seed, and a collision guard drops any eval combo
seen in training.
"""

from __future__ import annotations

import random

# canonical training spec shared by scripts/train_embedder.py --paraphrase
# and scripts/bench_quality.py's fixture generation: the fixture excludes
# every concept combination these pairs use, so committed eval numbers
# always measure generalization to unseen combinations
TRAIN_SEED = 101
TRAIN_PAIRS_DEFAULT = 4000

# consonant/vowel pools chosen so the two forms share no subword pieces of
# length ≥2 in practice (disjoint consonant sets)
_CONS_A = "bdgklmnprst"
_CONS_B = "fvzcjwqxh"
_VOWS = "aeiou"

# template vocabularies, disjoint between sides: doc prose never uses the
# query words and vice versa
_DOC_TEMPLATES = [
    "The {a0} stood beside the {a1}.",
    "Inspectors noted the {a0} next to the {a1} during the visit.",
    "A damaged {a0} was moved away from the {a1} last season.",
    "Both the {a0} and the {a1} appear in the ledger.",
    "The {a0} remained in storage near the {a1}.",
]
_DOC_SINGLE = [
    "The {a} was catalogued without remark.",
    "Maintenance for the {a} continued per schedule.",
    "The {a} drew little attention that month.",
]
_QUERY_TEMPLATES = [
    "which entry involves {b0}, {b1} or {b2}?",
    "find mentions of {b0}, {b1} or {b2}",
    "info about {b0} together with {b1} or {b2}",
]


def _word(rng: random.Random, cons: str, syllables: int) -> str:
    return "".join(rng.choice(cons) + rng.choice(_VOWS) for _ in range(syllables))


def paraphrase_lexicon(n: int = 160, seed: int = 11) -> list[tuple[str, str]]:
    """n concept pairs (a_form, b_form); both forms unique within and
    across vocabularies."""
    rng = random.Random(seed)
    seen: set[str] = set()
    pairs: list[tuple[str, str]] = []
    while len(pairs) < n:
        a = _word(rng, _CONS_A, rng.randint(2, 3))
        b = _word(rng, _CONS_B, rng.randint(2, 3))
        if a in seen or b in seen:
            continue
        seen.add(a)
        seen.add(b)
        pairs.append((a, b))
    return pairs


def _doc_text(rng: random.Random, a_forms: list[str]) -> str:
    """3-concept document in a-vocabulary prose."""
    sents = []
    t = rng.choice(_DOC_TEMPLATES)
    sents.append(t.format(a0=a_forms[0], a1=a_forms[1]))
    sents.append(rng.choice(_DOC_SINGLE).format(a=a_forms[2]))
    t2 = rng.choice(_DOC_TEMPLATES)
    sents.append(t2.format(a0=a_forms[2], a1=a_forms[0]))
    return " ".join(sents)


def _query_text(rng: random.Random, b_forms: list[str]) -> str:
    t = rng.choice(_QUERY_TEMPLATES)
    return t.format(b0=b_forms[0], b1=b_forms[1], b2=b_forms[2])


def _combo(rng: random.Random, n_concepts: int) -> tuple[int, ...]:
    return tuple(sorted(rng.sample(range(n_concepts), 3)))


def gen_paraphrase_pairs(
    n_pairs: int, seed: int = 101, lexicon: list[tuple[str, str]] | None = None
) -> tuple[list[dict], set[tuple[int, ...]]]:
    """Training pairs {"query": b-form question, "positive": a-form passage}.
    Returns (pairs, combos_used) so fixture generation can hold out."""
    lex = lexicon or paraphrase_lexicon()
    rng = random.Random(seed)
    pairs, used = [], set()
    while len(pairs) < n_pairs:
        combo = _combo(rng, len(lex))
        used.add(combo)
        a = [lex[i][0] for i in combo]
        b = [lex[i][1] for i in combo]
        rng.shuffle(b)
        pairs.append({"query": _query_text(rng, b), "positive": _doc_text(rng, a)})
    return pairs, used


def gen_paraphrase_fixture(
    n_docs: int = 150,
    seed: int = 7,
    lexicon: list[tuple[str, str]] | None = None,
    exclude: set[tuple[int, ...]] | None = None,
) -> tuple[list[dict], list[dict]]:
    """Evaluation fixture: docs (a-forms) + qrels (b-form queries).

    Every document's concept combination is unique and outside ``exclude``
    (the training combos), so evaluation measures generalization to unseen
    combinations, not memorized pairs."""
    lex = lexicon or paraphrase_lexicon()
    rng = random.Random(seed)
    exclude = set(exclude or ())
    docs, qrels, seen = [], [], set()
    while len(docs) < n_docs:
        combo = _combo(rng, len(lex))
        if combo in seen or combo in exclude:
            continue
        seen.add(combo)
        a = [lex[i][0] for i in combo]
        b = [lex[i][1] for i in combo]
        rng.shuffle(b)
        did = f"para_doc_{len(docs)}"
        docs.append({
            "id": did,
            "content": _doc_text(rng, a),
            "metadata": {"combo": "-".join(map(str, combo))},
        })
        qrels.append({"query": _query_text(rng, b), "relevant": [did]})
    return docs, qrels
