"""Synthetic ReAct-trajectory generator for training the local chat LM.

A copy of ``youtu_rag_tpu/models/lm_synth.py`` that renders through the
port's serving code (``tools/kb_search.py``'s ``KBSearchToolkit``,
``agents/react.py``'s ``ReactChatClient._convert_messages``,
``agents/local_llm.py``'s ``render_chat("plain")``): the same seed gives
the same episodes and the same samples, byte for byte, in both packages
(``python -m youtu_rag_tpu_torch.train_chat_lm``).

The reference's chat quality rides on an external LLM service it never
trains (env contract at ``utu/__init__.py:8``); the TPU build owns its
decoder (models/decoder.py), so it also owns the data that teaches the
decoder the agent loop. This module synthesizes knowledge-base QA episodes
in the EXACT text format the serving stack produces:

- tool schemas render through the real ``KBSearchToolkit`` →
  ``ReactChatClient._convert_messages`` → ``render_chat("plain")`` path
  (any drift between training and serving formats is a silent quality
  cliff — reusing the serving code makes drift impossible);
- observations use ``tools/kb_search._format_results``'s layout
  (``[rank] (score 0.xxx, source f.md)\\ncontent``);
- entities/values are random pseudo-words, so the model can only succeed
  by COPYING from the prompt (question → Action Input query; observation
  value → Final Answer) — the grounded-extraction skill RAG needs, not
  memorization.

Each episode yields two training samples (the two assistant completions of
the agent loop):
  turn 1: system+question                      → Thought/Action/Action Input
  turn 2: … +assistant action +Observation     → Thought/Final Answer
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass

from ..agents.llm import ChatMessage, ToolCall

# one fixed instruction string shared by training and the serving entry
# points (cli_chat.py, serve_api.py); divergence would shift the system prompt
# the tiny model was trained against
DEFAULT_KB_INSTRUCTIONS = (
    "You are a helpful assistant. Use the kb_embedding_search tool to "
    "look up facts from the knowledge base before answering."
)

THOUGHT_SEARCH = "I should look this up in the knowledge base."
THOUGHT_ANSWER = "The observation contains the answer."

_CONS = "bcdfgklmnprstvz"
_VOWS = "aeiou"

ATTRS = [
    "color", "mass", "code", "owner", "status", "price", "origin",
    "rank", "voltage", "length", "capacity", "model", "category", "weight",
]

_FACT_TEMPLATES = [
    "The {attr} of {ent} is {val}.",
    "{ent} has a {attr} of {val}.",
    "For {ent}, the {attr} is {val}.",
]

_QUESTION_TEMPLATES = [
    "What is the {attr} of {ent}?",
    "what {attr} does {ent} have?",
    "Tell me the {attr} of {ent}.",
]


def _word(rng: random.Random, syllables: int | None = None) -> str:
    n = syllables or rng.randint(2, 3)
    return "".join(rng.choice(_CONS) + rng.choice(_VOWS) for _ in range(n))


def _entity(rng: random.Random) -> str:
    ent = _word(rng).capitalize()
    if rng.random() < 0.4:
        ent += f"-{rng.randint(1, 99)}"
    return ent


def _value(rng: random.Random) -> str:
    r = rng.random()
    if r < 0.35:
        return _word(rng)
    if r < 0.6:  # identifier code
        letters = "".join(rng.choice("ABCDEFGHJKLMNPQRSTUVWXYZ") for _ in range(2))
        return f"{letters}-{rng.randint(100, 9999)}"
    if r < 0.85:  # number + unit
        unit = rng.choice(["kg", "mm", "volts", "units", "credits"])
        return f"{rng.randint(2, 950)} {unit}"
    return f"{_word(rng)} {_word(rng)}"


@dataclass
class Episode:
    question: str
    answer: str
    gold_chunk: str
    distractors: list[str]
    observation: str
    source: str
    query: str = ""  # the tool-call query the model should emit
    gold_sentence: str = ""  # the exact fact sentence holding the answer
    attr: str = ""
    ent: str = ""


def _chunk_text(rng: random.Random, facts: list[tuple[str, str, str]]) -> str:
    lines = []
    for ent, attr, val in facts:
        t = rng.choice(_FACT_TEMPLATES)
        lines.append(t.format(attr=attr, ent=ent, val=val))
    return " ".join(lines)


def synth_episode(
    rng: random.Random, top_k: int | None = None, easy: bool | None = None
) -> Episode:
    """One KB-QA episode: gold fact among distractor facts/chunks.

    Difficulty ladder (the round-4 two-tier mix — 30% trivial, 70% full
    confuser soup — plateaued: the model learned "copy the only value
    present" at 0.88 but never the joint (entity, attr) fact selection,
    ~0.1 on any-confuser episodes. A MEDIUM rung gives the selection
    circuit a gradient path):
      easy   20%  single gold chunk, single fact, short entity/value;
      medium 35%  gold chunk + 1-2 sibling facts, ≤1 distractor chunk —
                  selection among FEW candidates;
      hard   45%  1-3 sibling confusers + top_k-1 distractor chunks.
    ``easy`` (bool) is kept for compat: True → easy, False → hard.
    ``top_k`` defaults to a random 3–6 so training observations cover the
    serving default (kb_embedding_search top_k=5) and nearby lengths."""
    if top_k is None:
        top_k = rng.randint(3, 6)
    if easy is None:
        r = rng.random()
        tier = "easy" if r < 0.2 else ("medium" if r < 0.55 else "hard")
    else:
        tier = "easy" if easy else "hard"
    easy = tier == "easy"
    ent = _word(rng, 1).capitalize() if easy else _entity(rng)
    attr = rng.choice(ATTRS)
    val = _word(rng, 1) if easy else _value(rng)

    # the gold chunk holds the asked fact plus sibling facts — some about
    # the SAME entity with other attrs, some about other entities with the
    # SAME attr (the model must match on both to find the value)
    n_siblings = {"easy": 0, "medium": rng.randint(1, 2), "hard": rng.randint(1, 3)}[tier]
    facts = [(ent, attr, val)]
    for _ in range(n_siblings):
        if rng.random() < 0.5:
            other = rng.choice([a for a in ATTRS if a != attr])
            facts.append((ent, other, _value(rng)))
        else:
            facts.append((_entity(rng), attr, _value(rng)))
    rng.shuffle(facts)
    # render per-sentence so the episode records the exact gold sentence —
    # the turn-2 target quotes it (copy-then-extract decomposition below)
    sents, gold_sentence = [], ""
    for f_ent, f_attr, f_val in facts:
        s = rng.choice(_FACT_TEMPLATES).format(attr=f_attr, ent=f_ent, val=f_val)
        if (f_ent, f_attr, f_val) == (ent, attr, val) and not gold_sentence:
            gold_sentence = s
        sents.append(s)
    gold = " ".join(sents)

    # The observation ALWAYS has top_k blocks, whatever the tier: serving
    # returns top_k results for every query, so the tier may shape only the
    # GOLD CHUNK's internal difficulty (sibling confusers), never the
    # observation length — the model that trained on 1-block easy-tier
    # observations collapsed 0.27 (in-dist) → 0.0 exact when the real loop
    # handed it 5 blocks for every question.
    distractors = []
    for _ in range(top_k - 1):
        # SERVING-PARITY negatives: at inference the non-gold slots are the
        # retriever's nearest neighbors of the query — chunks that mention
        # the asked ATTRIBUTE (with other entities/values) dominate, not
        # random facts. Random negatives here let the model get away with
        # "find the attr word anywhere" (in-dist 0.16 vs real-loop 0.02
        # measured); attr-matched negatives force true (entity, attr)
        # conjunction matching.
        dfacts = [
            (_entity(rng), attr if rng.random() < 0.6 else rng.choice(ATTRS),
             _value(rng))
            for _ in range(rng.randint(1, 3))
        ]
        distractors.append(_chunk_text(rng, dfacts))

    question = rng.choice(_QUESTION_TEMPLATES).format(attr=attr, ent=ent)
    # serving parity: the API chat route prepends a KB reference line to the
    # user query (api/app.py::_modify_query, ref chat_service.py:486-623) —
    # train on that shape so the HTTP path is in-distribution too
    if rng.random() < 0.3:
        kb_name = (
            rng.choice(["demo", "default", "docs", "kb1"])
            if rng.random() < 0.5 else _word(rng)
        )
        question = f"[knowledge base: {kb_name}]\n{question}"

    # observation in tools/kb_search._format_results layout, gold at a
    # random rank with plausibly descending scores
    chunks = distractors[:]
    gold_rank = rng.randint(1, top_k)
    chunks.insert(gold_rank - 1, gold)
    score = rng.uniform(0.45, 0.9)
    blocks = []
    source = f"facts_{rng.randint(0, 99):02d}.md"
    for i, c in enumerate(chunks):
        src = source if i == gold_rank - 1 else f"facts_{rng.randint(0, 99):02d}.md"
        blocks.append(f"[{i + 1}] (score {score:.3f}, source {src})\n{c}")
        score -= rng.uniform(0.01, 0.12)
    return Episode(
        question=question,
        answer=val,
        gold_chunk=gold,
        distractors=distractors,
        observation="\n\n".join(blocks),
        source=source,
        # the query target is the FULL question body, verbatim: a whole-line
        # copy is the easiest induction pattern a tiny model can learn
        # (the round-4 2-token selective-extraction target never rose above
        # ~0.06 query_exact — selecting (entity, attribute) out of the
        # question is the same binding problem the answer turn struggles
        # with, while verbatim line continuation is vanilla induction).
        # Retrieval is unhurt: the template words are corpus-wide and IDF-
        # downweighted; entity+attribute terms dominate the lexical match.
        # LEADING SPACE on purpose: in the question every word appears as a
        # space-prefixed byte-level BPE token (" Tell", " Lefobo"); inside
        # the JSON string the first word would otherwise be quote-prefixed
        # ("Tell") — a DIFFERENT token, which breaks the induction-head
        # copy circuit at position 0.
        query=" " + question.rsplit("\n", 1)[-1],
        gold_sentence=gold_sentence,
        attr=attr,
        ent=ent,
    )


def _tool_schemas() -> list[dict]:
    from ..tools.base import ToolkitConfig
    from ..tools.kb_search import KBSearchToolkit

    # schema rendering never resolves the kb — a None placeholder is fine
    tk = KBSearchToolkit(ToolkitConfig(config={"kb": None}))
    return tk.get_tools_in_openai()


def render_episode_samples(
    ep: Episode, tools: list[dict], instructions: str = DEFAULT_KB_INSTRUCTIONS
) -> list[tuple[str, str]]:
    """Episode → [(prompt_text, completion_text)] through the REAL serving
    renderers (ReactChatClient message conversion + plain chat template)."""
    from ..agents.local_llm import render_chat
    from ..agents.react import ReactChatClient

    args = json.dumps({"query": ep.query or ep.question})
    target1 = (
        f"Thought: {THOUGHT_SEARCH}\n"
        f"Action: kb_embedding_search\nAction Input: {args}"
    )
    # Copy-then-extract decomposition: monolithic "Final Answer: {val}"
    # asks a ~4M-param model to solve (entity, attr) → value binding in ONE
    # hop across the whole observation — measured ceiling ~0.11 exact.
    # Chaining three easy copies instead: (1) re-emit attr+ent from the
    # question (same induction skill as the turn-1 query copy, which the
    # model learns to ~1.0); (2) quote the sentence containing BOTH
    # just-emitted cue tokens (match-then-copy keyed on local context);
    # (3) extract the value from the 10-20-token sentence it just wrote —
    # a LOCAL grammar hop instead of a global binding hop.
    if ep.attr and ep.ent and ep.gold_sentence:
        target2 = (
            f"Thought: The question asks for the {ep.attr} of {ep.ent}. "
            f'The observation says: "{ep.gold_sentence}"\n'
            f"Final Answer: {ep.answer}"
        )
    else:  # episodes built without sentence provenance (back-compat)
        target2 = f"Thought: {THOUGHT_ANSWER}\nFinal Answer: {ep.answer}"

    msgs1 = [
        ChatMessage(role="system", content=instructions),
        ChatMessage(role="user", content=ep.question),
    ]
    conv1 = ReactChatClient._convert_messages(msgs1, tools)
    prompt1 = render_chat(conv1, "plain")

    msgs2 = msgs1 + [
        ChatMessage(
            role="assistant",
            content=None,
            tool_calls=[ToolCall("react_0", "kb_embedding_search", args)],
        ),
        ChatMessage(role="tool", content=ep.observation),
    ]
    conv2 = ReactChatClient._convert_messages(msgs2, tools)
    prompt2 = render_chat(conv2, "plain")
    return [(prompt1, target1), (prompt2, target2)]


def synth_corpus(
    n_episodes: int, seed: int = 0, top_k: int = 3
) -> tuple[list[tuple[str, str]], list[Episode]]:
    """n episodes → 2n (prompt, completion) samples + the raw episodes."""
    rng = random.Random(seed)
    tools = _tool_schemas()
    samples: list[tuple[str, str]] = []
    episodes: list[Episode] = []
    for _ in range(n_episodes):
        ep = synth_episode(rng, top_k=top_k)
        episodes.append(ep)
        samples.extend(render_episode_samples(ep, tools))
    return samples, episodes
