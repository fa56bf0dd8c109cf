"""Synthetic training pairs for identifier-grounded retrieval.

A copy of ``youtu_rag_tpu/models/data_synth.py``: the same seed gives the
same pairs in both packages (``python -m youtu_rag_tpu_torch.train_embedder
--synthetic``).

The reference leans on production embedding services for needle-style
retrieval quality (utu/rag/embeddings/service_embedder.py:16-177 — its
FactGuard / Sequential-NIAH rows ride on those weights). This build trains
its own encoder, and the skill those benchmarks demand — carrying an exact
identifier ("unit KL-4407") from a question into the one chunk that
mentions it, against hundreds of near-duplicate chunks — does not emerge
from plain ICT over prose. This module manufactures that skill:

- ``gen_identifier_pairs`` emits (query, positive) pairs in *sibling
  groups*: each group shares one template (same attribute, same prose
  shape) and differs ONLY in identifier + value. Batched together, the
  in-batch InfoNCE negatives become hard negatives that force subword-level
  discrimination of identifiers.
- Identifier shapes, attributes and prose templates are deliberately
  disjoint from the committed evaluation fixtures
  (scripts/bench_quality.py `gen_niah`/`gen_factguard`): the model learns
  the *skill*, not the test set.
"""

from __future__ import annotations

import random

# attribute vocabulary — no overlap with the fixtures' "registry number
# assigned to" / "Engineering records confirm ... completed in/spans/cost/
# employs" phrasings
_ATTRS = [
    "calibration offset", "batch lot", "inventory tag", "license key",
    "part number", "build checksum", "tracking reference", "voltage rating",
    "firmware revision", "warranty term", "shipment weight", "storage bin",
    "maintenance interval", "pressure limit", "serial suffix", "order total",
]

_DOC_TMPLS = [
    "Maintenance log for unit {eid}. Routine inspection found no anomalies. "
    "The {attr} recorded for unit {eid} is {val}. Technician notes were "
    "filed with the shift supervisor.",
    "Asset sheet: device {eid}. Commissioned under the standard program. "
    "For device {eid} the {attr} reads {val}. Next review follows the "
    "usual cycle.",
    "Inspection summary covering module {eid}. All checks passed on the "
    "first attempt. Records list the {attr} of module {eid} as {val}. "
    "No follow-up actions were raised.",
    "Operations bulletin regarding component {eid}. Deployment proceeded "
    "on schedule. The listed {attr} for component {eid} equals {val}. "
    "Contact the duty desk for clarifications.",
]

_QUERY_TMPLS = [
    "What is the {attr} recorded for {eid}?",
    "Find the {attr} of {eid}.",
    "Look up the {attr} for unit {eid}.",
    "{eid}: what {attr} is listed?",
]

_WORDS = [
    "rotor", "valve", "sensor", "probe", "relay", "gasket", "nozzle",
    "bearing", "coupler", "manifold", "spindle", "damper", "filter",
]

_LETTERS = "ABCDEFGHJKLMNPQRSTUVWXYZ"


def _make_id(rng: random.Random) -> str:
    """Random identifier in one of several shapes (letters+digits mixes)."""
    shape = rng.randrange(5)
    if shape == 0:  # KL-4407
        return f"{rng.choice(_LETTERS)}{rng.choice(_LETTERS)}-{rng.randrange(1000, 9999)}"
    if shape == 1:  # valve_88x
        return f"{rng.choice(_WORDS)}_{rng.randrange(10, 99)}{rng.choice('xyzqw')}"
    if shape == 2:  # R7-beta-512
        return f"{rng.choice(_LETTERS)}{rng.randrange(1, 9)}-{rng.choice(['alpha', 'beta', 'gamma', 'delta'])}-{rng.randrange(100, 999)}"
    if shape == 3:  # 40218-C
        return f"{rng.randrange(10000, 99999)}-{rng.choice(_LETTERS)}"
    return f"{rng.choice(_WORDS)}-{rng.choice(_LETTERS)}{rng.randrange(100, 999)}"  # probe-M204


def _make_val(rng: random.Random) -> str:
    shape = rng.randrange(4)
    if shape == 0:
        return str(rng.randrange(100, 99999))
    if shape == 1:
        return f"{rng.randrange(1, 400)}.{rng.randrange(0, 99):02d}"
    if shape == 2:
        return f"{rng.choice(_LETTERS)}{rng.choice(_LETTERS)}{rng.randrange(1000, 9999)}"
    return f"v{rng.randrange(1, 9)}.{rng.randrange(0, 20)}"


def gen_identifier_pairs(
    n_groups: int = 512,
    siblings: int = 4,
    seed: int = 0,
) -> list[dict]:
    """(query, positive) pairs in sibling groups of hard negatives.

    Returns dicts {"query", "positive", "group"}; every pair in a group
    uses the same document/query template and attribute but a different
    identifier and value — batch siblings together so in-batch negatives
    are maximally confusable except for the identifier subwords.
    """
    rng = random.Random(seed)
    out: list[dict] = []
    for g in range(n_groups):
        attr = rng.choice(_ATTRS)
        doc_t = rng.choice(_DOC_TMPLS)
        q_t = rng.choice(_QUERY_TMPLS)
        used: set[str] = set()
        for _ in range(siblings):
            eid = _make_id(rng)
            while eid in used:
                eid = _make_id(rng)
            used.add(eid)
            val = _make_val(rng)
            out.append(
                {
                    "query": q_t.format(attr=attr, eid=eid),
                    "positive": doc_t.format(attr=attr, eid=eid, val=val),
                    "group": g,
                }
            )
    return out
