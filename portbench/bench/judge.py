"""Decides ``correct``: the numbers compared between what the timed path
produced and the plain reference (``portbench/reference``), worked out
once the window has closed, the peak memory read and the program's state
freed.

Question cells (``qa``), over a seeded sample of the finished questions
with the longest among them:

- ``missing``: sampled questions answered with fewer than top-k results;
- ``emb_err``: the widest L2 distance between a served query embedding
  and the reference's (f32, TF32 off) of the same question;
- ``dense_gap``: the widest gap by which the reference's score of a served
  dense hit lies below the reference's best at its rank, over the exact
  top-k of every row as the tier stores it (the cross-encoder's
  candidates where the cell reranks, else the results);
- ``score_err``: the widest gap between a served result's score and the
  reference's score of the same result (the cross-encoder's where the cell
  reranks, else the dense score); where the cell reranks, also between the
  program's cross-encoder score of every candidate and the reference's;
- ``order_diff`` (cells that rerank): sampled questions whose results are
  not in falling order of their served scores;
- ``cut_gap`` (cells that rerank): the widest margin by which the
  program's own score of a candidate the cut left out lies above the
  lowest served score: the served results have to be the top-k of the
  program's scores.

The program's score of every candidate comes from its public ``rerank``
with no cut, called again after the window on the candidates as the timed
path handed them over (``Served.scores``); a cross-encoder forward of one
question's pairs gives the same bits each time, so ``order_diff`` and
``cut_gap`` are exact. The reference cannot judge the order itself: with
random weights the cross-encoder's scores of ten candidates lie within
0.02-0.04 of each other, the width of the program's bf16 rounding.

Ingest cells, over every document of the calls that finished:

- ``chunk_diff``: documents whose stored chunks are not the reference
  splitter's (by the builder's chunk ids, md5 of document, index and
  text, and the document's chunk count);
- ``emb_err``: the widest L2 distance between a stored row and the
  reference's embedding of its chunk, over a seeded sample with the
  longest chunk (a sampled chunk the index lacks reads infinite);
- ``lexical_diff`` (a store with BM25): sampled chunks whose BM25 record
  (live, length, terms, and each term's count in its posting) is not the
  reference's term count of the chunk (``reference/terms.py``).

A sample is a list of ``Served`` records, so the control (the reference
at a lower precision put in the program's place) is judged by the same
functions."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np
import torch

from ..reference import chunker, terms, topk
from ..reference.bert import Bert, no_tf32
from . import weights


@dataclass
class Served:
    """One sampled question as served: its text, query embedding, the
    dense candidates (row id, text, score), the results, and the
    program's cross-encoder score of each candidate by id."""

    question: str
    emb: np.ndarray | None
    candidates: list = field(default_factory=list)
    results: list = field(default_factory=list)
    scores: dict | None = None


def row_id(chunk_id: str) -> int:
    return int(chunk_id[1:])


def sample_ids(done: list[int], lengths: dict[int, int], seed: int, limit: int) -> list[int]:
    """Up to ``limit`` of ``done``: the longest first, then a seeded draw."""
    if not done:
        return []
    longest = max(done, key=lambda i: (lengths[i], -i))
    rest = [i for i in done if i != longest]
    rng = np.random.default_rng([seed, 7])
    pick = rng.permutation(len(rest))[: max(limit - 1, 0)]
    return [longest] + [rest[j] for j in sorted(pick)]


class Reference:
    """The reference models of a fixture, on its device."""

    def __init__(self, fx, precision: str = "f32"):
        no_tf32()
        self.fx = fx
        dev = fx.device
        self.emb = Bert(weights.state(fx.emb_flat.to(dev), fx.emb_lay), fx.cfg["embedder"], dev,
                        precision)
        self.ce = None
        if fx.rerank:
            self.ce = Bert(weights.state(fx.ce_flat.to(dev), fx.ce_lay), fx.cfg["reranker"], dev,
                           precision)

    def embed(self, texts: list[str]) -> torch.Tensor:
        return self.emb.embed([self.fx.tok.encode(t) for t in texts])

    def cross(self, pairs: list[tuple[str, str]]) -> torch.Tensor:
        enc = [self.fx.tok.encode_pair(q, d) for q, d in pairs]
        return self.ce.score([e[0] for e in enc], [e[1] for e in enc])


def _dense(fx, queries: torch.Tensor, listed: list[list[int]], tier: str, k: int):
    """The exact top-``k`` over every row as ``tier`` stores it, and the
    scores of the rows in ``listed`` (one list a query)."""
    best_s, best_i = topk.exact_topk(queries, fx.slices(), tier, k)
    want = [(qi, j, r) for qi, rows in enumerate(listed) for j, r in enumerate(rows)]
    got = torch.full((queries.shape[0], max((len(r) for r in listed), default=0)), float("nan"),
                     device=queries.device)
    for start, x in fx.slices():
        mine = [(qi, j, r - start) for qi, j, r in want if start <= r < start + x.shape[0]]
        if not mine:
            continue
        rows = torch.tensor([m[2] for m in mine], device=queries.device)
        qs = torch.tensor([m[0] for m in mine], device=queries.device)
        s = (queries.float()[qs] * topk.stored(x[rows], tier)).sum(dim=1)
        for (qi, j, _), v in zip(mine, s.tolist()):
            got[qi, j] = v
    # a listed row the index does not hold scores -inf: its gaps read infinite
    return best_s, got.nan_to_num(nan=float("-inf"))


def qa_numbers(fx, served: list[Served], ref: Reference) -> dict[str, float]:
    top_k = fx.kb_top_k
    fetch_k = 2 * top_k if fx.rerank else top_k
    out = {"missing": float(sum(len(s.results) != top_k for s in served))}
    if not served:
        return out
    e_ref = ref.embed([s.question for s in served])
    e_srv = torch.tensor(np.stack([s.emb for s in served]), device=e_ref.device)
    out["emb_err"] = float(torch.linalg.vector_norm(e_srv - e_ref, dim=1).max())
    dense = [s.candidates if fx.rerank else s.results for s in served]
    best, got = _dense(fx, e_ref, [[row_id(c[0]) for c in d] for d in dense], fx.tier, fetch_k)
    gap = 0.0
    for qi, d in enumerate(dense):
        n = min(len(d), fetch_k)
        if n:
            gap = max(gap, float((best[qi, :n] - got[qi, :n]).max()))
    out["dense_gap"] = gap
    if not fx.rerank:
        err = 0.0
        for qi, s in enumerate(served):
            for j, (_, _, sc) in enumerate(s.results):
                err = max(err, abs(sc - float(got[qi, j])))
        out["score_err"] = err
        return out
    err, order, cut = 0.0, 0, float("-inf")
    for s in served:
        if not s.candidates:
            continue
        ce = ref.cross([(s.question, c[1]) for c in s.candidates]).tolist()
        by_id = {c[0]: v for c, v in zip(s.candidates, ce)}
        prog = s.scores or {}
        for cid, v in by_id.items():
            err = max(err, abs(prog.get(cid, float("inf")) - v))
        served_sc = [sc for _, _, sc in s.results]
        for cid, _, sc in s.results:
            err = max(err, abs(sc - by_id.get(cid, float("-inf"))))
        order += any(a < b for a, b in zip(served_sc, served_sc[1:]))
        kept = {cid for cid, _, _ in s.results}
        left = [prog.get(cid, float("inf")) for cid in by_id if cid not in kept]
        if left and served_sc:
            cut = max(cut, max(left) - min(served_sc))
    out["score_err"] = err
    out["order_diff"] = float(order)
    out["cut_gap"] = max(cut, 0.0)
    return out


def qa_control(fx, served: list[Served], ctl: Reference) -> list[Served]:
    """The served records the control gives for the same questions: the
    reference's embedding, exact search over the rows one precision below
    the tier, and cross-encoder, at ``ctl``'s precision."""
    top_k = fx.kb_top_k
    fetch_k = 2 * top_k if fx.rerank else top_k
    tier = {"bfloat16": "float8", "int8": "int4"}[fx.tier]
    q = [s.question for s in served]
    e = ctl.embed(q)
    s_, ids = topk.exact_topk(e, fx.slices(), tier, fetch_k)
    out = []
    for qi, text in enumerate(q):
        cands = [(f"r{int(r)}", fx.texts[fx.row_ids_text(int(r))], float(v))
                 for r, v in zip(ids[qi].tolist(), s_[qi].tolist())]
        res, scores = cands[:top_k], None
        if fx.rerank:
            ce = ctl.cross([(text, c[1]) for c in cands]).tolist()
            order = sorted(range(len(cands)), key=lambda j: -ce[j])[:top_k]
            res = [(cands[j][0], cands[j][1], ce[j]) for j in order]
            scores = {c[0]: v for c, v in zip(cands, ce)}
        out.append(Served(text, e[qi].cpu().numpy(), cands, res, scores))
    return out


def chunk_id(doc_id: str, i: int, text: str) -> str:
    return hashlib.md5(f"{doc_id}:{i}:{text}".encode()).hexdigest()


def ingest_numbers(fx, docs: list, index, lexical, sample: int,
                   stored_rows=None) -> dict[str, float]:
    """``lexical``: the store's BM25 index, or None (no ``lexical_diff``);
    ``stored_rows``: the control's rows for the sampled chunks in place of
    the index's."""
    size, overlap = fx.chunking
    diff = 0
    chunks = []
    for d in docs:
        ref = chunker.split(d.content, size, overlap)
        ids = [chunk_id(d.id, i, t) for i, t in enumerate(ref)]
        ok = index.count_by_document(d.id) == len(ref)
        for cid, t in zip(ids, ref):
            c = index.get_by_id(cid)
            ok = ok and c is not None and c.content == t
            chunks.append((cid, t))
        diff += not ok
    out = {"chunk_diff": float(diff)}
    lengths = {j: len(t) for j, (_, t) in enumerate(chunks)}
    pick = sample_ids(list(range(len(chunks))), lengths, fx.seed, sample)
    if not pick:
        return out
    if lexical is not None:
        out["lexical_diff"] = float(sum(
            bm25_record(lexical, chunks[j][0]) != terms.record(chunks[j][1]) for j in pick))
    texts = [chunks[j][1] for j in pick]
    e_ref = Reference(fx).embed(texts)
    if stored_rows is None:
        rows = [index._id_to_row.get(chunks[j][0]) for j in pick]
        if any(r is None for r in rows):
            out["emb_err"] = float("inf")
            return out
        stored_rows = index.dequantize_take(np.asarray(rows))[:, : e_ref.shape[1]].float()
    out["emb_err"] = float(torch.linalg.vector_norm(stored_rows.to(e_ref.device) - e_ref,
                                                    dim=1).max())
    return out


def bm25_record(lexical, cid: str):
    """(length, {term: count}) of chunk ``cid`` as the program's BM25 index
    holds it: its row's length and terms, each term's count read from the
    term's posting; None where the chunk has no live row."""
    row = lexical._row_of.get(cid)
    if row is None or not lexical._live[row]:
        return None
    tf = {}
    for t in lexical._terms_of[row].tolist():
        p = lexical._postings.get(t)
        if p is None:
            return None
        hit = np.flatnonzero(p.rows[: p.n] == row)
        if hit.size != 1:
            return None
        tf[t] = int(p.tfs[hit[0]])
    return int(lexical._doc_len[row]), tf
