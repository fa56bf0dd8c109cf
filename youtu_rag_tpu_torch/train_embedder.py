"""Fine-tune the encoder on a corpus or on query-positive pairs, on the port
(the copy of ``scripts/train_embedder.py`` over ``models/train.py``):

  data        --pairs pairs.jsonl   lines of {"query", "positive"}
              --corpus DIR          self-supervised ICT pairs: for every
                                    chunk, query = a random contiguous
                                    sentence span, positive = the chunk
                                    with the span removed
              --synthetic GROUPS    identifier sibling groups (data_synth)
              --paraphrase PAIRS    zero-overlap paraphrase pairs
  step        the InfoNCE step of models/train.py on one device, or with
              --dp/--tp the sharded step (make_sharded_train_step) over a
              local mesh of dp x tp slots on the training device
  checkpoints TrainCheckpointer under <out>/ckpt (resume with --resume)
  eval        recall@1/@5 of query -> positive over a holdout split,
              before and after
  output      <out>/encoder_params.npz + encoder_config.json (+ vocab.txt)
              + report.json; serve with TorchEmbedder.from_weights_dir

    python -m youtu_rag_tpu_torch.train_embedder --corpus ./docs --steps 200 --out ft
    python -m youtu_rag_tpu_torch.train_embedder --synthetic 64 --preset tiny --device cpu

It trains on the CUDA card unless ``--device`` names another device; a
host without CUDA refuses the default. ``--dp N --tp M`` run the (dp, tp)
step of ``models/train.py`` on a ``parallel.mesh`` mesh of N x M slots,
every slot on the training device (the one card, or ``--device cpu``):
the dp rows share one replica of the parameters there, the tp shards split
the heads and the FFN. The checkpoints, the evaluation and the outputs
take the gathered full tree, so they are the one-device run's files.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import random
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch

SIZES = {
    "tiny": dict(d_model=128, n_layers=2, n_heads=2, d_ff=512, out_dim=128),
    "small": dict(d_model=384, n_layers=6, n_heads=6, d_ff=1536, out_dim=384),
    "base": dict(d_model=768, n_layers=12, n_heads=12, d_ff=3072, out_dim=768),
}


# -- data ---------------------------------------------------------------


def load_pairs(path: Path) -> list[tuple[str, str]]:
    pairs = []
    for line in path.read_text().strip().splitlines():
        if not line.strip():
            continue
        d = json.loads(line)
        q = d.get("query") or d.get("question")
        p = d.get("positive") or d.get("document") or d.get("answer")
        if q and p:
            pairs.append((q, p))
    return pairs


def group_pairs(pairs: list[tuple[str, str]], start: int) -> list[tuple[str, str, int]]:
    """Tag ungrouped pairs with singleton group ids (group-aware batching)."""
    return [(q, p, start + i) for i, (q, p) in enumerate(pairs)]


def ict_pairs_from_corpus(corpus: Path, chunk_size: int, seed: int) -> list[tuple[str, str]]:
    """Inverse-cloze-task pairs: a sentence span queries its source chunk."""
    from .core.config import ChunkingConfig
    from .ingest.chunker import RecursiveTextSplitter

    rng = random.Random(seed)
    splitter = RecursiveTextSplitter(
        ChunkingConfig(strategy="recursive", chunk_size=chunk_size, chunk_overlap=0)
    )
    pairs: list[tuple[str, str]] = []
    exts = {".md", ".txt", ".rst", ".py"}
    for f in sorted(corpus.rglob("*")):
        if not (f.is_file() and f.suffix in exts):
            continue
        try:
            text = f.read_text(errors="ignore")
        except OSError:
            continue
        for chunk in splitter.split_text(text):
            sents = [s for s in re.split(r"(?<=[.!?\n])\s+", chunk) if len(s.split()) >= 3]
            if len(sents) < 2:
                continue
            qi = rng.randrange(len(sents))
            query = sents[qi]
            positive = " ".join(sents[:qi] + sents[qi + 1 :])
            pairs.append((query, positive))
    rng.shuffle(pairs)
    return pairs


def make_batches(pairs, tokenizer, batch: int, seqlen: int, steps: int, seed: int):
    """Yield `steps` batches cycling over the pairs with reshuffles.

    Pairs are (query, positive, group): shuffling happens at *group*
    granularity with members kept adjacent, so sibling hard negatives
    (models/data_synth.py) land in the same InfoNCE batch."""
    rng = random.Random(seed)
    pairs = [t if len(t) == 3 else (t[0], t[1], -1 - i) for i, t in enumerate(pairs)]
    by_group: dict[int, list[int]] = {}
    for i, (_, _, g) in enumerate(pairs):
        by_group.setdefault(g, []).append(i)
    groups = list(by_group.values())
    order: list[int] = []
    enc_cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def encode(i: int):
        if i not in enc_cache:
            q, p, _ = pairs[i]
            enc_cache[i] = (
                np.asarray(tokenizer.encode(q)[:seqlen], np.int32),
                np.asarray(tokenizer.encode(p)[:seqlen], np.int32),
            )
        return enc_cache[i]

    pos = 0
    for _ in range(steps):
        take = []
        while len(take) < batch:
            if pos == 0:
                rng.shuffle(groups)
                order = [i for g in groups for i in g]
            take.append(order[pos])
            pos = (pos + 1) % len(order)
        b = {
            "q_ids": np.zeros((batch, seqlen), np.int32),
            "q_mask": np.zeros((batch, seqlen), np.float32),
            "d_ids": np.zeros((batch, seqlen), np.int32),
            "d_mask": np.zeros((batch, seqlen), np.float32),
        }
        for j, i in enumerate(take):
            qt, dt = encode(i)
            b["q_ids"][j, : len(qt)] = qt
            b["q_mask"][j, : len(qt)] = 1.0
            b["d_ids"][j, : len(dt)] = dt
            b["d_mask"][j, : len(dt)] = 1.0
        yield b


def _idf_tok_weight(train_pairs, tokenizer, vocab_size: int) -> torch.Tensor:
    """IDF over positives → inverse-softplus init for encoder tok_weight."""
    df = np.zeros(vocab_size, np.float64)
    docs = [p for _, p, _ in train_pairs][:20000]
    for text in docs:
        for tid in set(tokenizer.tokenize(text)):
            if 0 <= tid < vocab_size:
                df[tid] += 1
    idf = np.maximum(np.log((len(docs) + 1) / (df + 1.0)), 0.05)
    return torch.from_numpy(np.log(np.expm1(idf)).astype(np.float32))


# -- eval ---------------------------------------------------------------


def eval_recall(params, cfg, holdout, batch_size: int = 64, tokenizer=None,
                device=None) -> dict:
    """recall@1/@5 of query -> its positive among all holdout positives."""
    from .models.embedder import TorchEmbedder

    if device is None:
        device = params["tok_emb"].device
    emb = TorchEmbedder(config=cfg, params=params, batch_size=batch_size, tokenizer=tokenizer,
                        device=device)
    q_vecs = np.asarray(emb.embed_batch([t[0] for t in holdout]), np.float32)
    d_vecs = np.asarray(emb.embed_batch([t[1] for t in holdout]), np.float32)
    scores = q_vecs @ d_vecs.T
    ranks = (scores > np.diag(scores)[:, None]).sum(axis=1)  # 0 = best
    return {
        "n": len(holdout),
        "recall@1": round(float((ranks == 0).mean()), 4),
        "recall@5": round(float((ranks < 5).mean()), 4),
    }


# -- main ---------------------------------------------------------------


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m youtu_rag_tpu_torch.train_embedder")
    p.add_argument("--pairs", type=Path, help="jsonl of {query, positive}")
    p.add_argument("--corpus", type=Path, help="directory for ICT self-supervision")
    p.add_argument("--out", type=Path, default=Path("yrt_finetune"))
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--seqlen", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup", type=int, default=20)
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel slots (0: 1, the slots share the training device)")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel slots")
    p.add_argument("--preset", choices=list(SIZES), default="base")
    p.add_argument(
        "--pretrained", type=Path, default=None,
        help="HF BERT-family checkpoint dir (models/pretrained.py) to "
        "fine-tune instead of random init; overrides --preset and "
        "switches to the WordPiece tokenizer",
    )
    p.add_argument("--holdout", type=int, default=128)
    p.add_argument("--ckpt-every", type=int, default=100)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--synthetic", type=int, default=0, metavar="GROUPS",
        help="add GROUPS sibling groups of identifier-grounding pairs "
        "(models/data_synth.py): hard in-batch negatives that teach "
        "exact-identifier retrieval",
    )
    p.add_argument("--siblings", type=int, default=4, help="pairs per synthetic group")
    p.add_argument(
        "--paraphrase", type=int, default=0, metavar="PAIRS",
        help="add PAIRS zero-lexical-overlap paraphrase pairs "
        "(models/paraphrase_synth.py, canonical seed): supervision for the "
        "CONTEXTUAL channel",
    )
    p.add_argument(
        "--wordpiece", action="store_true",
        help="train a WordPiece vocab from the training texts and use it "
        "instead of the hashing tokenizer; saves vocab.txt next to the weights",
    )
    p.add_argument("--vocab-size", type=int, default=8192)
    p.add_argument("--lex-pool", action="store_true",
                   help="enable the encoder's lexical residual pathway "
                   "(EncoderConfig.lex_pool) with IDF-initialized token weights")
    p.add_argument("--lex-buckets", type=int, default=0,
                   help="with --lex-pool: size of the sparse hashed-BOW channel "
                   "concatenated onto the embedding (0 = dense projection variant)")
    p.add_argument("--device", default=None,
                   help="torch device to train on (default: the CUDA card)")
    return p.parse_args(argv)


def training_pairs(args) -> tuple[list, list]:
    """(train_pairs, holdout) of (query, positive, group): the holdout is
    the head of a deterministic shuffle at group granularity, so sibling
    groups never straddle the split."""
    pairs: list[tuple[str, str, int]] = []
    if args.pairs:
        pairs += group_pairs(load_pairs(args.pairs), start=1_000_000)
    if args.corpus:
        pairs += group_pairs(
            ict_pairs_from_corpus(args.corpus, chunk_size=800, seed=args.seed),
            start=2_000_000,
        )
    if args.synthetic:
        from .models.data_synth import gen_identifier_pairs

        pairs += [
            (d["query"], d["positive"], d["group"])
            for d in gen_identifier_pairs(args.synthetic, args.siblings, seed=args.seed)
        ]
    if args.paraphrase:
        from .models.paraphrase_synth import TRAIN_SEED, gen_paraphrase_pairs

        # canonical seed, NOT args.seed: the bench fixture holds out exactly
        # these combinations (paraphrase_synth.TRAIN_SEED contract)
        para, _ = gen_paraphrase_pairs(args.paraphrase, seed=TRAIN_SEED)
        pairs += group_pairs([(d["query"], d["positive"]) for d in para], start=3_000_000)
    if len(pairs) < 2:
        sys.exit("need at least 2 training pairs (--pairs/--corpus/--synthetic)")
    rng = random.Random(args.seed + 99)
    by_group: dict[int, list] = {}
    for t in pairs:
        by_group.setdefault(t[2], []).append(t)
    groups = list(by_group.values())
    rng.shuffle(groups)
    flat = [t for g in groups for t in g]
    n_hold = min(args.holdout, len(flat) // 5)
    return flat[n_hold:] or flat, flat[:n_hold]


def train_config(args):
    """The run's ``TrainConfig`` (the warmup at most half the steps)."""
    from .models.train import TrainConfig

    return TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=min(args.warmup, max(args.steps // 2, 1)))


def main(argv=None, on_step=None) -> dict:
    """Train as the command line says; returns the report (also written to
    ``<out>/report.json``). ``on_step(step, params, opt_state, metrics)``,
    where given, runs after every step (with ``--dp``/``--tp``, on the
    placed trees: ``params.gather()`` is the full one)."""
    args = parse_args(argv)

    from .models.checkpoint import TrainCheckpointer
    from .models.convert import encoder_params_from_numpy
    from .models.encoder import (
        EncoderConfig,
        count_params,
        init_encoder_params,
        save_encoder_config,
        save_params_npz,
    )
    from .models.tokenizer import HashTokenizer
    from .models.train import make_optimizer, make_train_step
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    train_pairs, holdout = training_pairs(args)
    print(f"pairs: {len(train_pairs)} train, {len(holdout)} holdout; params preset {args.preset}; "
          f"device {device}")

    pre_params = pre_tokenizer = wp_vocab = None
    if args.pretrained:
        from .models.pretrained import load_pretrained_encoder

        pre_params, cfg, pre_tokenizer = load_pretrained_encoder(
            args.pretrained, dtype=torch.float32, max_len=max(args.seqlen, 16)
        )
        print(f"fine-tuning pretrained checkpoint {args.pretrained}")
    else:
        size = dict(SIZES[args.preset])
        if args.wordpiece:
            from .models.wordpiece import build_wordpiece_vocab

            texts = [t[0] for t in train_pairs] + [t[1] for t in train_pairs]
            t0 = time.perf_counter()
            wp_vocab = build_wordpiece_vocab(texts, vocab_size=args.vocab_size)
            print(f"wordpiece vocab: {len(wp_vocab)} tokens from {len(texts)} texts "
                  f"({time.perf_counter() - t0:.1f}s)")
            size["vocab_size"] = len(wp_vocab)
        cfg = EncoderConfig(max_len=max(args.seqlen, 16), lex_pool=args.lex_pool,
                            lex_buckets=args.lex_buckets, **size)
    tc = train_config(args)

    if args.pretrained:
        tokenizer = pre_tokenizer
    elif wp_vocab is not None:
        from .models.wordpiece import WordPieceTokenizer

        tokenizer = WordPieceTokenizer(wp_vocab, max_length=cfg.max_len)
    else:
        tokenizer = HashTokenizer(cfg.vocab_size, cfg.max_len)

    if pre_params is not None:
        params = encoder_params_from_numpy(pre_params, cfg, device)
    else:
        params = init_encoder_params(cfg, torch.Generator().manual_seed(args.seed))
        if cfg.lex_pool:
            # IDF-initialize the lexical token weights (inverse softplus):
            # ubiquitous tokens start near zero influence, rare identifier
            # subwords at max, so the lexical pathway retrieves from step 0
            params["tok_weight"] = _idf_tok_weight(train_pairs, tokenizer, cfg.vocab_size)
        params = {k: ({n: t.to(device) for n, t in v.items()} if isinstance(v, dict)
                      else v.to(device)) for k, v in params.items()}
    print(f"encoder: {count_params(params) / 1e6:.1f}M params")
    dp = args.dp or 1
    placement = None  # a sharded run's; checkpoints and the npz hold the full trees
    if dp * args.tp > 1:
        from .models.train import make_sharded_train_step
        from .parallel.mesh import get_mesh

        mesh = get_mesh({"dp": dp, "tp": args.tp}, devices=[device] * (dp * args.tp))
        params, opt_state, step_fn = make_sharded_train_step(cfg, tc, mesh, init_params=params)
        placement = params.placement
        print(f"mesh: dp={dp} tp={args.tp} on {device}")
    else:
        optimizer = make_optimizer(tc)
        opt_state = optimizer.init(params)
        step_fn = make_train_step(cfg, tc, optimizer)

    def full(params, opt_state):
        if placement is None:
            return params, opt_state
        return params.gather(), placement.gather_opt_state(opt_state)

    args.out.mkdir(parents=True, exist_ok=True)
    ckpt = TrainCheckpointer(args.out / "ckpt")
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        start = ckpt.latest_step()
        like_params, like_state = full(params, opt_state)
        params, opt_state, _ = ckpt.restore(start, params_like=like_params,
                                            opt_state_like=like_state)
        if placement is not None:
            params, opt_state = placement.place(params), placement.place_opt_state(opt_state)
        print(f"resumed from step {start}")

    before = (eval_recall(params if placement is None else params.gather(), cfg, holdout,
                          tokenizer=tokenizer) if holdout else {})
    if before:
        print(f"recall before: {before}")

    t0 = time.perf_counter()
    metrics: dict = {}
    losses: list[float] = []
    batches = make_batches(train_pairs, tokenizer, args.batch, args.seqlen,
                           args.steps - start, args.seed + start)
    for step, batch in enumerate(batches, start=start + 1):
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if on_step is not None:
            on_step(step, params, opt_state, metrics)
        if step % 20 == 0 or step == args.steps:
            print(f"step {step}/{args.steps}  loss {losses[-1]:.4f}  "
                  f"acc {float(metrics['accuracy']):.3f}  "
                  f"({(time.perf_counter() - t0) / (step - start):.2f}s/step)")
        if step % args.ckpt_every == 0:
            ckpt.save(step, *full(params, opt_state), metadata={"loss": losses[-1]})
    ckpt.save(args.steps, *full(params, opt_state), metadata={"final": True})
    ckpt.close()

    if placement is not None:
        params = params.gather()
    after = eval_recall(params, cfg, holdout, tokenizer=tokenizer) if holdout else {}
    out_npz = args.out / "encoder_params.npz"
    save_params_npz(params, out_npz)
    # serving config: RoPE (preln arch) is position-table-free, so serve
    # at 512 even when trained on shorter pairs; bert keeps its table
    serve_cfg = (cfg if cfg.arch == "bert"
                 else dataclasses.replace(cfg, max_len=max(cfg.max_len, 512)))
    save_encoder_config(serve_cfg, args.out / "encoder_config.json")
    if wp_vocab is not None:
        from .models.wordpiece import save_vocab

        save_vocab(wp_vocab, args.out / "vocab.txt")
    report = {
        "steps": args.steps,
        "pairs": len(train_pairs),
        "final_loss": losses[-1] if losses else None,
        "recall_before": before,
        "recall_after": after,
        "params_npz": str(out_npz),
        "losses": losses,
        "device": str(device),
        "provenance": {
            "preset": args.preset,
            "seed": args.seed,
            "lr": args.lr,
            "batch": args.batch,
            "seqlen": args.seqlen,
            "corpus": str(args.corpus) if args.corpus else None,
            "pairs_file": str(args.pairs) if args.pairs else None,
            "synthetic_groups": args.synthetic,
            "siblings": args.siblings,
            "paraphrase_pairs": args.paraphrase,
            "wordpiece_vocab": len(wp_vocab) if wp_vocab else None,
            "lex_pool": bool(cfg.lex_pool),
            "lex_buckets": int(cfg.lex_buckets),
        },
    }
    (args.out / "report.json").write_text(json.dumps(report, indent=2))
    print(json.dumps({k: v for k, v in report.items() if k != "losses"}))
    return report


if __name__ == "__main__":
    main()
