"""Train the local chat LM on synthetic ReAct KB-QA trajectories, on the
port (the copy of ``scripts/train_chat_lm.py``):

  data        models/lm_synth.py: episodes rendered through the serving
              formatters (ReactChatClient + the plain chat template),
              generated on the fly
  tokenizer   models/bpe.train_bpe fitted to the episode distribution
  model       models/decoder.py llama arch (RMSNorm, RoPE, SiLU), vocab
              padded to a multiple of 128, trained with masked-completion
              CE (models/train_lm.py), f32 master weights, bf16 activations
  eval        held-out episodes, greedy generate:
                turn 1: Action parses (parse_react) + query == question
                turn 2: Final Answer == gold value (exact match)
  output      <out>/decoder_params.npz (f16, the JAX layout: wq, wk, wv
              apart) + decoder_config.json + tokenizer.json +
              train_report.json; served by LocalChatClient(<out>) and
              cli_chat --llm-weights-dir <out>

    python -m youtu_rag_tpu_torch.train_chat_lm --steps 4000 --out yrt_tiny_chat
    python -m youtu_rag_tpu_torch.train_chat_lm --steps 20 --layers 2 --device cpu

It trains on the CUDA card unless ``--device`` names another device; a
host without CUDA refuses the default.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m youtu_rag_tpu_torch.train_chat_lm")
    p.add_argument("--steps", type=int, default=4000)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--vocab-size", type=int, default=2048)
    p.add_argument("--max-len", type=int, default=0, help="0 = auto (p99 pow2)")
    p.add_argument("--d-model", type=int, default=192)
    p.add_argument("--layers", type=int, default=6)
    p.add_argument("--heads", type=int, default=6)
    p.add_argument("--d-ff", type=int, default=768)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval-episodes", type=int, default=64)
    p.add_argument("--eval-every", type=int, default=1000)
    p.add_argument("--tokenizer-episodes", type=int, default=400)
    p.add_argument("--out", type=Path, default=Path("yrt_chat_lm"))
    p.add_argument("--device", default=None,
                   help="torch device to train on (default: the CUDA card)")
    return p.parse_args(argv)


def batch_stream(tools, tokenizer, max_len, eos_id, batch, seed):
    """Infinite (freshly synthesized) training batches."""
    from .models.lm_synth import render_episode_samples, synth_episode
    from .models.train_lm import encode_samples, pack_batch

    rng = random.Random(seed + 1)
    while True:
        samples = []
        while len(samples) < batch:
            ep = synth_episode(rng)
            samples.extend(render_episode_samples(ep, tools))
        enc = encode_samples(samples[:batch], tokenizer, max_len, eos_id)
        yield pack_batch(enc, max_len, pad_id=eos_id)


def evaluate(params, cfg, tokenizer, tools, episodes, max_len):
    """Greedy decode on held-out episodes → format/copy/answer accuracy."""
    from .agents.react import parse_react
    from .models.decoder import generate, left_pad_batch
    from .models.lm_synth import render_episode_samples

    device = params["tok_emb"].device

    def gen_batch(prompts, max_new):
        ids = [tokenizer.encode(p)[-(cfg.max_len - max_new):] for p in prompts]
        toks, mask = left_pad_batch(ids, pad_id=cfg.eos_token_id)
        out, lengths = generate(params, torch.from_numpy(toks).to(device),
                                torch.from_numpy(mask).to(device), cfg, max_new_tokens=max_new)
        out, lengths = out.cpu().numpy(), lengths.cpu().numpy()
        return [tokenizer.decode(list(out[i, : lengths[i]])) for i in range(len(prompts))]

    t1_prompts, t2_prompts = [], []
    for ep in episodes:
        (p1, _), (p2, _) = render_episode_samples(ep, tools)
        t1_prompts.append(p1)
        t2_prompts.append(p2)

    n = len(episodes)
    action_ok = query_ok = answer_ok = answer_sub = 0
    B = 16
    t1_texts, t2_texts = [], []
    for i in range(0, n, B):
        t1_texts += gen_batch(t1_prompts[i : i + B], max_new=64)
        # turn 2 emits the copy-then-extract chain (quoted gold sentence
        # + Final Answer): more room than the bare answer
        t2_texts += gen_batch(t2_prompts[i : i + B], max_new=128)
    for ep, txt1, txt2 in zip(episodes, t1_texts, t2_texts):
        _, calls, final = parse_react(txt1)
        if calls and calls[0].name == "kb_embedding_search" and final is None:
            action_ok += 1
            try:
                q = json.loads(calls[0].arguments).get("query", "")
            except json.JSONDecodeError:
                q = ""
            if q.strip() == (ep.query or ep.question).strip():
                query_ok += 1
        _, _, final2 = parse_react(txt2)
        if final2 is not None and final2.strip() == ep.answer.strip():
            answer_ok += 1
        if ep.answer in txt2:
            answer_sub += 1
    return {
        "episodes": n,
        "action_valid": round(action_ok / n, 4),
        "query_exact": round(query_ok / n, 4),
        "answer_exact": round(answer_ok / n, 4),
        "answer_substring": round(answer_sub / n, 4),
        "sample_turn1": t1_texts[0],
        "sample_turn2": t2_texts[0],
    }


def main(argv=None, on_step=None) -> dict:
    """Train as the command line says and write the outputs; returns the
    report. ``on_step(step, params, opt_state, metrics)``, where given,
    runs after every step."""
    args = parse_args(argv)
    t_start = time.time()

    from .models.bpe import train_bpe
    from .models.decoder import DecoderConfig, init_decoder_params, save_decoder_config
    from .models.encoder import count_params, save_params_npz
    from .models.lm_synth import _tool_schemas, synth_corpus, synth_episode
    from .models.train_lm import LMTrainConfig, make_lm_optimizer, make_lm_train_step, split_qkv
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    print(f"device: {device}", file=sys.stderr, flush=True)

    # ---- tokenizer fitted to the episode distribution --------------------
    tok_samples, _ = synth_corpus(args.tokenizer_episodes, seed=args.seed + 7)
    texts = [p + t for p, t in tok_samples]
    print(f"training BPE vocab={args.vocab_size} on {len(texts)} texts ...",
          file=sys.stderr, flush=True)
    tokenizer = train_bpe(texts, vocab_size=args.vocab_size)
    eos_id = tokenizer.eos_id
    assert eos_id is not None

    tools = _tool_schemas()

    # ---- pick max_len from the tokenized p99 (pow2) -----------------------
    if args.max_len:
        max_len = args.max_len
    else:
        lens = [len(tokenizer.encode(p)) + len(tokenizer.encode(t)) + 1 for p, t in tok_samples]
        p99 = int(np.percentile(lens, 99))
        max_len = 1 << (p99 - 1).bit_length()
        print(f"token lens: p50={int(np.percentile(lens, 50))} p99={p99} -> max_len {max_len}",
              file=sys.stderr, flush=True)

    vocab = tokenizer.vocab_size
    vocab_padded = (vocab + 127) // 128 * 128  # a multiple of the GEMM tiles
    cfg = DecoderConfig(
        vocab_size=vocab_padded,
        d_model=args.d_model,
        n_layers=args.layers,
        n_heads=args.heads,
        n_kv_heads=args.heads,
        d_ff=args.d_ff,
        max_len=max_len,
        arch="llama",
        dtype=torch.bfloat16,
        eos_token_id=eos_id,
    )
    params = init_decoder_params(cfg, torch.Generator().manual_seed(args.seed), device=device)
    n_params = count_params(params)
    print(f"model: L={cfg.n_layers} D={cfg.d_model} vocab={vocab_padded} T={max_len} "
          f"params={n_params:,}", file=sys.stderr, flush=True)

    tc = LMTrainConfig(
        learning_rate=args.lr,
        warmup_steps=min(args.warmup, max(1, args.steps // 10)),
        total_steps=args.steps,
    )
    optimizer = make_lm_optimizer(tc)
    opt_state = optimizer.init(params)
    train_step = make_lm_train_step(cfg, tc, optimizer)

    # ---- held-out eval episodes (disjoint seed) ---------------------------
    eval_rng = random.Random(args.seed + 104729)
    eval_episodes = [synth_episode(eval_rng) for _ in range(args.eval_episodes)]

    stream = batch_stream(tools, tokenizer, max_len, eos_id, args.batch, args.seed)
    losses = []
    report = {"device": str(device), "steps": args.steps, "batch": args.batch,
              "max_len": max_len, "vocab": vocab_padded, "params": n_params, "evals": []}
    t0 = time.time()
    for step in range(1, args.steps + 1):
        params, opt_state, metrics = train_step(params, opt_state, next(stream))
        if on_step is not None:
            on_step(step, params, opt_state, metrics)
        if step % 100 == 0 or step == 1:
            loss = float(metrics["loss"])
            losses.append([step, round(loss, 4)])
            print(f"step {step}/{args.steps} loss {loss:.4f} ({step / (time.time() - t0):.1f} "
                  "steps/s)", file=sys.stderr, flush=True)
        if step % args.eval_every == 0 or step == args.steps:
            ev = evaluate(params, cfg, tokenizer, tools, eval_episodes, max_len)
            ev["step"] = step
            report["evals"].append(ev)
            print(f"eval@{step}: action {ev['action_valid']:.2f} query {ev['query_exact']:.2f} "
                  f"answer {ev['answer_exact']:.2f} (sub {ev['answer_substring']:.2f})",
                  file=sys.stderr, flush=True)

    report["loss_curve"] = losses
    report["train_minutes"] = round((time.time() - t_start) / 60, 1)

    # ---- the native checkpoint (f16 weights halve its size) ---------------
    args.out.mkdir(parents=True, exist_ok=True)
    params_f16 = _tree_f16(split_qkv(params, cfg))
    save_params_npz(params_f16, args.out / "decoder_params.npz")
    save_decoder_config(cfg, args.out / "decoder_config.json")
    tokenizer.save_json(args.out / "tokenizer.json")
    with open(args.out / "train_report.json", "w") as f:
        json.dump(report, f, indent=1)
    final = report["evals"][-1] if report["evals"] else {}
    print(json.dumps({
        "out": str(args.out), "params": n_params,
        "final_loss": losses[-1][1] if losses else None,
        "action_valid": final.get("action_valid"),
        "query_exact": final.get("query_exact"),
        "answer_exact": final.get("answer_exact"),
        "train_minutes": report["train_minutes"],
    }))
    return report


def _tree_f16(tree: dict) -> dict:
    return {k: _tree_f16(v) if isinstance(v, dict) else v.detach().to("cpu", torch.float16)
            for k, v in tree.items()}


if __name__ == "__main__":
    main()
