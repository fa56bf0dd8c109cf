"""Calibrate the decoder gates of ``chip_smoke.py`` phase 6b on the card.

    python -m youtu_rag_tpu_torch.bench.decoder_tolerance [--seeds 0 1 2 3 4 5]

A decoder with Qwen2-0.5B-Instruct's widths at full depth (24 layers,
hidden 896, 14 heads, 2 KV heads, intermediate 4864, vocab 151,936, q/k/v
biases, tied head, rope_theta 1e6), its weights drawn as phase 6b draws
them for the same seed (N(0, 0.02^2) on the card, rounded to bf16 as its
checkpoint stores them; norms 1), served in bf16 on the card. For each
seed it reads phase 6b's three quantities, on phase 6b's tokens:

- ``first step``: the card's bf16 prefill logits (B 1, T 128) against the
  CPU f32 forward of the same weights;
- ``decode``: a 128-token prefill and 16 decode steps with the bf16 cache
  against the teacher-forced forward over the same 144 tokens (B 2);
- ``int8 KV``: the same steps with the int8 cache against the bf16 cache;

each the largest logit difference, once as the port computes it (``sound``)
and once under each control: the same run with one rounding point lowered
or one step done wrong, as a faulty port might. First step: attention
scores and softmax in bf16; logits rounded to bf16; the residual stream
rounded to fp8 (e4m3) after each layer; RoPE at base 1e4; the q/k/v biases
dropped. Decode (its steps only): scores and softmax in bf16; the cache
read back through fp8; the positions one too far. int8 KV: a 4-bit
quantizer (levels of amax / 7); truncation in place of rounding. A gate
lies between the largest sound reading and the controls it must catch.
Prints one JSON line per seed, the largest sound reading and smallest
control reading of each quantity, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys

import numpy as np
import torch

from ..models import decoder as td
from ..models.convert import decoder_params_from_numpy

QWEN2_05B = dict(vocab_size=151936, d_model=896, n_layers=24, n_heads=14, n_kv_heads=2,
                 d_ff=4864, max_len=2048, arch="llama", dtype=torch.bfloat16, rope_base=1e6,
                 ln_eps=1e-6, tie_embeddings=True, eos_token_id=151645, qkv_bias=True)
FP8 = torch.float8_e4m3fn


def qwen2_tree(cfg: td.DecoderConfig, seed: int) -> dict:
    """The numpy tree ``load_pretrained_decoder`` reads from phase 6b's
    checkpoint for ``seed``: the same draws in the same order ([out, in]
    matrices, transposed as the loader does), rounded to bf16."""
    dm, ff, kv = cfg.d_model, cfg.d_ff, cfg.kv_dim
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        x = 0.02 * torch.randn(shape, generator=g, device="cuda")
        return x.to(torch.bfloat16).float().cpu().numpy()

    emb = rand(cfg.vocab_size, dm)
    names = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "w_gate", "w1", "w2")
    shapes = ((dm, dm), (dm,), (kv, dm), (kv,), (kv, dm), (kv,), (dm, dm), (ff, dm), (ff, dm),
              (dm, ff))
    layers = {n: [] for n in names}
    for _ in range(cfg.n_layers):
        for n, shape in zip(names, shapes):
            a = rand(*shape)
            layers[n].append(a.T if a.ndim == 2 else a)
    tree = {n: np.stack(v) for n, v in layers.items()}
    tree["ln1_scale"] = tree["ln2_scale"] = np.ones((cfg.n_layers, dm), np.float32)
    return {"tok_emb": emb, "layers": tree, "final_ln_scale": np.ones(dm, np.float32)}


@contextlib.contextmanager
def patched(**fns):
    """The decoder module's functions replaced by ``fns`` for a while."""
    old = {name: getattr(td, name) for name in fns}
    for name, fn in fns.items():
        setattr(td, name, fn)
    try:
        yield
    finally:
        for name, fn in old.items():
            setattr(td, name, fn)


def attend_bf16(q, k, v, bias, cfg):
    """``_attend`` with the scores and the softmax in the activation dtype."""
    b, h, tq, hd = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    scores = torch.matmul(q.reshape(b, hkv, (h // hkv) * tq, hd),
                          k.transpose(-1, -2)).reshape(b, h, tq, tk)
    attn = torch.softmax(scores / float(np.sqrt(hd)) + bias.to(q.dtype), dim=-1)
    y = torch.matmul(attn.reshape(b, hkv, (h // hkv) * tq, tk), v).reshape(b, h, tq, hd)
    return y.transpose(1, 2).reshape(b, tq, h * hd)


def quantizer(levels: int, rounding):
    """``_quantize_kv`` with ``levels`` steps each side and ``rounding``."""
    def quantize(x):
        xf = x.float()
        scale = torch.clamp(torch.amax(torch.abs(xf), dim=-1), min=1e-12) / levels
        return torch.clamp(rounding(xf / scale[..., None]), -levels, levels).to(torch.int8), scale
    return quantize


def first_step_controls() -> dict:
    logits, block = td._logits, td._block
    return {
        "scores bf16": dict(fns=dict(_attend=attend_bf16)),
        "logits bf16": dict(fns=dict(_logits=lambda p, x, c: logits(p, x, c).to(
            torch.bfloat16).float())),
        "residual fp8": dict(fns=dict(_block=lambda x, *a: block(x, *a).to(FP8).to(x.dtype))),
        "rope base 1e4": dict(cfg=dict(rope_base=1e4)),
        "no q/k/v bias": dict(drop_bias=True),
    }


def decode_controls() -> dict:
    read = td._read_kv
    return {
        "scores bf16": dict(fns=dict(_attend=attend_bf16)),
        "cache through fp8": dict(fns=dict(_read_kv=lambda cache, i, dt: tuple(
            t.to(FP8).to(dt) for t in read(cache, i, dt)))),
        "positions + 1": dict(shift=1),
    }


INT8_CONTROLS = {"4-bit quantizer": quantizer(7, torch.round),
                 "truncation": quantizer(127, torch.trunc)}


def decode_logits(params, seq, cfg, fns=None, shift: int = 0) -> torch.Tensor:
    """Prefill over seq[:, :128], then a decode step for each later token
    (with ``fns`` patched in and the positions moved by ``shift``):
    logits at positions 127 .. T - 1 [B, T - 127, V]."""
    b, t = seq.shape
    cache = td.init_cache(cfg, b, t, "cuda")
    lg, cache = td.prefill(params, seq[:, :128], torch.ones(b, 128, device="cuda"), cache, cfg)
    attn = torch.zeros(b, t, device="cuda")
    attn[:, :128] = 1.0
    steps = [lg]
    with patched(**(fns or {})):
        for i in range(128, t):
            attn[:, i] = 1.0
            pos = torch.full((b,), i + shift, dtype=torch.int32, device="cuda")
            lg, cache = td.decode_step(params, seq[:, i], i, attn, pos, cache, cfg)
            steps.append(lg)
    return torch.stack(steps, 1)


def calibrate(seed: int) -> dict:
    cfg = td.DecoderConfig(**QWEN2_05B)
    tree = qwen2_tree(cfg, seed)
    params = td.cast_params_for_serving(decoder_params_from_numpy(tree, cfg, "cuda"))
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    cpu = decoder_params_from_numpy(tree, f32)
    del tree
    g = torch.Generator(device="cuda").manual_seed(seed + 6)  # phase 6b's tokens
    toks = torch.randint(0, cfg.vocab_size, (1, 128), generator=g, device="cuda")
    seq = torch.randint(0, cfg.vocab_size, (2, 144), generator=g, device="cuda")
    mask = torch.ones(1, 128, device="cuda")

    def card_first(c=cfg, p=params, fns=None):
        with patched(**(fns or {})):
            return td.prefill(p, toks, mask, td.init_cache(c, 1, 128, "cuda"), c)[0].float().cpu()

    ref, _ = td.prefill(cpu, toks.cpu(), mask.cpu(), td.init_cache(f32, 1, 128), f32)
    del cpu
    first = {"sound": card_first()}
    for name, ctl in first_step_controls().items():
        p = params
        if ctl.get("drop_bias"):
            p = dict(params, layers={k: v for k, v in params["layers"].items() if k != "bqkv"})
        c = dataclasses.replace(cfg, **ctl.get("cfg", {}))
        first[name] = card_first(c, p, ctl.get("fns"))
    out = {"seed": seed, "logit std": float(ref.std()),
           "first step": {k: float((v - ref).abs().max()) for k, v in first.items()}}

    full = td.causal_logits(params, seq, torch.ones(2, 144, device="cuda"), cfg)[:, 127:]
    native = decode_logits(params, seq, cfg)
    out["decode"] = {"sound": float((native - full).abs().max())}
    for name, ctl in decode_controls().items():
        lg = decode_logits(params, seq, cfg, ctl.get("fns"), ctl.get("shift", 0))
        out["decode"][name] = float((lg - full).abs().max())
    del full
    c8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    out["int8 KV"] = {"sound": float((decode_logits(params, seq, c8) - native).abs().max())}
    for name, quantize in INT8_CONTROLS.items():
        with patched(_quantize_kv=quantize):
            lg = decode_logits(params, seq, c8)
        out["int8 KV"][name] = float((lg - native).abs().max())
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m youtu_rag_tpu_torch.bench.decoder_tolerance")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4, 5])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: this calibration runs on the card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = []
    with torch.inference_mode():
        for seed in args.seeds:
            runs.append(calibrate(seed))
            print(json.dumps(runs[-1]), flush=True)
    for quantity in ("first step", "decode", "int8 KV"):
        sound = max(r[quantity]["sound"] for r in runs)
        controls = {name: min(r[quantity][name] for r in runs)
                    for name in runs[0][quantity] if name != "sound"}
        print(f"{quantity}: largest sound {sound:.4f}; smallest control "
              + "; ".join(f"{k} {v:.4f}" for k, v in controls.items()), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
