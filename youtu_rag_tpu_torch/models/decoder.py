"""Causal-LM decoder runtime: the local LLM's serving path, in PyTorch.

The port's counterpart of ``youtu_rag_tpu/models/decoder.py``. Two
architectures, as there:
- ``"gpt2"``: learned absolute positions, pre-LN (LayerNorm), tanh GELU,
  biased projections, tied head;
- ``"llama"``: RMSNorm, RoPE (the HF halves convention), grouped-query
  attention, SiLU-gated MLP, optional q/k/v biases (qwen2) and a tied or
  separate head (``models/pretrained.py`` maps llama, mistral and qwen2
  checkpoints onto it).

The parameters are a plain dict of tensors with the layers stacked on a
leading axis: the JAX package's tree, except that q, k and v's weights lie
side by side as one ``wqkv`` [L, D, D + 2 KV] (their biases as ``bqkv``),
so that a layer projects them in one GEMM (``models.convert`` fuses JAX's
``wq``, ``wk`` and ``wv``). The forward runs the layers in a Python loop
and computes RoPE's tables once per forward, since each op is a launch
from the host and decode is host-bound. The rounding points are the JAX package's:
parameters are cast to ``cfg.dtype`` at each use (``cast_params_for_serving``
stores the matmul weights in bf16 once); the norms run in f32 and cast back;
RoPE's cos and sin are cast to ``cfg.dtype`` before the product; attention
scores are f32 products of the ``cfg.dtype`` q and k, the softmax is f32,
its probabilities are cast to ``cfg.dtype`` before they mix v; the logits
are f32 products of the normed activations with the head. The masking
constant is -1e9, as in JAX's module.

The KV cache is static-shape, ``[L, B, Hkv, maxT, hd]`` in ``cfg.dtype``
(or int8 with f32 scales per (L, B, Hkv, T): ``kv_cache_dtype="int8"``),
and ``prefill`` and ``decode_step`` write it in place. Prompts are
left-padded, so every row appends at the same cache slot; per-row position
ids keep RoPE and the learned positions exact. ``generate`` is a host loop
of ``decode_step`` calls that stops once every row has emitted EOS: JAX's
one jitted ``while_loop`` gives the same tokens and lengths, but here the
host reads ``done`` back after each step (one device sync per token).

There is no Pallas site in the JAX decoder, so there is no kernel here:
every operation is a plain PyTorch call, on the device the parameters lie
on. Sampling takes a ``torch.Generator``: its top-k and top-p masks are
JAX's, its draws cannot be (``jax.random.categorical``'s stream is JAX's
own).
"""

from __future__ import annotations

import dataclasses
import functools
import json
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from .encoder import DTYPES, layer_views

NEG_INF = -1e9


@dataclass(frozen=True)
class DecoderConfig:
    """A copy of the JAX package's ``DecoderConfig`` with ``dtype`` as a
    torch dtype."""

    vocab_size: int = 32768
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    n_kv_heads: int = 12  # < n_heads: grouped-query attention
    d_ff: int = 3072
    max_len: int = 1024
    arch: str = "llama"  # "gpt2" | "llama"
    dtype: torch.dtype = torch.bfloat16
    rope_base: float = 10000.0
    ln_eps: float = 1e-5
    tie_embeddings: bool = True
    eos_token_id: int = 0
    bos_token_id: int | None = None
    qkv_bias: bool = False  # qwen2: biases on q, k and v only
    # "native" keeps K/V in cfg.dtype; "int8" stores int8 values and f32
    # scales per (position, head), half the bytes decode re-reads each step
    kv_cache_dtype: str = "native"

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} is not a multiple of n_heads {self.n_heads}")
        return self.d_model // self.n_heads

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


def save_decoder_config(cfg: DecoderConfig, path) -> None:
    """The JAX package's JSON layout (``dtype`` by name)."""
    d = dataclasses.asdict(cfg)
    d["dtype"] = next(name for name, dt in DTYPES.items() if dt == cfg.dtype)
    with open(path, "w") as f:
        json.dump(d, f, indent=1)


def load_decoder_config(path) -> DecoderConfig:
    """Read a ``decoder_config.json`` written by either package."""
    with open(path) as f:
        d = json.load(f)
    if isinstance(d.get("dtype"), str):
        d["dtype"] = DTYPES[d["dtype"]]
    return DecoderConfig(**d)


def init_decoder_params(cfg: DecoderConfig, generator: torch.Generator | None = None,
                        device: str | torch.device = "cpu") -> dict:
    """Seeded f32 parameters, layers stacked on axis 0. The shapes and the
    0.02 scale are the JAX package's; the values come from ``generator``
    and differ from JAX's (tests carry JAX's across with
    ``models.convert.decoder_params_from_numpy`` instead)."""
    D, Fd, L, V, KV = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size, cfg.kv_dim

    def init(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32) * 0.02

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32)

    if cfg.arch == "gpt2":
        layers = {
            "ln1_scale": ones(L, D), "ln1_bias": zeros(L, D),
            "wqkv": init(L, D, 3 * D), "bqkv": zeros(L, 3 * D),
            "wo": init(L, D, D), "bo": zeros(L, D),
            "ln2_scale": ones(L, D), "ln2_bias": zeros(L, D),
            "w1": init(L, D, Fd), "b1": zeros(L, Fd),
            "w2": init(L, Fd, D), "b2": zeros(L, D),
        }
        params = {"tok_emb": init(V, D), "pos_emb": init(cfg.max_len, D), "layers": layers,
                  "final_ln_scale": ones(D), "final_ln_bias": zeros(D)}
    else:
        layers = {
            "ln1_scale": ones(L, D),
            "wqkv": init(L, D, D + 2 * KV), "wo": init(L, D, D),
            "ln2_scale": ones(L, D),
            "w_gate": init(L, D, Fd), "w1": init(L, D, Fd), "w2": init(L, Fd, D),
        }
        if cfg.qkv_bias:
            layers["bqkv"] = zeros(L, D + 2 * KV)
        params = {"tok_emb": init(V, D), "layers": layers, "final_ln_scale": ones(D)}
    if not cfg.tie_embeddings:
        params["lm_head"] = init(D, V)
    return _tree_map(lambda t: t.to(device), params)


def _tree_map(fn, tree: dict) -> dict:
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def cast_params_for_serving(params: dict, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The matmul weights (and embeddings) in the serving dtype; the norm
    scales and the biases stay as they are (JAX's rule: names starting with
    "ln", "final_ln" or "b"). Decode reads every weight once a step, so
    bf16 storage halves its bytes; the math dtypes do not change (the
    forward casts at each use)."""
    def walk(tree: dict) -> dict:
        out = {}
        for name, v in tree.items():
            if isinstance(v, dict):
                out[name] = walk(v)
            elif name.startswith(("ln", "final_ln", "b")):
                out[name] = v
            else:
                out[name] = v.to(dtype)
        return out

    return walk(params)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------


def _layers(params: dict, cfg: DecoderConfig) -> list[dict]:
    """Layer i's parameters as views of the stacked tensors (one ``unbind``
    a tensor, ``encoder.layer_views``)."""
    return layer_views(params["layers"], cfg.n_layers)


def _f32_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` [..., K] x [..., K, N] as f32 sums of the operands'
    products: JAX's ``preferred_element_type=f32`` einsum. Two bf16 (or
    f16) operands on the card run one GEMM with an f32 output, without f32
    copies (the head's is the largest matrix of a decode step, the KV
    cache the largest operand of attention). Under differentiation it
    takes the f32 copies (the same sums), since the GEMM with an f32
    output need not have a backward."""
    grad = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    if (x.is_cuda and not grad and x.dtype == w.dtype
            and x.dtype in (torch.bfloat16, torch.float16)):
        if w.dim() == 2:
            return torch.mm(x.reshape(-1, x.shape[-1]), w,
                            out_dtype=torch.float32).reshape(*x.shape[:-1], w.shape[-1])
        lead = x.shape[:-2]
        return torch.bmm(x.reshape(-1, *x.shape[-2:]), w.reshape(-1, *w.shape[-2:]),
                         out_dtype=torch.float32).reshape(*lead, x.shape[-2], w.shape[-1])
    return torch.matmul(x.float(), w.float())


def _norm(x: torch.Tensor, p: dict, prefix: str, cfg: DecoderConfig) -> torch.Tensor:
    """LayerNorm (gpt2) or RMSNorm (llama) in f32, cast back to x's type."""
    x32 = x.float()
    scale = p[f"{prefix}_scale"].float()
    if cfg.arch == "gpt2":
        y = F.layer_norm(x32, (x.shape[-1],), scale, p[f"{prefix}_bias"].float(), cfg.ln_eps)
    else:
        y = F.rms_norm(x32, (x.shape[-1],), scale, cfg.ln_eps)
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _rope_freqs(half: int, base: float, device: torch.device) -> torch.Tensor:
    """``1 / base ** (arange(half) / half)`` in f32 on ``device``."""
    idx = torch.arange(0, half, dtype=torch.float32) / half
    return (1.0 / torch.pow(torch.tensor(base, dtype=torch.float32), idx)).to(device)


def _rope_tables(pos_ids: torch.Tensor, cfg: DecoderConfig):
    """RoPE's cos and sin at per-row positions [B, T]: [B, 1, T, hd / 2],
    computed in f32 and cast to ``cfg.dtype`` (the same for every layer);
    None for gpt2."""
    if cfg.arch == "gpt2":
        return None
    freqs = _rope_freqs(cfg.head_dim // 2, float(cfg.rope_base), pos_ids.device)
    ang = pos_ids.float()[:, None, :, None] * freqs
    return torch.cos(ang).to(cfg.dtype), torch.sin(ang).to(cfg.dtype)


def _rope_at(x: torch.Tensor, rope) -> torch.Tensor:
    """RoPE on [B, H, T, hd] with ``_rope_tables``' cos and sin (the HF
    llama convention: frequencies repeated over the two halves)."""
    cos, sin = rope
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _split_heads(y: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    b, t, _ = y.shape
    return y.reshape(b, t, n_heads, head_dim).transpose(1, 2)


def _qkv(x: torch.Tensor, lp: dict, rope, cfg: DecoderConfig):
    """q [B, H, T, hd] and k, v [B, Hkv, T, hd] from one projection GEMM,
    rotated for llama."""
    y = torch.matmul(x, lp["wqkv"].to(x.dtype))
    if "bqkv" in lp:
        y = y + lp["bqkv"].to(x.dtype)
    d, kv = cfg.d_model, cfg.kv_dim
    q = _split_heads(y[..., :d], cfg.n_heads, cfg.head_dim)
    k = _split_heads(y[..., d : d + kv], cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(y[..., d + kv :], cfg.n_kv_heads, cfg.head_dim)
    if rope is not None:
        q, k = _rope_at(q, rope), _rope_at(k, rope)
    return q, k, v


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
            cfg: DecoderConfig) -> torch.Tensor:
    """Masked attention with kv-head repetition; ``bias`` an additive f32
    [B, 1, Tq, Tk]. The query heads of one kv head share its k and v: q is
    viewed as [B, Hkv, (H / Hkv) Tq, hd]. Returns [B, Tq, H hd]."""
    b, h, tq, hd = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, (h // hkv) * tq, hd)
    scores = _f32_matmul(qg, k.transpose(-1, -2)).reshape(b, h, tq, tk)
    scores = scores / float(np.sqrt(hd)) + bias
    attn = torch.softmax(scores, dim=-1).to(q.dtype)
    y = torch.matmul(attn.reshape(b, hkv, (h // hkv) * tq, tk), v).reshape(b, h, tq, hd)
    return y.transpose(1, 2).reshape(b, tq, h * hd)


def _mlp(h: torch.Tensor, lp: dict, cfg: DecoderConfig) -> torch.Tensor:
    dt = h.dtype
    if cfg.arch == "gpt2":
        y = torch.matmul(h, lp["w1"].to(dt)) + lp["b1"].to(dt)
        y = F.gelu(y, approximate="tanh")  # HF gelu_new
        return torch.matmul(y, lp["w2"].to(dt)) + lp["b2"].to(dt)
    g = torch.matmul(h, lp["w_gate"].to(dt))
    u = torch.matmul(h, lp["w1"].to(dt))
    return torch.matmul(F.silu(g) * u, lp["w2"].to(dt))


def _block(x: torch.Tensor, lp: dict, q, k, v, bias, cfg: DecoderConfig) -> torch.Tensor:
    """The rest of a layer once q, k and v are known: attention, the output
    projection, the residuals and the MLP."""
    a = torch.matmul(_attend(q, k, v, bias, cfg), lp["wo"].to(x.dtype))
    if "bo" in lp:
        a = a + lp["bo"].to(x.dtype)
    x = x + a
    return x + _mlp(_norm(x, lp, "ln2", cfg), lp, cfg)


def _logits(params: dict, x: torch.Tensor, cfg: DecoderConfig) -> torch.Tensor:
    """f32 logits of the final-normed activations: f32 sums of their
    products with the head in its stored dtype."""
    x = _norm(x, params, "final_ln", cfg)
    w = params["tok_emb"].t() if cfg.tie_embeddings else params["lm_head"]
    return _f32_matmul(x, w)


def _embed(params: dict, tokens: torch.Tensor, pos_ids: torch.Tensor,
           cfg: DecoderConfig) -> torch.Tensor:
    x = F.embedding(tokens.long(), params["tok_emb"]).to(cfg.dtype)
    if cfg.arch == "gpt2":
        pos = torch.clamp(pos_ids.long(), 0, cfg.max_len - 1)
        x = x + F.embedding(pos, params["pos_emb"]).to(cfg.dtype)
    return x


def position_ids_from_mask(mask: torch.Tensor) -> torch.Tensor:
    """Per-row position ids under left padding: pads get 0, the first real
    token 0, and the positions count up from there ([B, T] int32)."""
    m = mask.to(torch.int32)
    return torch.clamp(torch.cumsum(m, dim=-1, dtype=torch.int32) - 1, min=0)


def _causal_bias(mask: torch.Tensor) -> torch.Tensor:
    """``(1 - causal * pad) * NEG_INF``: [B, 1, T, T] f32."""
    t = mask.shape[-1]
    causal = torch.tril(torch.ones((t, t), dtype=torch.float32, device=mask.device))[None, None]
    pad = mask.float()[:, None, None, :]
    return (1.0 - causal * pad) * NEG_INF


def _layer(x: torch.Tensor, lp: dict, bias: torch.Tensor, rope, cfg: DecoderConfig) -> torch.Tensor:
    q, k, v = _qkv(_norm(x, lp, "ln1", cfg), lp, rope, cfg)
    return _block(x, lp, q, k, v, bias, cfg)


def causal_logits(params: dict, tokens: torch.Tensor, mask: torch.Tensor,
                  cfg: DecoderConfig, remat: bool = False) -> torch.Tensor:
    """The teacher-forced forward, no cache: [B, T, vocab] f32 logits.
    ``mask`` is 1 for real tokens (left or right padding; the positions
    come from the mask). ``remat=True`` recomputes each layer in the
    backward pass (``torch.utils.checkpoint``, JAX's ``jax.checkpoint``):
    without it the backward keeps every layer's [B, H, T, T] f32 attention
    matrix live (1 GB a layer at B = 32, T = 1024)."""
    pos_ids = position_ids_from_mask(mask)
    x = _embed(params, tokens, pos_ids, cfg)
    bias, rope = _causal_bias(mask), _rope_tables(pos_ids, cfg)
    for lp in _layers(params, cfg):
        if remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(_layer, x, lp, bias, rope, cfg,
                                                  use_reentrant=False)
        else:
            x = _layer(x, lp, bias, rope, cfg)
    return _logits(params, x, cfg)


# ---------------------------------------------------------------------------
# the KV cache
# ---------------------------------------------------------------------------


def init_cache(cfg: DecoderConfig, batch: int, max_len: int | None = None,
               device: str | torch.device = "cpu") -> dict:
    """Static-shape KV cache [L, B, Hkv, maxT, hd] of zeros; with
    ``kv_cache_dtype == "int8"`` int8 values and f32 scales [L, B, Hkv,
    maxT]."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len or cfg.max_len, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device)}
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., T, hd] → (int8 values, f32 scales [..., T]), symmetric:
    scale = max(amax, 1e-12) times f32(1 / 127) (the jitted JAX quantizer
    folds its division by 127 so), values round half to even of x / scale,
    clamped to ±127."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1)
    scale = torch.clamp(amax, min=1e-12) * np.float32(1.0 / 127.0)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Values times scales, both in ``dtype``."""
    return q.to(dtype) * scale[..., None].to(dtype)


def _write_kv(cache: dict, i: int, k: torch.Tensor, v: torch.Tensor, t0: int) -> None:
    """Layer i's k and v [B, Hkv, T, hd] into slots t0 .. t0 + T - 1."""
    t1 = t0 + k.shape[2]
    if "k_scale" in cache:
        (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
        cache["k"][i, :, :, t0:t1] = kq
        cache["v"][i, :, :, t0:t1] = vq
        cache["k_scale"][i, :, :, t0:t1] = ks
        cache["v_scale"][i, :, :, t0:t1] = vs
    else:
        cache["k"][i, :, :, t0:t1] = k
        cache["v"][i, :, :, t0:t1] = v


def _read_kv(cache: dict, i: int, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Layer i's whole cache [B, Hkv, maxT, hd] in ``dtype``."""
    if "k_scale" in cache:
        return (_dequantize_kv(cache["k"][i], cache["k_scale"][i], dtype),
                _dequantize_kv(cache["v"][i], cache["v_scale"][i], dtype))
    return cache["k"][i], cache["v"][i]


def prefill(params: dict, tokens: torch.Tensor, mask: torch.Tensor, cache: dict,
            cfg: DecoderConfig) -> tuple[torch.Tensor, dict]:
    """The causal pass over the (left-padded) prompt [B, T], writing K/V
    into the cache's slots 0 .. T - 1 (in place). Attention uses the
    full-precision k and v, not the quantized cache. Returns (the last
    position's logits [B, V] f32, the cache)."""
    pos_ids = position_ids_from_mask(mask)
    x = _embed(params, tokens, pos_ids, cfg)
    bias, rope = _causal_bias(mask), _rope_tables(pos_ids, cfg)
    for i, lp in enumerate(_layers(params, cfg)):
        q, k, v = _qkv(_norm(x, lp, "ln1", cfg), lp, rope, cfg)
        _write_kv(cache, i, k, v, 0)
        x = _block(x, lp, q, k, v, bias, cfg)
    return _logits(params, x[:, -1:, :], cfg)[:, 0], cache


def decode_step(params: dict, token: torch.Tensor, t_index: int, attn_mask: torch.Tensor,
                pos_ids: torch.Tensor, cache: dict, cfg: DecoderConfig) -> tuple[torch.Tensor, dict]:
    """One token for every row: ``token`` [B] just emitted goes into cache
    slot ``t_index`` (in place; left padding makes it one slot for the
    batch) at per-row positions ``pos_ids`` [B]; ``attn_mask`` [B, maxT] is
    1 for every valid slot up to ``t_index``, the pads stay masked. Returns
    (logits [B, V] f32, the cache)."""
    pos = pos_ids.reshape(-1, 1)
    x = _embed(params, token.reshape(-1, 1), pos, cfg)
    bias = (1.0 - attn_mask.float())[:, None, None, :] * NEG_INF
    rope = _rope_tables(pos, cfg)
    for i, lp in enumerate(_layers(params, cfg)):
        q, k, v = _qkv(_norm(x, lp, "ln1", cfg), lp, rope, cfg)
        _write_kv(cache, i, k, v, int(t_index))
        kc, vc = _read_kv(cache, i, q.dtype)
        x = _block(x, lp, q, kc, vc, bias, cfg)
    return _logits(params, x, cfg)[:, 0], cache


# ---------------------------------------------------------------------------
# sampling and generation
# ---------------------------------------------------------------------------


def sampling_logits(logits: torch.Tensor, temperature: float, top_k: int = 0,
                    top_p: float = 1.0) -> torch.Tensor:
    """JAX's ``sample_token`` before its draw: logits / temperature, with
    the entries below the k-th largest (``top_k``) and below the smallest
    set of cumulative probability >= ``top_p`` (the first kept) set to
    NEG_INF."""
    logits = logits / temperature
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cutoff_idx = torch.sum((cum - probs) < top_p, dim=-1) - 1
        cutoff = torch.gather(sorted_logits, 1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, torch.full_like(logits, NEG_INF), logits)
    return logits


def sample_token(logits: torch.Tensor, generator: torch.Generator | None = None,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Greedy (temperature 0: the first largest logit) or a draw from
    ``sampling_logits``' distribution with ``generator``: [B] int32."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(sampling_logits(logits, temperature, top_k, top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


@torch.inference_mode()
def generate(params: dict, prompt: torch.Tensor, prompt_mask: torch.Tensor, cfg: DecoderConfig,
             max_new_tokens: int = 128, temperature: float = 0.0, top_k: int = 0,
             top_p: float = 1.0, generator: torch.Generator | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefill, then decode steps until every row has emitted EOS or
    ``max_new_tokens`` are out: (tokens [B, max_new] int32, lengths [B]).

    ``prompt`` [B, Tp] is left-padded, ``prompt_mask`` 1 for real tokens.
    A row's output after its EOS is EOS; its length counts the tokens
    before its first EOS (``max_new_tokens`` without one). The host reads
    ``done`` after each step (one device sync per token) and runs no step
    once every row is done, which changes no output: JAX's loop exits
    there too."""
    dev = prompt.device
    b, tp = prompt.shape
    cache = init_cache(cfg, b, tp + max_new_tokens, device=dev)
    logits, cache = prefill(params, prompt, prompt_mask, cache, cfg)
    attn_mask = torch.cat([prompt_mask.float(),
                           torch.zeros((b, max_new_tokens), dtype=torch.float32, device=dev)], -1)
    pos = prompt_mask.to(torch.int32).sum(-1)  # the next position id
    eos = cfg.eos_token_id
    out = torch.full((b, max_new_tokens), eos, dtype=torch.int32, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    for step in range(max_new_tokens):
        tok = sample_token(logits, generator, temperature, top_k, top_p)
        tok = torch.where(done, torch.full_like(tok, eos), tok)
        out[:, step] = tok
        done = done | (tok == eos)
        if bool(done.all()):
            break
        attn_mask[:, tp + step] = 1.0
        logits, cache = decode_step(params, tok, tp + step, attn_mask, pos + step, cache, cfg)
    is_eos = out == eos
    first_eos = torch.argmax(is_eos.to(torch.int32), dim=-1)
    lengths = torch.where(is_eos.any(-1), first_eos, torch.full_like(first_eos, max_new_tokens))
    return out, lengths


def left_pad_batch(seqs: list[list[int]], pad_id: int,
                   bucket: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """Left-pad variable-length prompts into [B, T] int32 tokens and an f32
    mask, T rounded up to a power of two (the JAX package's buckets)."""
    longest = max(1, max(len(s) for s in seqs))
    t = 1 << (longest - 1).bit_length() if bucket else longest
    toks = np.full((len(seqs), t), pad_id, np.int32)
    mask = np.zeros((len(seqs), t), np.float32)
    for i, s in enumerate(seqs):
        if s:
            toks[i, t - len(s):] = np.asarray(s, np.int32)
            mask[i, t - len(s):] = 1.0
    return toks, mask
