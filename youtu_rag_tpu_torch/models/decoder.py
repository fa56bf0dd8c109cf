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

from ..parallel.comm import GroupAxis, LocalAxis
from .encoder import DTYPES, _checkpointed, _vocab_parallel_lookup, layer_views, tp_layer_views

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


def _qkv(x: torch.Tensor, lp: dict, rope, cfg: DecoderConfig, heads: tuple[int, int] | None = None):
    """q [B, H, T, hd] and k, v [B, Hkv, T, hd] from one projection GEMM,
    rotated for llama. ``heads`` = (H, Hkv) of a tensor-parallel shard
    (default: the config's)."""
    y = torch.matmul(x, lp["wqkv"].to(x.dtype))
    if "bqkv" in lp:
        y = y + lp["bqkv"].to(x.dtype)
    n_h, n_kv = heads or (cfg.n_heads, cfg.n_kv_heads)
    d, kv = n_h * cfg.head_dim, n_kv * cfg.head_dim
    q = _split_heads(y[..., :d], n_h, cfg.head_dim)
    k = _split_heads(y[..., d : d + kv], n_kv, cfg.head_dim)
    v = _split_heads(y[..., d + kv :], n_kv, cfg.head_dim)
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


def _mlp_out(h: torch.Tensor, lp: dict, cfg: DecoderConfig) -> torch.Tensor:
    """The MLP up to its output projection, before the output bias."""
    dt = h.dtype
    if cfg.arch == "gpt2":
        y = torch.matmul(h, lp["w1"].to(dt)) + lp["b1"].to(dt)
        y = F.gelu(y, approximate="tanh")  # HF gelu_new
        return torch.matmul(y, lp["w2"].to(dt))
    g = torch.matmul(h, lp["w_gate"].to(dt))
    u = torch.matmul(h, lp["w1"].to(dt))
    return torch.matmul(F.silu(g) * u, lp["w2"].to(dt))


def _attn_out(x: torch.Tensor, lp: dict, q, k, v, bias, cfg: DecoderConfig) -> torch.Tensor:
    """Attention through the output projection, before the output bias."""
    return torch.matmul(_attend(q, k, v, bias, cfg), lp["wo"].to(x.dtype))


def _residual(x: torch.Tensor, y: torch.Tensor, lp: dict, bias: str) -> torch.Tensor:
    """``x + (y + lp[bias])``, the bias where the layer has one."""
    return x + (y + lp[bias].to(x.dtype) if bias in lp else y)


def _block(x: torch.Tensor, lp: dict, q, k, v, bias, cfg: DecoderConfig) -> torch.Tensor:
    """The rest of a layer once q, k and v are known: attention, the output
    projection, the residuals and the MLP. Tensor parallelism runs the same
    pieces with an all-reduce after ``_attn_out`` and ``_mlp_out``."""
    x = _residual(x, _attn_out(x, lp, q, k, v, bias, cfg), lp, "bo")
    return _residual(x, _mlp_out(_norm(x, lp, "ln2", cfg), lp, cfg), lp, "b2")


def _logits(params: dict, x: torch.Tensor, cfg: DecoderConfig) -> torch.Tensor:
    """f32 logits of the final-normed activations: f32 sums of their
    products with the head in its stored dtype."""
    x = _norm(x, params, "final_ln", cfg)
    w = params["tok_emb"].t() if cfg.tie_embeddings else params["lm_head"]
    return _f32_matmul(x, w)


def _embed(params: dict, tokens: torch.Tensor, pos_ids: torch.Tensor,
           cfg: DecoderConfig) -> torch.Tensor:
    x = F.embedding(tokens.long(), params["tok_emb"]).to(cfg.dtype)
    return _pos_embed(x, params, pos_ids, cfg)


def _pos_embed(x: torch.Tensor, params: dict, pos_ids: torch.Tensor,
               cfg: DecoderConfig) -> torch.Tensor:
    """gpt2's learned positions added to the token embeddings ``x``."""
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


def _slot_bias(attn_mask: torch.Tensor) -> torch.Tensor:
    """A decode step's ``(1 - attn_mask) * NEG_INF`` over the cache's slots:
    [B, 1, 1, maxT] f32."""
    return (1.0 - attn_mask.float())[:, None, None, :] * NEG_INF


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
               device: str | torch.device = "cpu", n_kv_heads: int | None = None) -> dict:
    """Static-shape KV cache [L, B, Hkv, maxT, hd] of zeros; with
    ``kv_cache_dtype == "int8"`` int8 values and f32 scales [L, B, Hkv,
    maxT]. ``n_kv_heads``: a tensor-parallel shard's (default: Hkv)."""
    shape = (cfg.n_layers, batch, n_kv_heads or cfg.n_kv_heads, max_len or cfg.max_len,
             cfg.head_dim)
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


def _cached_qkv(x: torch.Tensor, lp: dict, rope, cache: dict, i: int, t0: int, read: bool,
                cfg: DecoderConfig, heads: tuple[int, int] | None = None):
    """Layer i's q, k and v of ``x``, k and v written into the cache from
    slot ``t0``. With ``read`` (a decode step) the layer's whole cache takes
    the place of k and v; a prefill attends to its full-precision k and v."""
    q, k, v = _qkv(_norm(x, lp, "ln1", cfg), lp, rope, cfg, heads)
    _write_kv(cache, i, k, v, t0)
    if read:
        k, v = _read_kv(cache, i, q.dtype)
    return q, k, v


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
        x = _block(x, lp, *_cached_qkv(x, lp, rope, cache, i, 0, False, cfg), bias, cfg)
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
    bias, rope = _slot_bias(attn_mask), _rope_tables(pos, cfg)
    for i, lp in enumerate(_layers(params, cfg)):
        x = _block(x, lp, *_cached_qkv(x, lp, rope, cache, i, int(t_index), True, cfg), bias, cfg)
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
    b, tp = prompt.shape
    cache = init_cache(cfg, b, tp + max_new_tokens, device=prompt.device)
    return _generate_loop(
        lambda: prefill(params, prompt, prompt_mask, cache, cfg)[0],
        lambda tok, t, attn, pos: decode_step(params, tok, t, attn, pos, cache, cfg)[0],
        prompt_mask, cfg.eos_token_id, max_new_tokens, temperature, top_k, top_p, generator)


def _generate_loop(start, step, prompt_mask: torch.Tensor, eos: int, max_new_tokens: int,
                   temperature: float, top_k: int, top_p: float,
                   generator: torch.Generator | None) -> tuple[torch.Tensor, torch.Tensor]:
    """``generate``'s loop over a model given as ``start()`` (the prefill:
    the last position's logits [B, V]) and ``step(token, t_index,
    attn_mask, pos_ids)`` (a decode step's logits)."""
    dev = prompt_mask.device
    b, tp = prompt_mask.shape
    logits = start()
    attn_mask = torch.cat([prompt_mask.float(),
                           torch.zeros((b, max_new_tokens), dtype=torch.float32, device=dev)], -1)
    pos = prompt_mask.to(torch.int32).sum(-1)  # the next position id
    out = torch.full((b, max_new_tokens), eos, dtype=torch.int32, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    for i in range(max_new_tokens):
        tok = sample_token(logits.to(dev), generator, temperature, top_k, top_p)
        tok = torch.where(done, torch.full_like(tok, eos), tok)
        out[:, i] = tok
        done = done | (tok == eos)
        if bool(done.all()):
            break
        attn_mask[:, tp + i] = 1.0
        logits = step(tok, tp + i, attn_mask, pos + i)
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


# ---------------------------------------------------------------------------
# tensor parallelism over a ("dp", "tp") mesh
# ---------------------------------------------------------------------------


def decoder_sharding_spec(cfg: DecoderConfig) -> dict:
    """JAX's Megatron spec for a ('dp','tp') mesh over the port's tree, one
    tuple per tensor naming the mesh axis each dimension splits over: q/k/v
    (``wqkv``: each of its q, k and v column groups) and FFN-in split by
    columns, o and FFN-out by rows (an all-reduce follows each), the
    vocabulary of ``tok_emb`` by rows and of an untied ``lm_head`` by
    columns; the norms, ``bo``, ``b2`` and ``pos_emb`` replicated."""
    col, row, colb, rep2 = (None, None, "tp"), (None, "tp", None), (None, "tp"), (None, None)
    if cfg.arch == "gpt2":
        layers = {"ln1_scale": rep2, "ln1_bias": rep2, "wqkv": col, "bqkv": colb, "wo": row,
                  "bo": rep2, "ln2_scale": rep2, "ln2_bias": rep2, "w1": col, "b1": colb,
                  "w2": row, "b2": rep2}
        spec = {"tok_emb": ("tp", None), "pos_emb": rep2, "layers": layers,
                "final_ln_scale": (None,), "final_ln_bias": (None,)}
    else:
        layers = {"ln1_scale": rep2, "wqkv": col, "wo": row, "ln2_scale": rep2,
                  "w_gate": col, "w1": col, "w2": row}
        if cfg.qkv_bias:
            layers["bqkv"] = colb
        spec = {"tok_emb": ("tp", None), "layers": layers, "final_ln_scale": (None,)}
    if not cfg.tie_embeddings:
        spec["lm_head"] = (None, "tp")
    return spec


def cache_sharding_spec(cfg: DecoderConfig | None = None) -> dict:
    """KV heads over 'tp', the batch over 'dp' (``decoder_sharding_spec``'s
    match)."""
    spec = {"k": (None, "dp", "tp", None, None), "v": (None, "dp", "tp", None, None)}
    if cfg is not None and cfg.kv_cache_dtype == "int8":
        spec["k_scale"] = spec["v_scale"] = (None, "dp", "tp", None)
    return spec


def tp_part(name: str, t: torch.Tensor, rank: int, tp: int, dim: int,
            cfg: DecoderConfig) -> torch.Tensor:
    """Tensor-parallel rank ``rank``'s part of parameter ``name``, split on
    ``dim``: ``wqkv`` / ``bqkv`` take their share of each of the q, k and v
    column groups."""
    if name in ("wqkv", "bqkv"):
        d, kv = cfg.d_model, cfg.kv_dim
        parts = [t[..., :d], t[..., d : d + kv], t[..., d + kv :]]
        return torch.cat([p.chunk(tp, dim=-1)[rank] for p in parts], dim=-1).contiguous()
    return t.chunk(tp, dim=dim)[rank].contiguous()


def tp_join(name: str, parts: list[torch.Tensor], dim: int, cfg: DecoderConfig) -> torch.Tensor:
    """The full parameter from its ``tp_part`` parts (in rank order)."""
    if name in ("wqkv", "bqkv"):
        n = len(parts)
        d, kv = cfg.d_model // n, cfg.kv_dim // n
        groups = [[p[..., :d] for p in parts], [p[..., d : d + kv] for p in parts],
                  [p[..., d + kv :] for p in parts]]
        return torch.cat([torch.cat(g, dim=-1) for g in groups], dim=-1)
    return torch.cat(parts, dim)


def _tp_slice(name: str, t: torch.Tensor, rank: int, tp: int, cfg: DecoderConfig,
              spec: dict) -> torch.Tensor:
    """Tensor-parallel rank ``rank``'s part of parameter ``name`` (``spec``:
    the flattened ``decoder_sharding_spec``)."""
    if "tp" not in spec[name]:
        return t
    return tp_part(name, t, rank, tp, spec[name].index("tp"), cfg)


def check_tp(cfg: DecoderConfig, tp: int) -> None:
    """Heads, kv heads and the FFN width must split over tp."""
    for what, n in (("n_heads", cfg.n_heads), ("n_kv_heads", cfg.n_kv_heads),
                    ("d_ff", cfg.d_ff)):
        if n % tp:
            raise ValueError(f"{what} {n} does not split over tp = {tp}")


def tp_causal_logits(params: dict, tokens: torch.Tensor, mask: torch.Tensor,
                     cfg: DecoderConfig, axis, remat: bool = False) -> torch.Tensor:
    """``causal_logits`` with Megatron tensor parallelism over ``axis`` (a
    ``parallel.comm`` axis), differentiable: ``params`` is one replica's
    placed tree (``parallel.placement``; the leaves ``decoder_sharding_spec``
    splits are lists of this process's shards). Per layer the normed
    activations are copied into the shards, each attends with its heads
    and runs its MLP columns, the row-split outputs reduce before the
    output biases; the head's vocabulary columns gather at the end.
    [B, T, vocab] f32 logits on the axis' first device, replicated."""
    tp = axis.size
    check_tp(cfg, tp)
    heads = (cfg.n_heads // tp, cfg.n_kv_heads // tp)
    pos_ids = position_ids_from_mask(mask)
    x = _vocab_parallel_lookup(params["tok_emb"], tokens.long(), axis, lambda e: e.to(cfg.dtype))
    x = _pos_embed(x, params, pos_ids, cfg)
    biases = [_causal_bias(mask).to(d) for d in axis.devices]
    rope = _rope_tables(pos_ids, cfg)
    ropes = [None if rope is None else tuple(r.to(d) for r in rope) for d in axis.devices]

    def layer(x, lp, lps):
        parts = [_attn_out(hj, lpj, *_qkv(hj, lpj, rj, cfg, heads), bj, cfg)
                 for hj, lpj, rj, bj in zip(axis.copy(_norm(x, lp, "ln1", cfg)), lps, ropes,
                                            biases)]
        x = _residual(x, axis.reduce(parts), lp, "bo")
        parts = [_mlp_out(hj, lpj, cfg) for hj, lpj in zip(axis.copy(_norm(x, lp, "ln2", cfg)),
                                                            lps)]
        return _residual(x, axis.reduce(parts), lp, "b2")

    step = _checkpointed(layer, remat)
    for lp, lps in tp_layer_views(params["layers"], cfg.n_layers):
        x = step(x, lp, lps)
    x = _norm(x, params, "final_ln", cfg)
    head = params["tok_emb"] if cfg.tie_embeddings else params["lm_head"]
    if not isinstance(head, list):
        return _f32_matmul(x, head.t() if cfg.tie_embeddings else head)
    return axis.gather([_f32_matmul(xj, w.t() if cfg.tie_embeddings else w)
                        for xj, w in zip(axis.copy(x), head)], -1)


@dataclass
class TPDecoder:
    """A decoder placed on a ('dp', 'tp') mesh (``shard_decoder``): for each
    of this process's dp rows, the tp shards' parameters on their devices
    and the row's collective; every dp row serves its slice of the batch."""

    cfg: DecoderConfig
    dp: int
    tp: int
    rows: list[int]  # this process's dp rows
    tp_ranks: list[list[int]]  # [row][shard]: each shard's tp rank
    shards: list[list[dict]]  # [row][shard] parameters
    devices: list[list[torch.device]]
    comms: list
    dp_group: object = None  # the dp axis's process group (a group mesh)

    @property
    def local_heads(self) -> tuple[int, int]:
        return self.cfg.n_heads // self.tp, self.cfg.n_kv_heads // self.tp

    def init_cache(self, batch: int, max_len: int | None = None) -> list[list[dict]]:
        """Each shard's KV cache (``cache_sharding_spec``): batch / dp rows,
        Hkv / tp heads, on the shard's device."""
        return [[init_cache(self.cfg, batch // self.dp, max_len, device=dev,
                            n_kv_heads=self.local_heads[1]) for dev in devs]
                for devs in self.devices]


def shard_decoder(params: dict, cfg: DecoderConfig, mesh) -> TPDecoder:
    """Place ``params`` on a ('dp', 'tp') mesh (``parallel.mesh``) as
    ``decoder_sharding_spec`` says: every device of the mesh gets its tp
    rank's slices (replicated over dp). On a group mesh a process keeps its
    own slot's. The heads, kv heads, FFN width and vocabulary must divide by
    tp."""
    dp, tp = mesh.shape.get("dp", 1), mesh.shape["tp"]
    check_tp(cfg, tp)
    if cfg.vocab_size % tp:
        raise ValueError(f"vocab_size {cfg.vocab_size} does not split over tp = {tp}")
    axes = ("dp", "tp") if "dp" in mesh.shape else ("tp",)
    devs, procs = mesh.layout(axes)
    devs, procs = devs[0].reshape(dp, tp), procs[0].reshape(dp, tp)
    me = torch.distributed.get_rank() if mesh.distributed else 0
    rows = sorted({i for i in range(dp) for j in range(tp) if procs[i, j] == me})
    spec = decoder_sharding_spec(cfg)
    spec = {**spec, **spec["layers"]}
    tp_ranks, shards, devices, comms = [], [], [], []
    for i in rows:
        ranks = [j for j in range(tp) if procs[i, j] == me]
        row_devs = [devs[i, j] for j in ranks]
        shards.append([_tree_map_named(params, lambda n, t, j=j, d=d: _tp_slice(
            n, t, j, tp, cfg, spec).to(d)) for j, d in zip(ranks, row_devs)])
        tp_ranks.append(ranks)
        devices.append(row_devs)
        if mesh.distributed:
            if len(ranks) != 1:
                raise ValueError("a group mesh holds one (dp, tp) slot per process")
            comms.append(GroupAxis(mesh.group(("tp",)), row_devs[0]))
        else:
            comms.append(LocalAxis(row_devs))
    dp_group = mesh.group(("dp",)) if mesh.distributed and "dp" in mesh.shape else None
    return TPDecoder(cfg, dp, tp, rows, tp_ranks, shards, devices, comms, dp_group)


def _tree_map_named(tree: dict, fn) -> dict:
    return {k: _tree_map_named(v, fn) if isinstance(v, dict) else fn(k, v) for k, v in tree.items()}


def _tp_row_forward(tpd: TPDecoder, r: int, tokens: torch.Tensor, mask_or_bias,
                    pos_ids: torch.Tensor, caches: list[dict], t0: int, prefill_mode: bool):
    """One dp row's forward through its tp shards: the vocabulary-sharded
    embedding (an all-reduce of the masked lookups), per layer attention on
    the shard's heads and the row-split output projection (all-reduce), the
    column-split MLP and its row-split output (all-reduce), then the
    shards' logits joined. Writes each shard's cache at slot ``t0`` on.
    Returns the last position's logits [b, V] f32."""
    cfg, comm, devs, shards = tpd.cfg, tpd.comms[r], tpd.devices[r], tpd.shards[r]
    vt = cfg.vocab_size // tpd.tp
    parts = []
    for p, dev, j in zip(shards, devs, tpd.tp_ranks[r]):
        local = tokens.to(dev).long() - j * vt
        inside = (local >= 0) & (local < vt)
        e = F.embedding(local.clamp(0, vt - 1), p["tok_emb"]).to(cfg.dtype)
        parts.append(torch.where(inside[..., None], e, torch.zeros_like(e)))
    pos = [pos_ids.to(d) for d in devs]
    xs = [_pos_embed(x, p, q, cfg) for x, p, q in zip(comm.all_reduce(parts), shards, pos)]
    make_bias = _causal_bias if prefill_mode else _slot_bias
    biases = [make_bias(mask_or_bias.to(d)) for d in devs]
    ropes = [_rope_tables(q, cfg) for q in pos]
    layers = [_layers(p, cfg) for p in shards]
    for i in range(cfg.n_layers):
        lps = [ls[i] for ls in layers]
        attn = comm.all_reduce([
            _attn_out(x, lp, *_cached_qkv(x, lp, rope, cache, i, t0, not prefill_mode, cfg,
                                          tpd.local_heads), bias, cfg)
            for x, lp, bias, rope, cache in zip(xs, lps, biases, ropes, caches)])
        xs = [_residual(x, a, lp, "bo") for x, a, lp in zip(xs, attn, lps)]
        mlp = comm.all_reduce([_mlp_out(_norm(x, lp, "ln2", cfg), lp, cfg)
                               for x, lp in zip(xs, lps)])
        xs = [_residual(x, m, lp, "b2") for x, m, lp in zip(xs, mlp, lps)]
    return comm.gather([_logits(p, x[:, -1:, :], cfg)[:, 0] for x, p in zip(xs, shards)])


def _tp_rows(tpd: TPDecoder, fn, batch: int) -> torch.Tensor:
    """``fn(r, rows)`` for each of this process's dp rows on its slice of the
    batch, joined in batch order (over the dp group on a group mesh)."""
    per = batch // tpd.dp
    outs = [fn(r, slice(i * per, (i + 1) * per)) for r, i in enumerate(tpd.rows)]
    out = torch.cat([o.to(outs[0].device) for o in outs])
    n_dp = torch.distributed.get_world_size(tpd.dp_group) if tpd.dp_group is not None else 1
    if n_dp > 1:
        parts = [torch.empty_like(out) for _ in range(n_dp)]
        torch.distributed.all_gather(parts, out.contiguous(), group=tpd.dp_group)
        out = torch.cat(parts)
    return out


def tp_prefill(tpd: TPDecoder, tokens: torch.Tensor, mask: torch.Tensor,
               caches: list[list[dict]]) -> torch.Tensor:
    """``prefill`` on the mesh: each dp row its slice of the (left-padded)
    batch [B, T]; writes every shard's cache. Returns the last position's
    logits [B, V] f32 (on the first shard's device)."""
    if tokens.shape[0] % tpd.dp:
        raise ValueError(f"batch {tokens.shape[0]} does not split over dp = {tpd.dp}")
    pos = position_ids_from_mask(mask)
    return _tp_rows(tpd, lambda r, sl: _tp_row_forward(tpd, r, tokens[sl], mask[sl], pos[sl],
                                                       caches[r], 0, True), tokens.shape[0])


def tp_decode_step(tpd: TPDecoder, token: torch.Tensor, t_index: int, attn_mask: torch.Tensor,
                   pos_ids: torch.Tensor, caches: list[list[dict]]) -> torch.Tensor:
    """``decode_step`` on the mesh: logits [B, V] f32 of the next token."""
    return _tp_rows(tpd, lambda r, sl: _tp_row_forward(
        tpd, r, token[sl].reshape(-1, 1), attn_mask[sl], pos_ids[sl].reshape(-1, 1), caches[r],
        int(t_index), False), token.shape[0])


@torch.inference_mode()
def tp_generate(tpd: TPDecoder, prompt: torch.Tensor, prompt_mask: torch.Tensor,
                max_new_tokens: int = 128, temperature: float = 0.0, top_k: int = 0,
                top_p: float = 1.0, generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``generate`` on the mesh (its loop, tokens and lengths): ``tp_prefill``,
    then ``tp_decode_step`` until every row has emitted EOS. Greedy tokens
    equal the replicated run's."""
    dev = tpd.devices[0][0]
    prompt, prompt_mask = prompt.to(dev), prompt_mask.to(dev)
    b, tp_len = prompt.shape
    caches = tpd.init_cache(b, tp_len + max_new_tokens)
    return _generate_loop(
        lambda: tp_prefill(tpd, prompt, prompt_mask, caches),
        lambda tok, t, attn, pos: tp_decode_step(tpd, tok, t, attn, pos, caches),
        prompt_mask, tpd.cfg.eos_token_id, max_new_tokens, temperature, top_k, top_p, generator)
