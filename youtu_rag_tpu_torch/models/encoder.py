"""Transformer encoder trunk (the embedder's and reranker's backbone), in
PyTorch.

The port's counterpart of ``youtu_rag_tpu/models/encoder.py``, both archs:
- ``"preln_rope"``, the repo's own trunk: pre-LN layers with RoPE and no
  attention biases, mean pooling over the mask, a projection and an L2
  normalization, with the two lexical epilogues (``lex_proj`` blend and
  ``lex_buckets`` concat);
- ``"bert"``, the HF BERT-family layout that pretrained bge/gte/e5-style
  checkpoints use (``models/pretrained.py`` loads them): learned absolute
  positions and token types summed in f32, post-LN layers with biased
  q/k/v/o projections and no RoPE, exact-erf GELU unless
  ``gelu_approximate``, ``cls`` or ``mean`` pooling, an optional
  ``out_proj``, then L2; ``rerank_scores`` adds the tanh pooler and the
  classifier head of a cross-encoder.
The parameters are a plain dict of f32 tensors with the layers stacked on
a leading axis, the JAX package's tree and npz layout, and the forward
runs the layers in a Python loop.

The rounding points are the JAX package's: parameters stay f32 and are
cast to ``cfg.dtype`` at each use; LayerNorm (population variance, eps
``1e-6`` for preln_rope and ``cfg.ln_eps`` for bert), pooling and the
epilogues run in f32; RoPE's cos and sin are cast to ``cfg.dtype`` before
the product. Attention goes through ``ops/attention.py`` by the JAX
dispatch rule (``_attention_core``): with "pallas" every layer at T >= 256
launches the blockwise kernel (flash above T = 4096), for either arch.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import (
    blockwise_attention,
    blockwise_attention_reference,
    flash_attention,
)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}
ATTENTION_IMPLS = ("xla", "pallas", "flash", "pallas_interpret")


@dataclass(frozen=True)
class EncoderConfig:
    """A copy of the JAX package's ``EncoderConfig`` with ``dtype`` as a
    torch dtype. ``attention_impl`` keeps the JAX names so that committed
    configs load unchanged: "xla" plain PyTorch attention; "pallas" the
    kernels by sequence length (blockwise up to T = 4096, flash above);
    "flash" the flash kernel for every qualifying T; "pallas_interpret"
    the kernels' plain versions."""

    vocab_size: int = 32768
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_len: int = 512
    out_dim: int = 768  # embedding dimension (projection from d_model)
    dtype: torch.dtype = torch.bfloat16
    rope_base: float = 10000.0
    attention_impl: str = "xla"
    arch: str = "preln_rope"  # or "bert" (the HF BERT-family layout)
    pooling: str = "mean"  # bert: "mean" or "cls"
    lex_pool: bool = False  # lexical residual over the input token embeddings
    lex_buckets: int = 0  # > 0: the sparse hashed-bucket channel instead of lex_proj
    lex_gate_init: float = 0.85
    ln_eps: float = 1e-6  # bert checkpoints use 1e-12
    type_vocab_size: int = 2  # bert token-type (segment) vocabulary
    gelu_approximate: bool = True  # HF "gelu" is the exact erf form

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} is not a multiple of n_heads {self.n_heads}")
        return self.d_model // self.n_heads

    @property
    def embed_dim(self) -> int:
        """Final embedding dimension (out_dim + the sparse lexical channel)."""
        return self.out_dim + (self.lex_buckets if self.lex_pool else 0)


ARCHS = ("preln_rope", "bert")


def _check_arch(cfg: EncoderConfig) -> None:
    if cfg.arch not in ARCHS:
        raise ValueError(f"encoder arch {cfg.arch!r} not in {ARCHS}")
    if cfg.attention_impl not in ATTENTION_IMPLS:
        raise ValueError(f"attention_impl {cfg.attention_impl!r} not in {ATTENTION_IMPLS}")


def save_encoder_config(cfg: EncoderConfig, path) -> None:
    """The JAX package's JSON layout (``dtype`` by name)."""
    d = dataclasses.asdict(cfg)
    d["dtype"] = next(name for name, dt in DTYPES.items() if dt == cfg.dtype)
    with open(path, "w") as f:
        json.dump(d, f, indent=1)


def load_encoder_config(path) -> EncoderConfig:
    """Read an ``encoder_config.json`` written by either package."""
    with open(path) as f:
        d = json.load(f)
    if isinstance(d.get("dtype"), str):
        d["dtype"] = DTYPES[d["dtype"]]
    return EncoderConfig(**d)


def init_encoder_params(cfg: EncoderConfig, generator: torch.Generator | None = None) -> dict:
    """Seeded f32 parameters, layers stacked on axis 0, on the CPU. The
    shapes and scales are the JAX package's; the values come from
    ``generator`` and differ from JAX's (tests carry JAX's across with
    ``models.convert.encoder_params_from_numpy`` instead)."""
    _check_arch(cfg)
    D, Fd, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size
    s_attn, s_ff = 1.0 / np.sqrt(D), 1.0 / np.sqrt(Fd)

    def init(shape, scale):
        return torch.randn(shape, generator=generator, dtype=torch.float32) * scale

    if cfg.arch == "bert":
        return {
            "tok_emb": init((V, D), 0.02),
            "pos_emb": init((cfg.max_len, D), 0.02),
            "type_emb": init((cfg.type_vocab_size, D), 0.02),
            "emb_ln_scale": torch.ones(D),
            "emb_ln_bias": torch.zeros(D),
            "layers": {
                "wq": init((L, D, D), s_attn), "bq": torch.zeros(L, D),
                "wk": init((L, D, D), s_attn), "bk": torch.zeros(L, D),
                "wv": init((L, D, D), s_attn), "bv": torch.zeros(L, D),
                "wo": init((L, D, D), s_attn), "bo": torch.zeros(L, D),
                "ln1_scale": torch.ones(L, D), "ln1_bias": torch.zeros(L, D),
                "w1": init((L, D, Fd), s_attn), "b1": torch.zeros(L, Fd),
                "w2": init((L, Fd, D), s_ff), "b2": torch.zeros(L, D),
                "ln2_scale": torch.ones(L, D), "ln2_bias": torch.zeros(L, D),
            },
            "score_head": init((D, 1), s_attn),
        }
    params = {"tok_emb": init((V, D), 0.02)}
    if cfg.lex_pool:
        g0 = min(max(cfg.lex_gate_init, 1e-4), 1 - 1e-4)
        params["tok_weight"] = torch.zeros(V)
        params["lex_mix"] = torch.tensor(float(np.log(g0 / (1 - g0))), dtype=torch.float32)
        if not cfg.lex_buckets:
            params["lex_proj"] = init((D, cfg.out_dim), s_attn)
    params["layers"] = {
        "ln1_scale": torch.ones(L, D),
        "ln1_bias": torch.zeros(L, D),
        "wq": init((L, D, D), s_attn),
        "wk": init((L, D, D), s_attn),
        "wv": init((L, D, D), s_attn),
        "wo": init((L, D, D), s_attn),
        "ln2_scale": torch.ones(L, D),
        "ln2_bias": torch.zeros(L, D),
        "w1": init((L, D, Fd), s_attn),
        "b1": torch.zeros(L, Fd),
        "w2": init((L, Fd, D), s_ff),
        "b2": torch.zeros(L, D),
    }
    params["final_ln_scale"] = torch.ones(D)
    params["final_ln_bias"] = torch.zeros(D)
    params["out_proj"] = init((D, cfg.out_dim), s_attn)
    params["score_head"] = init((D, 1), s_attn)
    return params


def count_params(params: dict) -> int:
    """The number of scalars in a parameter tree."""
    return sum(count_params(v) if isinstance(v, dict) else v.numel() for v in params.values())


def save_params_npz(params: dict, path) -> None:
    """One npz, nested keys joined by '/' (the JAX package's layout)."""
    flat: dict[str, np.ndarray] = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = node.detach().cpu().numpy()

    walk("", params)
    np.savez_compressed(path, **flat)


def load_params_npz(path, device: str | torch.device = "cpu") -> dict:
    """The nested parameter dict of an npz written by either package."""
    out: dict = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = torch.from_numpy(np.array(data[key])).to(device)
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def layer_views(layers: dict, n: int) -> list[dict]:
    """Layers 0..n-1's parameters as views of the stacked tensors, one
    ``unbind`` a tensor: a backward pass then stacks each weight's gradient
    once, where indexing would add a full-size [L, ...] tensor a layer."""
    cols = {name: w.unbind(0) for name, w in layers.items()}
    return [{name: c[i] for name, c in cols.items()} for i in range(n)]


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm computed in f32 (population variance, f32 scale and bias),
    cast back to x's type once, as the JAX package rounds it."""
    return F.layer_norm(x.float(), (x.shape[-1],), scale, bias, eps).to(x.dtype)


def _rope(x: torch.Tensor, base: float, pos_offset=0) -> torch.Tensor:
    """Rotary embedding over the last dim of [B, H, T, hd]; cos and sin are
    computed in f32 and cast to x's type before the product. Positions are
    ``arange(T) + pos_offset`` in f32: the sequence-parallel forward passes
    each shard's global start (a number, or an f32 tensor broadcasting
    over [..., T, 1], one offset per leading index)."""
    t, hd = x.shape[-2], x.shape[-1]
    half = hd // 2
    idx = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(base, dtype=torch.float32, device=x.device), idx)
    pos = torch.arange(t, dtype=torch.float32, device=x.device)
    if isinstance(pos_offset, torch.Tensor):
        pos = pos[:, None] + pos_offset  # [..., T, 1]
        ang = pos * freqs
    else:
        pos = pos + float(pos_offset)
        ang = pos[:, None] * freqs[None, :]
    cos = torch.cos(ang).to(x.dtype)
    sin = torch.sin(ang).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _ffn(h: torch.Tensor, lp: dict, dt: torch.dtype, approximate: bool = True) -> torch.Tensor:
    h = torch.matmul(h, lp["w1"].to(dt)) + lp["b1"].to(dt)
    h = F.gelu(h, approximate="tanh" if approximate else "none")
    return torch.matmul(h, lp["w2"].to(dt)) + lp["b2"].to(dt)


def masked_pool_sums(x: torch.Tensor, mask: torch.Tensor):
    """Masked token sums and counts, in f32."""
    m = mask.float()[:, :, None]
    return (x.float() * m).sum(dim=1), m.sum(dim=1)


def _l2_normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(torch.linalg.vector_norm(v, dim=-1, keepdim=True), 1e-12)


def pool_project(params: dict, summed: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Mean pool from (sums, counts) → out_proj → L2 normalize (f32)."""
    pooled = summed / torch.clamp_min(count, 1.0)
    return _l2_normalize(pooled @ params["out_proj"])


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0); F.softplus switches to x above 20
    return torch.logaddexp(x, torch.zeros_like(x))


def _token_weights(params: dict, token_ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return _softplus(params["tok_weight"].float())[token_ids] * mask.float()  # [B, T]


def _lex_blend(params: dict, token_ids: torch.Tensor, mask: torch.Tensor,
               summed: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Gate-weighted blend of the contextual mean-pool and a learned-weight
    lexical pool of the input token embeddings (``lex_proj``)."""
    w = _token_weights(params, token_ids, mask)
    tokv = params["tok_emb"].float()[token_ids]  # [B, T, D]
    lex = torch.einsum("bt,btd->bd", w, tokv) / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-6)
    ctx = (summed / torch.clamp_min(count, 1.0)) @ params["out_proj"]
    lex = lex @ params["lex_proj"]
    g = torch.sigmoid(params["lex_mix"].float())
    return _l2_normalize((1.0 - g) * _l2_normalize(ctx) + g * _l2_normalize(lex))


def _lex_bucket_concat(params: dict, token_ids: torch.Tensor, mask: torch.Tensor,
                       cfg: EncoderConfig, summed: torch.Tensor,
                       count: torch.Tensor) -> torch.Tensor:
    """The sparse lexical channel: a learned-weight hashed bag of words
    (bucket = token id mod ``lex_buckets``, log1p of the summed weights)
    concatenated onto the contextual embedding, gate-weighted."""
    w = _token_weights(params, token_ids, mask)
    bow = torch.zeros((w.shape[0], cfg.lex_buckets), dtype=torch.float32, device=w.device)
    lex = torch.log1p(bow.scatter_add_(1, token_ids.long() % cfg.lex_buckets, w))
    ctx = (summed / torch.clamp_min(count, 1.0)) @ params["out_proj"]
    g = torch.sigmoid(params["lex_mix"].float())
    emb = torch.cat([(1.0 - g) * _l2_normalize(ctx), g * _l2_normalize(lex)], dim=-1)
    return _l2_normalize(emb)


def _attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                    cfg: EncoderConfig) -> torch.Tensor:
    """Scaled-dot-product attention of projected heads [B, H, T, hd], by
    the JAX package's dispatch rule: the kernels for T >= 256, T % 128 == 0
    and hd % 64 == 0 unless ``attention_impl`` is "xla" (blockwise up to
    T = 4096, flash above it or for "flash"; "pallas_interpret" always
    takes the blockwise plain version, as JAX's interpret mode does), else
    plain attention."""
    t, hd = q.shape[2], q.shape[3]
    impl = cfg.attention_impl
    if impl != "xla" and t >= 256 and t % 128 == 0 and hd % 64 == 0:
        bias2d = (1.0 - mask.float()) * -1e9  # [B, T]
        if impl == "pallas_interpret":
            return blockwise_attention_reference(q, k, v, bias2d)
        if impl == "flash" or (impl == "pallas" and t > 4096):
            return flash_attention(q, k, v, bias2d)
        return blockwise_attention(q, k, v, bias2d)
    if q.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    mask_bias = (1.0 - mask[:, None, None, :].float()) * -1e9
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))  # f32 sums of exact products
    scores = scores / np.sqrt(hd) + mask_bias
    attn = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(attn, v)


def _attention(x: torch.Tensor, mask: torch.Tensor, lp: dict, cfg: EncoderConfig) -> torch.Tensor:
    b, t, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim

    def proj(w):
        return torch.matmul(x, w.to(x.dtype)).view(b, t, h, hd).transpose(1, 2)  # [B, H, T, hd]

    q = _rope(proj(lp["wq"]), cfg.rope_base)
    k = _rope(proj(lp["wk"]), cfg.rope_base)
    v = proj(lp["wv"])
    y = _attention_core(q, k, v, mask, cfg)
    y = y.transpose(1, 2).reshape(b, t, d)
    return torch.matmul(y, lp["wo"].to(x.dtype))


def _bert_attention(x: torch.Tensor, mask: torch.Tensor, lp: dict,
                    cfg: EncoderConfig) -> torch.Tensor:
    """BERT-family attention: biased q/k/v/o projections, no RoPE. q, k and v
    reach ``_attention_core`` as [B, T, H, hd] views transposed to
    [B, H, T, hd] (strides T·D, hd, D, 1), which the kernels take as they
    are."""
    b, t, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim

    def proj(w, bias):
        y = torch.matmul(x, w.to(x.dtype)) + bias.to(x.dtype)
        return y.view(b, t, h, hd).transpose(1, 2)

    q = proj(lp["wq"], lp["bq"])
    k = proj(lp["wk"], lp["bk"])
    v = proj(lp["wv"], lp["bv"])
    y = _attention_core(q, k, v, mask, cfg)
    y = y.transpose(1, 2).reshape(b, t, d)
    return torch.matmul(y, lp["wo"].to(x.dtype)) + lp["bo"].to(x.dtype)


def _bert_encode(params: dict, token_ids: torch.Tensor, mask: torch.Tensor,
                 cfg: EncoderConfig, type_ids: torch.Tensor | None = None):
    """BERT-family forward (post-LN residuals, learned positions), the math of
    ``transformers.BertModel``."""
    dt = cfg.dtype
    t = token_ids.shape[1]
    if t > params["pos_emb"].shape[0]:
        raise ValueError(
            f"sequence length {t} exceeds the checkpoint's learned position "
            f"table ({params['pos_emb'].shape[0]}); BERT-family models cannot "
            "extrapolate positions — truncate or chunk the input"
        )
    x32 = params["tok_emb"][token_ids].float() + params["pos_emb"][:t][None].float()
    if type_ids is None:
        x32 = x32 + params["type_emb"][0][None, None].float()
    else:
        x32 = x32 + params["type_emb"][type_ids.long()].float()
    eps = cfg.ln_eps
    x = _layer_norm(x32, params["emb_ln_scale"], params["emb_ln_bias"], eps).to(dt)
    for lp in layer_views(params["layers"], cfg.n_layers):
        x = _layer_norm(x + _bert_attention(x, mask, lp, cfg), lp["ln1_scale"], lp["ln1_bias"],
                        eps)
        x = _layer_norm(x + _ffn(x, lp, dt, approximate=cfg.gelu_approximate), lp["ln2_scale"],
                        lp["ln2_bias"], eps)
    if cfg.pooling == "cls":
        pooled = x[:, 0, :].float()
    else:
        summed, cnt = masked_pool_sums(x, mask)
        pooled = summed / torch.clamp_min(cnt, 1.0)
    if "out_proj" in params:
        pooled = pooled @ params["out_proj"]
    return _l2_normalize(pooled), x[:, 0, :].float()


def encode_tokens(params: dict, token_ids: torch.Tensor, mask: torch.Tensor,
                  cfg: EncoderConfig,
                  type_ids: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward pass.

    token_ids [B, T] integer, mask [B, T] float (1 = real token), type_ids
    [B, T] integer segment ids (bert only; None: all 0), on the parameters'
    device. Returns (embeddings [B, embed_dim] f32 L2-normalized, cls_state
    [B, d_model] f32). Differentiable with ``attention_impl="xla"`` (the
    trainers' setting); the attention kernels refuse a differentiable call.
    The serving callers (``TorchEmbedder.embed_batch``, ``rerank_scores``,
    the sequence-parallel forward) run it under ``torch.inference_mode``."""
    _check_arch(cfg)
    token_ids = token_ids.long()
    if cfg.arch == "bert":
        return _bert_encode(params, token_ids, mask, cfg, type_ids)
    dt = cfg.dtype
    x = params["tok_emb"][token_ids].to(dt)  # [B, T, D]
    for lp in layer_views(params["layers"], cfg.n_layers):
        h = _layer_norm(x, lp["ln1_scale"], lp["ln1_bias"])
        x = x + _attention(h, mask, lp, cfg)
        h = _layer_norm(x, lp["ln2_scale"], lp["ln2_bias"])
        x = x + _ffn(h, lp, dt)
    x = _layer_norm(x, params["final_ln_scale"], params["final_ln_bias"])

    sums = masked_pool_sums(x, mask)
    if cfg.lex_pool and cfg.lex_buckets:
        emb = _lex_bucket_concat(params, token_ids, mask, cfg, *sums)
    elif cfg.lex_pool and "lex_proj" in params:
        emb = _lex_blend(params, token_ids, mask, *sums)
    else:
        emb = pool_project(params, *sums)
    return emb, x[:, 0, :].float()


@torch.inference_mode()
def rerank_scores(params: dict, token_ids: torch.Tensor, mask: torch.Tensor,
                  cfg: EncoderConfig, type_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Cross-encoder relevance scores [B] f32 from the CLS state, through the
    tanh pooler and the score head (and its bias) where the parameters have
    them (pretrained sequence-classification rerankers do)."""
    _, cls = encode_tokens(params, token_ids, mask, cfg, type_ids=type_ids)
    if "pooler_w" in params:
        cls = torch.tanh(cls @ params["pooler_w"] + params["pooler_b"])
    s = (cls @ params["score_head"])[:, 0]
    if "score_bias" in params:
        s = s + params["score_bias"][0]
    return s
