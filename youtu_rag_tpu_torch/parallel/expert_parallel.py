"""The MoE encoder on one device: FFN experts with top-1 routing, in PyTorch.

The port's counterpart of the single-device half of
``youtu_rag_tpu/parallel/expert_parallel.py``: the FFN of each layer
becomes a top-1-routed mixture of ``n_experts`` expert FFNs. A router
(f32) picks one expert per token by ``argmax`` of its softmax (the first
maximum wins, as in JAX); every expert runs over all tokens and its output
is masked by the choice and scaled by the chosen probability, cast to the
activation dtype before the product (``_expert_ffn``). The experts' GELU
is the tanh form (``jax.nn.gelu``'s default).

``load_balancing_loss`` is the Switch-transformer aux loss (E x the sum
over experts of the fraction routed times the mean router probability);
``moe_encode_tokens_with_aux`` returns it averaged over layers, the term
``models/train.py``'s MoE step adds to the InfoNCE objective (argmax
routing passes no gradient to unselected experts, so balance is learned
only through it).

The expert-parallel forms over an ``ep`` mesh axis (``make_ep_encoder``,
``make_ep_encoder_a2a``, ``shard_params_ep``) are not ported yet (ROADMAP
Queue A 8). There is no Pallas site here, so no kernel: the forward is
plain PyTorch with ``encode_tokens``' attention.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..models.encoder import (
    EncoderConfig,
    _attention,
    _layer_norm,
    init_encoder_params,
    layer_views,
    masked_pool_sums,
    pool_project,
)


def init_moe_params(cfg: EncoderConfig, n_experts: int,
                    generator: torch.Generator | None = None) -> dict:
    """Encoder parameters with each layer's FFN replaced by ``n_experts``
    experts and a router: the JAX package's tree and scales (router 0.02,
    ``ew1`` 1/sqrt(D), ``ew2`` 1/sqrt(F), zero biases), values from
    ``generator`` (tests carry JAX's across with
    ``models.convert.moe_params_from_numpy``)."""
    base = init_encoder_params(cfg, generator)
    L, D, Fd, E = cfg.n_layers, cfg.d_model, cfg.d_ff, n_experts

    def init(shape, scale):
        return torch.randn(shape, generator=generator, dtype=torch.float32) * scale

    layers = dict(base["layers"])
    for gone in ("w1", "b1", "w2", "b2"):
        layers.pop(gone)
    layers.update({
        "router": init((L, D, E), 0.02),
        "ew1": init((L, E, D, Fd), 1.0 / np.sqrt(D)),
        "eb1": torch.zeros(L, E, Fd),
        "ew2": init((L, E, Fd, D), 1.0 / np.sqrt(Fd)),
        "eb2": torch.zeros(L, E, D),
    })
    base["layers"] = layers
    return base


def _route(x: torch.Tensor, router_w: torch.Tensor):
    """Top-1 routing in f32. Returns (expert_idx [B, T] int64, prob [B, T],
    probs [B, T, E])."""
    probs = torch.softmax(torch.einsum("btd,de->bte", x.float(), router_w.float()), dim=-1)
    idx = torch.argmax(probs, dim=-1)
    p = torch.gather(probs, -1, idx[..., None])[..., 0]
    return idx, p, probs


def _expert_ffn(x: torch.Tensor, idx: torch.Tensor, p: torch.Tensor, lp: dict,
                n_experts: int, dt: torch.dtype) -> torch.Tensor:
    """Every expert over all tokens, masked by the routing choice and scaled
    by its probability; the sum of the contributions."""
    acc = torch.zeros_like(x)
    for e in range(n_experts):
        h = torch.matmul(x, lp["ew1"][e].to(dt)) + lp["eb1"][e].to(dt)
        h = F.gelu(h, approximate="tanh")
        y = torch.matmul(h, lp["ew2"][e].to(dt)) + lp["eb2"][e].to(dt)
        sel = (idx == e).to(dt) * p.to(dt)
        acc = acc + y * sel[..., None]
    return acc


def load_balancing_loss(probs: torch.Tensor, idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Switch-transformer aux loss: E x sum_e (fraction routed to e) x (mean
    router probability of e), f32. Minimized at uniform routing."""
    onehot = F.one_hot(idx.long(), n_experts).float()
    frac = onehot.reshape(-1, n_experts).mean(dim=0)
    mean_p = probs.float().reshape(-1, n_experts).mean(dim=0)
    return n_experts * torch.sum(frac * mean_p)


def _moe_forward(params: dict, token_ids: torch.Tensor, mask: torch.Tensor,
                 cfg: EncoderConfig, n_experts: int, routes: list | None = None):
    """The forward; ``routes``, where given, collects each layer's expert
    choices [B, T]."""
    dt = cfg.dtype
    x = params["tok_emb"][token_ids.long()].to(dt)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in layer_views(params["layers"], cfg.n_layers):
        h = _layer_norm(x, lp["ln1_scale"], lp["ln1_bias"])
        x = x + _attention(h, mask, lp, cfg)
        h = _layer_norm(x, lp["ln2_scale"], lp["ln2_bias"])
        idx, p, probs = _route(h, lp["router"])
        if routes is not None:
            routes.append(idx)
        aux = aux + load_balancing_loss(probs, idx, n_experts)
        x = x + _expert_ffn(h, idx, p, lp, n_experts, dt)
    x = _layer_norm(x, params["final_ln_scale"], params["final_ln_bias"])
    emb = pool_project(params, *masked_pool_sums(x, mask))
    return emb, x[:, 0, :].float(), aux / cfg.n_layers


def moe_encode_tokens(params: dict, token_ids: torch.Tensor, mask: torch.Tensor,
                      cfg: EncoderConfig, n_experts: int):
    """The MoE forward: ``encode_tokens``' contract, (emb [B, out_dim] f32
    L2-normalized, cls [B, d_model] f32)."""
    emb, cls, _ = _moe_forward(params, token_ids, mask, cfg, n_experts)
    return emb, cls


def moe_encode_tokens_with_aux(params: dict, token_ids: torch.Tensor, mask: torch.Tensor,
                               cfg: EncoderConfig, n_experts: int):
    """``moe_encode_tokens`` and the load-balancing aux loss averaged over
    layers (the training forward): (emb, cls, aux f32 scalar)."""
    return _moe_forward(params, token_ids, mask, cfg, n_experts)


def expert_shares(params: dict, token_ids: torch.Tensor, mask: torch.Tensor,
                  cfg: EncoderConfig, n_experts: int) -> np.ndarray:
    """The share of real tokens each expert receives, per layer: [L, E]
    (a diagnostic of the router's balance)."""
    routes: list = []
    with torch.no_grad():
        _moe_forward(params, token_ids, mask, cfg, n_experts, routes)
    live = mask.reshape(-1) > 0
    n = max(int(live.sum()), 1)
    return np.stack([(torch.bincount(idx.reshape(-1)[live], minlength=n_experts).float() / n)
                     .cpu().numpy() for idx in routes])
