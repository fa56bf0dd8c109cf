"""The MoE encoder: FFN experts with top-1 routing, in PyTorch.

The port's counterpart of the single-device half of
``youtu_rag_tpu/parallel/expert_parallel.py``: the FFN of each layer
becomes a top-1-routed mixture of ``n_experts`` expert FFNs. A router
(f32) picks one expert per token by ``argmax`` of its softmax (the first
maximum wins, as in JAX); every expert runs over all tokens and its output
is masked by the choice and scaled by the chosen probability, cast to the
activation dtype before the product (``_expert_ffn``). The experts' GELU
is the tanh form (``jax.nn.gelu``'s default).

``load_balancing_loss`` is the Switch-transformer aux loss (E x the sum
over experts of the fraction routed times the mean router probability;
``switch_aux`` computes it from token counts and probability sums, which
add over dp rows); ``moe_encode_tokens_with_aux`` returns it averaged over
layers, the term
``models/train.py``'s MoE step adds to the InfoNCE objective (argmax
routing passes no gradient to unselected experts, so balance is learned
only through it).

The expert-parallel forms shard the experts over an ``ep`` axis of a
``parallel.mesh`` mesh (``shard_params_ep`` places them; a local mesh holds
every shard in this process, a group mesh one per rank, through
``parallel.comm``):

- ``make_ep_encoder`` (``ep_forward``; the one-device forward is
  ``ep_forward`` over one shard holding every expert): each shard
  evaluates its local experts over all tokens, masked by the routing
  choice, and the shards' outputs reduce (JAX's ``psum``). Attention and the router are replicated, so they run once per
  process (once for all the shards of a local mesh);
- ``make_ep_encoder_a2a``: the batch shards over ``ep`` too; each shard
  routes its tokens into per-destination capacity slots, one all-to-all
  moves them, the receiver packs them into per-expert blocks (one batched
  product per weight), and a second all-to-all brings the outputs back.
  Tokens past either capacity are dropped for that layer, as in JAX
  (``capacity_factor`` per destination, ``expert_capacity_factor`` per
  expert). On a local mesh the attention runs once over all the shards'
  rows.

Routing is argmax with the first maximum winning, and each token has one
nonzero term in the experts' sum, so the sharded and unsharded forwards
agree. There is no Pallas site here, so no kernel of its own: attention is
``encode_tokens``' (the blockwise kernel with "pallas" at T >= 256 on the
card, when no gradient is wanted).
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
    masked_pool_sums,
    one_shard,
    pool_project,
    tp_layer_views,
)
from .placement import Placement


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
                n_experts: int, dt: torch.dtype, e_base: int = 0) -> torch.Tensor:
    """``n_experts`` experts (global ids ``e_base`` on: a shard's local ones)
    over all tokens, masked by the routing choice and scaled by its
    probability; the sum of the contributions."""
    acc = torch.zeros_like(x)
    for e in range(n_experts):
        h = torch.matmul(x, lp["ew1"][e].to(dt)) + lp["eb1"][e].to(dt)
        h = F.gelu(h, approximate="tanh")
        y = torch.matmul(h, lp["ew2"][e].to(dt)) + lp["eb2"][e].to(dt)
        sel = (idx == e_base + e).to(dt) * p.to(dt)
        acc = acc + y * sel[..., None]
    return acc


def route_stats(idx: torch.Tensor, probs: torch.Tensor, n_experts: int):
    """One layer's routing terms over its tokens: (tokens per expert [E],
    router probabilities summed [E]), f32. They add over dp rows."""
    return (F.one_hot(idx.reshape(-1).long(), n_experts).sum(0).float(),
            probs.float().reshape(-1, n_experts).sum(0))


def switch_aux(counts: torch.Tensor, prob_sums: torch.Tensor, n_tok: int,
               n_experts: int) -> torch.Tensor:
    """The Switch-transformer aux loss from ``route_stats`` stacked over
    layers ([L, E] each, over ``n_tok`` tokens): E x sum_e (fraction routed
    to e) x (mean router probability of e), averaged over the layers."""
    frac, mean_p = counts / n_tok, prob_sums / n_tok
    return torch.sum(n_experts * torch.sum(frac * mean_p, dim=1)) / counts.shape[0]


def load_balancing_loss(probs: torch.Tensor, idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Switch-transformer aux loss of one layer, f32 (``switch_aux``).
    Minimized at uniform routing."""
    counts, prob_sums = route_stats(idx, probs, n_experts)
    return switch_aux(counts[None], prob_sums[None], idx.numel(), n_experts)


def _moe_layer(x: torch.Tensor, mask: torch.Tensor, lp: dict, cfg: EncoderConfig, experts):
    """One MoE layer: the dense trunk's attention, then the experts' output
    ``experts(h, idx, p, probs)`` on the routed LayerNorm output ``h``."""
    h = _layer_norm(x, lp["ln1_scale"], lp["ln1_bias"])
    x = x + _attention(h, mask, lp, cfg)
    h = _layer_norm(x, lp["ln2_scale"], lp["ln2_bias"])
    return x + experts(h, *_route(h, lp["router"]))


def _moe_epilogue(params: dict, x: torch.Tensor, mask: torch.Tensor):
    x = _layer_norm(x, params["final_ln_scale"], params["final_ln_bias"])
    return pool_project(params, *masked_pool_sums(x, mask)), x[:, 0, :].float()


def _unsharded(params: dict, token_ids: torch.Tensor, mask: torch.Tensor, cfg: EncoderConfig,
               n_experts: int, **kw):
    return ep_forward(params, token_ids, mask, cfg, n_experts,
                      one_shard(params["tok_emb"].device), **kw)


def moe_encode_tokens(params: dict, token_ids: torch.Tensor, mask: torch.Tensor,
                      cfg: EncoderConfig, n_experts: int):
    """The MoE forward: ``encode_tokens``' contract, (emb [B, out_dim] f32
    L2-normalized, cls [B, d_model] f32). It is ``ep_forward`` over one
    shard holding every expert."""
    return _unsharded(params, token_ids, mask, cfg, n_experts)


def moe_encode_tokens_with_aux(params: dict, token_ids: torch.Tensor, mask: torch.Tensor,
                               cfg: EncoderConfig, n_experts: int):
    """``moe_encode_tokens`` and the load-balancing aux loss averaged over
    layers (the training forward): (emb, cls, aux f32 scalar)."""
    emb, cls, counts, prob_sums = _unsharded(params, token_ids, mask, cfg, n_experts,
                                             with_stats=True)
    return emb, cls, switch_aux(counts, prob_sums, token_ids.numel(), n_experts)


def expert_shares(params: dict, token_ids: torch.Tensor, mask: torch.Tensor,
                  cfg: EncoderConfig, n_experts: int) -> np.ndarray:
    """The share of real tokens each expert receives, per layer: [L, E]
    (a diagnostic of the router's balance)."""
    routes: list = []
    with torch.no_grad():
        _unsharded(params, token_ids, mask, cfg, n_experts, routes=routes)
    live = mask.reshape(-1) > 0
    n = max(int(live.sum()), 1)
    return np.stack([(torch.bincount(idx.reshape(-1)[live], minlength=n_experts).float() / n)
                     .cpu().numpy() for idx in routes])


# ---------------------------------------------------------------------------
# expert parallelism over an ``ep`` mesh axis
# ---------------------------------------------------------------------------

EXPERT_LEAVES = frozenset({"ew1", "eb1", "ew2", "eb2"})


def moe_sharding_spec(params: dict, mesh, ep_axis: str = "ep") -> dict:
    """The spec of an ``init_moe_params`` tree: the expert stacks [L, E, ...]
    split the expert axis (dim 1) over ``ep_axis`` when E divides; the rest
    (routers too, so that routing is the same everywhere) replicated."""
    ep = int(mesh.shape[ep_axis])

    def walk(p):
        out = {}
        for k, v in p.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in EXPERT_LEAVES and v.dim() >= 2 and v.shape[1] % ep == 0:
                out[k] = (None, ep_axis) + (None,) * (v.dim() - 2)
            else:
                out[k] = (None,) * v.dim()
        return out

    return walk(params)


def shard_params_ep(params: dict, mesh, ep_axis: str = "ep"):
    """Place a MoE tree on ``mesh``: the expert stacks split over ``ep_axis``,
    everything else replicated (``parallel.placement.Placed``; on a group
    mesh this rank's shard)."""
    return Placement(mesh, moe_sharding_spec(params, mesh, ep_axis), ep_axis).place(params)


def _check_ep(n_experts: int, ep: int) -> int:
    if n_experts % ep:
        raise ValueError(f"{n_experts} experts do not split over ep = {ep}")
    return n_experts // ep


def _plain_copies(t: torch.Tensor, axis) -> list[torch.Tensor]:
    return [t.to(d) for d in axis.devices]


def ep_forward(params: dict, token_ids: torch.Tensor, mask: torch.Tensor, cfg: EncoderConfig,
               n_experts: int, axis, with_stats: bool = False, routes: list | None = None):
    """The MoE forward with the experts split over ``axis`` (a
    ``parallel.comm`` axis; ``params`` one replica's placed tree, or a
    plain tree over one shard): attention and the router on the replicated
    activations, each local shard's experts over all tokens, the parts
    reduced. Returns (emb, cls) on the axis' first device; ``with_stats``
    adds each layer's ``route_stats`` stacked ([L, E] each), the terms of
    the load-balancing loss; ``routes``, where given, collects each
    layer's expert choices [B, T]."""
    stats = []
    dt = cfg.dtype
    n_local = n_experts // axis.size

    def experts(lps):
        def run(h, idx, p, probs):
            if with_stats:
                stats.append(route_stats(idx, probs, n_experts))
            if routes is not None:
                routes.append(idx)
            return axis.reduce([
                _expert_ffn(hj, ij, pj, lpj, n_local, dt, e_base=j * n_local)
                for hj, ij, pj, lpj, j in zip(axis.copy(h), _plain_copies(idx, axis),
                                              axis.copy(p), lps, axis.ranks)])
        return run

    x = params["tok_emb"][token_ids.long()].to(dt)
    for lp, lps in tp_layer_views(params["layers"], cfg.n_layers):
        x = _moe_layer(x, mask, lp, cfg, experts(lps))
    emb, cls = _moe_epilogue(params, x, mask)
    if with_stats:
        return (emb, cls, torch.stack([c for c, _ in stats]), torch.stack([q for _, q in stats]))
    return emb, cls


def make_ep_encoder(cfg: EncoderConfig, mesh, n_experts: int, ep_axis: str = "ep"):
    """The expert-parallel forward over ``mesh``'s ``ep_axis`` (psum form,
    module docstring). Returns ``fn(params, token_ids, mask) -> (emb,
    cls)``, ``moe_encode_tokens``' contract, with ``params`` from
    ``shard_params_ep``; every rank of a group mesh returns the whole
    result."""
    placement = Placement(mesh, None, ep_axis)
    replica = placement.replicas[0]
    _check_ep(n_experts, placement.n)

    def fn(params, token_ids: torch.Tensor, mask: torch.Tensor):
        dev = replica.device
        return ep_forward(params[0], token_ids.to(dev), mask.to(dev), cfg, n_experts,
                          replica.axis)

    return fn


def _slots(dest: torch.Tensor, n: int, cap: int):
    """Each item's rank among the items of its destination (``dest`` [N]
    in 0..n-1): (slot clipped to cap - 1, keep = rank < cap as f32)."""
    oh = F.one_hot(dest, n).float()
    slot = (torch.cumsum(oh, 0) * oh).sum(1) - 1.0
    keep = (slot >= 0) & (slot < cap)
    return torch.clamp(slot, 0, cap - 1).long(), keep.float()


def _dispatch(hf: torch.Tensor, idx: torch.Tensor, n_local: int, ep: int, cap: int):
    """Hop 1's send buffers of one shard's tokens hf [N, D] f32 routed to
    experts idx [N]: ([ep, cap, D] activations, [ep, cap] expert ids + 1,
    0 marking an empty slot) and the (destination, slot, keep) of each."""
    dest = idx // n_local
    slot, kf = _slots(dest, ep, cap)
    send_x = torch.zeros((ep, cap, hf.shape[1]), dtype=torch.float32, device=hf.device)
    send_x = send_x.index_put((dest, slot), hf * kf[:, None], accumulate=True)
    send_e = torch.zeros((ep, cap), dtype=torch.float32, device=hf.device)
    send_e = send_e.index_put((dest, slot), ((idx % n_local).float() + 1.0) * kf, accumulate=True)
    return send_x, send_e, (dest, slot, kf)


def _block_experts(recv_x: torch.Tensor, recv_e: torch.Tensor, lp: dict, n_local: int,
                   cap_e: int, dt: torch.dtype) -> torch.Tensor:
    """One shard's arrivals [ep, cap, D] packed into per-expert blocks
    [n_local, cap_e, D] (hop 2; arrivals past cap_e dropped), one batched
    product per weight, and the outputs back in arrival order [ep, cap, D]
    f32 (zero for empty or dropped slots)."""
    ep, cap, d = recv_x.shape
    xin = recv_x.reshape(ep * cap, d)
    e_in = torch.round(recv_e.reshape(ep * cap))
    valid = e_in >= 0.5
    eids = torch.clamp(e_in - 1.0, 0, n_local - 1).long()
    oh = F.one_hot(eids, n_local).float() * valid[:, None].float()
    slot = (torch.cumsum(oh, 0) * oh).sum(1) - 1.0
    kef = (valid & (slot >= 0) & (slot < cap_e)).float()
    slot = torch.clamp(slot, 0, cap_e - 1).long()
    xbuf = torch.zeros((n_local, cap_e, d), dtype=torch.float32, device=xin.device)
    xbuf = xbuf.index_put((eids, slot), xin * kef[:, None], accumulate=True)
    hh = torch.einsum("ecd,edf->ecf", xbuf.to(dt), lp["ew1"].to(dt)) + lp["eb1"][:, None, :].to(dt)
    hh = F.gelu(hh, approximate="tanh")
    y = torch.einsum("ecf,efd->ecd", hh, lp["ew2"].to(dt)) + lp["eb2"][:, None, :].to(dt)
    return (y.float()[eids, slot] * kef[:, None]).reshape(ep, cap, d)


def make_ep_encoder_a2a(cfg: EncoderConfig, mesh, n_experts: int, ep_axis: str = "ep",
                        capacity_factor: float = 2.0, expert_capacity_factor: float = 2.0):
    """Expert parallelism with all-to-all token dispatch (module docstring):
    the batch splits over ``ep_axis`` (it must divide), shard s routes its
    rows' tokens; per (source, destination) at most ``ceil(tokens / ep ·
    capacity_factor)`` go, per local expert at most ``ceil(arrivals /
    n_local · expert_capacity_factor)`` are computed, as in JAX. Returns
    ``fn(params, token_ids, mask) -> (emb, cls)`` over the whole batch (on
    a group mesh every rank returns the whole result)."""
    placement = Placement(mesh, None, ep_axis)
    replica = placement.replicas[0]
    axis = replica.axis
    ep = placement.n
    n_local = _check_ep(n_experts, ep)
    dt = cfg.dtype

    def fn(params, token_ids: torch.Tensor, mask: torch.Tensor):
        b, t = token_ids.shape
        if b % ep:
            raise ValueError(f"batch {b} does not split over ep = {ep}")
        bl = b // ep
        n_tok = bl * t
        cap = max(int(np.ceil(n_tok / ep * capacity_factor)), 1)
        n_arr = ep * cap
        cap_e = min(n_arr, max(int(np.ceil(n_arr / n_local * expert_capacity_factor)), 1))
        dev = replica.device
        rows = torch.cat([torch.arange(j * bl, (j + 1) * bl) for j in axis.ranks]).to(
            token_ids.device)
        ids, msk = token_ids[rows].long().to(dev), mask[rows].to(dev)
        tree = params[0]

        def experts(lps):
            def run(h, idx, p, _probs):
                sends_x, sends_e, metas = [], [], []
                for i in range(len(axis.ranks)):
                    sl = slice(i * bl, (i + 1) * bl)
                    sx, se, meta = _dispatch(h[sl].reshape(n_tok, -1).float(),
                                             idx[sl].reshape(n_tok), n_local, ep, cap)
                    sends_x.append(sx)
                    sends_e.append(se)
                    metas.append(meta)
                recv_x, recv_e = axis.all_to_all(sends_x), axis.all_to_all(sends_e)
                backs = axis.all_to_all([_block_experts(rx, re_, lpj, n_local, cap_e, dt)
                                         for rx, re_, lpj in zip(recv_x, recv_e, lps)])
                outs = []
                for i, (back, (dest, slot, kf)) in enumerate(zip(backs, metas)):
                    pf = p[i * bl : (i + 1) * bl].reshape(n_tok).float()
                    out = back.to(dev)[dest, slot] * kf[:, None] * pf[:, None]
                    outs.append(out.reshape(bl, t, -1).to(dt))
                return torch.cat(outs)
            return run

        x = tree["tok_emb"][ids].to(dt)
        for lp, lps in tp_layer_views(tree["layers"], cfg.n_layers):
            x = _moe_layer(x, msk, lp, cfg, experts(lps))
        emb, cls = _moe_epilogue(tree, x, msk)
        return axis.gather([emb], 0), axis.gather([cls], 0)

    return fn
