"""Contrastive (InfoNCE) training of the encoder trunk, in PyTorch.

The port's counterpart of ``youtu_rag_tpu/models/train.py``, on one
device. Bi-encoder InfoNCE with in-batch negatives:

    L = CE(Q @ D^T / tau, diag)  symmetrized

and its MoE form (``make_moe_train_step``: the same objective through the
expert-routed forward of ``parallel/expert_parallel.py`` plus the Switch
load-balancing term).

``make_optimizer`` is optax's ``chain(clip_by_global_norm(1.0),
adamw(warmup_cosine_decay_schedule(0, lr, warmup, total), weight_decay))``
step for step (``ChainedAdamW``): the schedule is read at the update count
*before* it is incremented, so the first update's learning rate is
schedule(0) = 0; the clip is ``g * (max_norm / ||g||)`` once ``||g|| >=
max_norm``, with no epsilon; Adam's moments are bias-corrected with the
incremented count; every leaf is decayed (no mask) by ``wd * p`` inside
the scheduled step. Parameters (the master weights) and the optimizer's
moments are f32; the forward casts to ``cfg.dtype`` at each use.

A step differentiates ``encode_tokens`` with plain attention: the
attention kernels have no backward and refuse a differentiable call, as
JAX refuses to differentiate a Pallas call, so training configs keep
``attention_impl="xla"``. ``TrainConfig.remat`` recomputes the encoder's
forward in the backward (``torch.utils.checkpoint``, JAX's
``jax.checkpoint`` around ``encode_tokens``).

The sharded steps (``make_sharded_train_step`` over a ("dp", "tp") mesh,
``make_sharded_moe_train_step`` over ("dp", "ep")) compute what JAX's GSPMD
steps compute: the single-device step's loss and update on the global
batch. The parameters and the moments are placed on the mesh
(``parallel.placement``; Megatron's split of ``param_sharding_spec``, the
experts over ep); each replica runs its rows of the batch
(``encode_tokens`` and ``expert_parallel.ep_forward`` over its axis), the InfoNCE logits
take every dp row's embeddings (all-gathered with a gradient: the
negatives are the global batch), the Switch loss takes its token shares
and mean probabilities over every row, each gradient is summed over the dp
rows and the clip reads the global norm of the whole tree.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..parallel.expert_parallel import (
    _check_ep,
    ep_forward,
    init_moe_params,
    moe_sharding_spec,
    switch_aux,
)
from ..parallel.placement import Placement, resolve_spec
from .encoder import (
    EncoderConfig,
    check_tp_split,
    encode_tokens,
    init_encoder_params,
    param_sharding_spec,
)


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    warmup_steps: int = 100
    total_steps: int = 10_000
    temperature: float = 0.05
    remat: bool = True


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0):
    """optax's ``warmup_cosine_decay_schedule``: a linear ramp from
    ``init_value`` to ``peak_value`` over ``warmup_steps`` counts, then a
    cosine decay to ``end_value`` at ``decay_steps``. Returns count -> f32
    learning rate (a Python float)."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"the cosine decay needs decay_steps > warmup_steps, got "
                         f"{decay_steps} and {warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = float(decay_steps - warmup_steps)

    def schedule(count: int) -> float:
        if count < warmup_steps:  # polynomial_schedule, power 1
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            value = (init_value - peak_value) * frac + peak_value
        else:
            c = min(float(count - warmup_steps), cos_steps)
            decayed = (1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / cos_steps)) + alpha
            value = peak_value * decayed
        return float(np.float32(value))

    return schedule


def leaves(tree) -> list[torch.Tensor]:
    """A parameter tree's tensors in its key order (the order of
    ``value_and_grad``'s gradients); lists (a placed tree's replicas and
    shards, ``parallel.placement``) in their order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    out = []
    for v in (tree.values() if isinstance(tree, dict) else tree):
        out.extend(leaves(v))
    return out


def leaf_names(tree: dict, prefix: str = "") -> list[str]:
    """The '/'-joined paths of ``leaves(tree)``."""
    out = []
    for k, v in tree.items():
        out.extend(leaf_names(v, f"{prefix}{k}/") if isinstance(v, dict) else [prefix + k])
    return out


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    return torch.zeros_like(tree, dtype=torch.float32)


class ChainedAdamW:
    """optax's ``chain(clip_by_global_norm(max_norm), adamw(schedule,
    b1, b2, eps, weight_decay))`` over a parameter dict, functional as optax
    is: ``init(params)`` gives the state (``count``, a CPU int64 tensor, and
    the f32 moments ``mu`` and ``nu`` shaped like the parameters);
    ``update(grads, state, params)`` applies one step to the parameters in
    place (under ``no_grad``) and advances the state in place. Returns the
    parameters and the state. The learning rate is computed on the host
    from ``count``, so a step reads nothing back from the device."""

    def __init__(self, schedule, weight_decay: float, max_norm: float = 1.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.max_norm = max_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: dict) -> dict:
        return {"count": torch.zeros((), dtype=torch.int64), "mu": _zeros_like(params),
                "nu": _zeros_like(params)}

    @torch.no_grad()
    def update(self, grads: dict | list, state: dict, params, norm_sq: torch.Tensor | None = None):
        """``norm_sq``: the gradients' global squared norm where the leaves
        are not the whole tree (a placed tree's shards and replicas:
        ``Placement.grad_norm_sq``); by default the sum over ``grads``."""
        ps = leaves(params)
        gs = leaves(grads) if isinstance(grads, dict) else list(grads)
        mus, nus = leaves(state["mu"]), leaves(state["nu"])
        # clip_by_global_norm: keep g below max_norm, else (g / ||g||) * max_norm
        if norm_sq is None:
            norm_sq = sum(torch.sum(g.float() ** 2) for g in gs)
        g_norm = torch.sqrt(norm_sq)
        keep = g_norm < self.max_norm
        gs = [torch.where(keep, g, (g / g_norm) * self.max_norm) for g in gs]
        count = int(state["count"])
        lr = np.float32(self.schedule(count))  # scale_by_schedule: the count before the step
        n = np.float32(count + 1)
        bc1 = float(np.float32(1) - np.float32(self.b1) ** n)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** n)
        for p, g, mu, nu in zip(ps, gs, mus, nus):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.weight_decay * p
            p.add_(float(-lr) * u)
        state["count"].fill_(count + 1)
        return params, state


def make_optimizer(tc) -> ChainedAdamW:
    """The JAX trainers' optimizer for a ``TrainConfig`` or an
    ``LMTrainConfig``."""
    return ChainedAdamW(
        warmup_cosine_decay_schedule(0.0, tc.learning_rate, tc.warmup_steps, tc.total_steps),
        weight_decay=tc.weight_decay,
    )


def as_batch(batch: dict, device: torch.device) -> dict:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))).to(device)
            for k, v in batch.items()}


def _contrastive(q_emb: torch.Tensor, d_emb: torch.Tensor, temperature: float):
    logits = (q_emb @ d_emb.T) / temperature  # [B, B]
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss = 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))
    acc = (torch.argmax(logits, dim=1) == labels).float().mean()
    return loss, acc


def _maybe_remat(fn, remat: bool):
    if not remat:
        return fn
    return lambda *a: torch.utils.checkpoint.checkpoint(fn, *a, use_reentrant=False)


def _pad_to(x: torch.Tensor, t: int) -> torch.Tensor:
    return F.pad(x, (0, t - x.shape[1]))


def info_nce_loss(params: dict, batch: dict, cfg: EncoderConfig, tc: TrainConfig):
    """batch: q_ids/q_mask/d_ids/d_mask, each [B, T], on the parameters'
    device. Returns (loss, metrics). Both sides go through one forward,
    the shorter padded to the longer with mask 0: a masked key has zero
    attention weight and a masked row zero pooling weight, so each row's
    embedding is the one of its own forward."""
    enc = _maybe_remat(encode_tokens, tc.remat)
    b = batch["q_ids"].shape[0]
    t = max(batch["q_ids"].shape[1], batch["d_ids"].shape[1])
    emb, _ = enc(params,
                 torch.cat([_pad_to(batch["q_ids"], t), _pad_to(batch["d_ids"], t)]),
                 torch.cat([_pad_to(batch["q_mask"], t), _pad_to(batch["d_mask"], t)]), cfg)
    q_emb, d_emb = emb[:b], emb[b:]  # [B, E] each
    loss, acc = _contrastive(q_emb, d_emb, tc.temperature)
    return loss, {"loss": loss.detach(), "accuracy": acc}


def value_and_grad(loss_fn, params: dict, *args):
    """``jax.value_and_grad(loss_fn, has_aux=True)``: ((loss, aux), grads),
    the gradients as a list in ``leaves(params)`` order. The parameters
    become leaves that require grad."""
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    with torch.enable_grad():
        loss, aux = loss_fn(params, *args)
        grads = torch.autograd.grad(loss, ps, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(ps, grads)]
    return (loss.detach(), aux), grads


def make_train_step(cfg: EncoderConfig, tc: TrainConfig, optimizer: ChainedAdamW):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: one InfoNCE step on the parameters' device (updated in
    place)."""
    def train_step(params, opt_state, batch):
        device = params["tok_emb"].device
        (_, metrics), grads = value_and_grad(info_nce_loss, params, as_batch(batch, device),
                                             cfg, tc)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, metrics

    return train_step


# ------------------------------------------------------------------- MoE
#
# The same InfoNCE objective through the MoE forward, plus the Switch
# load-balancing aux loss in the objective (top-1 argmax routing gives
# unselected experts zero gradient: without the aux term the router
# collapses onto one expert).


@dataclass(frozen=True)
class MoETrainConfig(TrainConfig):
    n_experts: int = 8
    aux_loss_weight: float = 1e-2


def moe_info_nce_loss(params: dict, batch: dict, cfg: EncoderConfig, tc: MoETrainConfig):
    from ..parallel.expert_parallel import moe_encode_tokens_with_aux

    def fwd(p, ids, mask):
        return moe_encode_tokens_with_aux(p, ids, mask, cfg, tc.n_experts)

    enc = _maybe_remat(fwd, tc.remat)
    q_emb, _, q_aux = enc(params, batch["q_ids"], batch["q_mask"])
    d_emb, _, d_aux = enc(params, batch["d_ids"], batch["d_mask"])
    contrastive, acc = _contrastive(q_emb, d_emb, tc.temperature)
    aux = 0.5 * (q_aux + d_aux)
    loss = contrastive + tc.aux_loss_weight * aux
    return loss, {"loss": loss.detach(), "contrastive_loss": contrastive.detach(),
                  "aux_loss": aux.detach(), "accuracy": acc}


def make_moe_train_step(cfg: EncoderConfig, tc: MoETrainConfig, optimizer: ChainedAdamW):
    def train_step(params, opt_state, batch):
        device = params["tok_emb"].device
        (_, metrics), grads = value_and_grad(moe_info_nce_loss, params,
                                             as_batch(batch, device), cfg, tc)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, metrics

    return train_step


# ------------------------------------------------------------- sharded steps


def sharding_spec_for(params: dict, cfg: EncoderConfig, mesh) -> dict:
    """``param_sharding_spec`` shaped exactly like ``params``: leaves it does
    not know (a pretrained import's pooler and score bias) and leaves whose
    split dimension the mesh does not divide (an arbitrary vocabulary over
    tp) replicate."""
    return resolve_spec(params, param_sharding_spec(cfg), mesh.shape)


def _rows(batch: dict, placement: Placement, replica) -> dict:
    rows = placement.batch_rows(replica, batch["q_ids"].shape[0])
    return {k: v[rows].to(replica.device) for k, v in batch.items()}


def _sharded_step(placement: Placement, optimizer: ChainedAdamW, loss_fn):
    """``step(placed, opt_state, batch)``: the global loss (``loss_fn``), its
    gradients summed over the dp rows, the clip's global norm over the
    placed tree, and one update of every replica. ``step.grads(placed,
    batch)`` gives (metrics, the full tree of the gradients the step
    applies) without the update: Adam's step is blind to a gradient's scale
    (a first update is ~lr · sign(g)), so checks hold the gradients."""
    def grads_of(placed, batch):
        batch = as_batch(batch, placement.replicas[0].device)
        (_, metrics), grads = value_and_grad(loss_fn, placed, batch)
        return metrics, placement.sync_grads(grads)

    def step(placed, opt_state, batch):
        metrics, grads = grads_of(placed, batch)
        placed, opt_state = optimizer.update(grads, opt_state, placed,
                                             norm_sq=placement.grad_norm_sq(grads, placed))
        return placed, opt_state, metrics

    def full_grads(placed, batch):
        metrics, grads = grads_of(placed, batch)
        return metrics, placement.gather_flat(placed, grads)

    step.grads = full_grads
    return step


def make_sharded_train_step(cfg: EncoderConfig, tc: TrainConfig, mesh, seed: int = 0,
                            init_params: dict | None = None):
    """The InfoNCE step over a ("dp", "tp") ``parallel.mesh`` mesh. Returns
    (params, opt_state, step_fn): the parameters (``init_params``, the
    fine-tune path, or seeded from ``seed``) placed per
    ``sharding_spec_for`` (a ``parallel.placement.Placed``; ``.gather()``
    gives the full tree), the optimizer state placed alike, and
    ``step_fn(params, opt_state, batch) -> (params, opt_state, metrics)``
    over the global batch (every rank passes the whole batch; each dp row
    takes its slice). Heads and FFN width must divide by tp."""
    check_tp_split(cfg, mesh.shape.get("tp", 1))
    optimizer = make_optimizer(tc)
    if init_params is None:
        init_params = init_encoder_params(cfg, torch.Generator().manual_seed(seed))
    placement = Placement(mesh, sharding_spec_for(init_params, cfg, mesh), "tp")
    params = placement.place(init_params)

    def loss_fn(placed, batch):
        qs, ds = [], []
        for r, tree in zip(placement.replicas, placed):
            sub = _rows(batch, placement, r)
            b = sub["q_ids"].shape[0]
            t = max(sub["q_ids"].shape[1], sub["d_ids"].shape[1])
            emb, _ = encode_tokens(
                tree, torch.cat([_pad_to(sub["q_ids"], t), _pad_to(sub["d_ids"], t)]),
                torch.cat([_pad_to(sub["q_mask"], t), _pad_to(sub["d_mask"], t)]), cfg,
                axis=r.axis, remat=tc.remat)
            qs.append(emb[:b])
            ds.append(emb[b:])
        loss, acc = _contrastive(placement.gather_dp(qs), placement.gather_dp(ds),
                                 tc.temperature)
        return loss, {"loss": loss.detach(), "accuracy": acc}

    return params, optimizer.init(params), _sharded_step(placement, optimizer, loss_fn)


def make_sharded_moe_train_step(cfg: EncoderConfig, tc: MoETrainConfig, mesh, seed: int = 0,
                                init_params: dict | None = None, ep_axis: str = "ep"):
    """The MoE InfoNCE step over a ("dp", ``ep_axis``) mesh: the experts split
    over ep (``moe_sharding_spec``), routers and the dense trunk
    replicated, the batch over dp. Returns (params, opt_state, step_fn) as
    ``make_sharded_train_step`` does; ``n_experts`` must divide by ep."""
    _check_ep(tc.n_experts, mesh.shape.get(ep_axis, 1))
    optimizer = make_optimizer(tc)
    if init_params is None:
        init_params = init_moe_params(cfg, tc.n_experts, torch.Generator().manual_seed(seed))
    placement = Placement(mesh, moe_sharding_spec(init_params, mesh, ep_axis), ep_axis)
    params = placement.place(init_params)
    n_e = tc.n_experts

    def side(placed, batch, ids_key, mask_key):
        """One side's embeddings over every dp row and its Switch loss."""
        embs, counts, prob_sums = [], [], []
        for r, tree in zip(placement.replicas, placed):
            sub = _rows(batch, placement, r)
            fwd = _maybe_remat(lambda p, i, m, ax=r.axis: ep_forward(p, i, m, cfg, n_e, ax, True),
                               tc.remat)
            emb, _, c, q = fwd(tree, sub[ids_key], sub[mask_key])
            embs.append(emb)
            counts.append(c)
            prob_sums.append(q)
        # [L, E] each, over every dp row
        aux = switch_aux(placement.sum_dp(counts), placement.reduce_dp(prob_sums),
                         batch[ids_key].numel(), n_e)
        return placement.gather_dp(embs), aux

    def loss_fn(placed, batch):
        q_emb, q_aux = side(placed, batch, "q_ids", "q_mask")
        d_emb, d_aux = side(placed, batch, "d_ids", "d_mask")
        contrastive, acc = _contrastive(q_emb, d_emb, tc.temperature)
        aux = 0.5 * (q_aux + d_aux)
        loss = contrastive + tc.aux_loss_weight * aux
        return loss, {"loss": loss.detach(), "contrastive_loss": contrastive.detach(),
                      "aux_loss": aux.detach(), "accuracy": acc}

    return params, optimizer.init(params), _sharded_step(placement, optimizer, loss_fn)
