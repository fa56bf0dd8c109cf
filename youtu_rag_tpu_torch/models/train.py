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

The sharded steps over a (dp, tp) or (dp, ep) mesh
(``make_sharded_train_step``, ``make_sharded_moe_train_step``) are not
ported yet (ROADMAP Queue A 8).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from .encoder import EncoderConfig, encode_tokens


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


def leaves(tree: dict) -> list[torch.Tensor]:
    """A parameter tree's tensors in its key order (the order of
    ``value_and_grad``'s gradients)."""
    out = []
    for v in tree.values():
        out.extend(leaves(v) if isinstance(v, dict) else [v])
    return out


def leaf_names(tree: dict, prefix: str = "") -> list[str]:
    """The '/'-joined paths of ``leaves(tree)``."""
    out = []
    for k, v in tree.items():
        out.extend(leaf_names(v, f"{prefix}{k}/") if isinstance(v, dict) else [prefix + k])
    return out


def _zeros_like(tree: dict) -> dict:
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v, dtype=torch.float32)
            for k, v in tree.items()}


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
    def update(self, grads: dict | list, state: dict, params: dict):
        ps = leaves(params)
        gs = leaves(grads) if isinstance(grads, dict) else list(grads)
        mus, nus = leaves(state["mu"]), leaves(state["nu"])
        # clip_by_global_norm: keep g below max_norm, else (g / ||g||) * max_norm
        g_norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in gs))
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
