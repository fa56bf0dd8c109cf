"""Causal-LM training: masked next-token cross-entropy for the decoder.

The port's counterpart of ``youtu_rag_tpu/models/train_lm.py``, on one
device: a batch is {tokens [B, T], mask [B, T], loss_mask [B, T]} with
static shapes (samples packed and padded on the host, ``pack_batch``);
the loss counts only completion tokens (``loss_mask``), so the prompt
conditions but is not predicted. The optimizer is the encoder trainer's
(``models.train.make_optimizer``: optax's clipped adamw with a warmup
cosine schedule, step for step), over f32 master weights;
``cast_params_for_serving`` casts for serving.

The port's decoder keeps q, k and v's weights fused as ``wqkv``; the
optimizer is elementwise and the clip reads the global norm, so training
the fused tensor is training JAX's three. ``split_qkv`` gives the JAX
layout back for the shared ``decoder_params.npz``.

``make_sharded_lm_train_step`` is the (dp, tp)-sharded step: the
parameters Megatron-split as ``decoder_sharding_spec`` says (the decoder's
own TP slicing, ``tp_part``), the batch over dp. Its loss is the
single-device one over the global batch: the completion tokens' summed
cross-entropy and their count each add up over every dp row before the
divide, so dp rows with different completion counts weigh as one batch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.placement import Placement, resolve_spec
from .decoder import (
    DecoderConfig,
    causal_logits,
    check_tp,
    decoder_sharding_spec,
    tp_causal_logits,
    tp_join,
    tp_part,
)
from .train import ChainedAdamW, _sharded_step, as_batch, value_and_grad
from .train import make_optimizer as _make_optimizer


@dataclass(frozen=True)
class LMTrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    warmup_steps: int = 100
    total_steps: int = 3000
    label_smoothing: float = 0.0
    remat: bool = True


def make_lm_optimizer(tc: LMTrainConfig) -> ChainedAdamW:
    return _make_optimizer(tc)


def lm_loss(params: dict, batch: dict, cfg: DecoderConfig, tc: LMTrainConfig) -> torch.Tensor:
    """Masked next-token CE: positions whose *label* is a completion token
    contribute. With ``label_smoothing`` the target is optax's
    ``smooth_labels`` (``(1 - a) * onehot + a / V``), which is
    ``F.cross_entropy``'s ``label_smoothing=a``."""
    logits = causal_logits(params, batch["tokens"], batch["mask"], cfg, remat=tc.remat)
    num, den = _masked_ce(logits, batch, tc)
    return num / torch.clamp_min(den, 1.0)


def make_lm_train_step(cfg: DecoderConfig, tc: LMTrainConfig, optimizer: ChainedAdamW):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss"})``: one step on the parameters' device (updated in place)."""
    def loss_fn(params, batch):
        loss = lm_loss(params, batch, cfg, tc)
        return loss, None

    def train_step(params, opt_state, batch):
        device = params["tok_emb"].device
        (loss, _), grads = value_and_grad(loss_fn, params, as_batch(batch, device))
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss}

    return train_step


def _masked_ce(logits: torch.Tensor, batch: dict, tc: LMTrainConfig):
    """(summed cross-entropy of the completion tokens, their count)."""
    labels = batch["tokens"][:, 1:].long()
    lmask = batch["loss_mask"][:, 1:].float()
    lg = logits[:, :-1]
    ce = F.cross_entropy(lg.reshape(-1, lg.shape[-1]), labels.reshape(-1), reduction="none",
                         label_smoothing=tc.label_smoothing).reshape(labels.shape)
    return (ce * lmask).sum(), lmask.sum()


def make_sharded_lm_train_step(cfg: DecoderConfig, tc: LMTrainConfig, optimizer: ChainedAdamW,
                               mesh, params: dict):
    """The (dp, tp)-sharded step on a ``parallel.mesh`` mesh. Returns
    (train_step, place_params, place_batch), as JAX's: ``place_params``
    places a full tree (a ``parallel.placement.Placed``; ``optimizer.init``
    of it is the placed state, ``.gather()`` the full tree), ``place_batch``
    puts a batch on the mesh's first device (every rank passes the whole
    batch; each dp row takes its slice), ``train_step(params, opt_state,
    batch) -> (params, opt_state, {"loss"})``. Leaves whose split dimension
    tp does not divide replicate; heads, kv heads and the FFN width must
    divide."""
    check_tp(cfg, mesh.shape.get("tp", 1))
    spec = resolve_spec(params, decoder_sharding_spec(cfg), mesh.shape)
    placement = Placement(mesh, spec, "tp",
                          slicer=lambda name, t, rank, n, dim: tp_part(name, t, rank, n, dim, cfg),
                          joiner=lambda name, parts, dim: tp_join(name, parts, dim, cfg))

    def place_batch(batch: dict) -> dict:
        batch = as_batch(batch, placement.replicas[0].device)
        placement.batch_rows(placement.replicas[0], batch["tokens"].shape[0])  # dp divides
        return batch

    def loss_fn(placed, batch):
        nums, dens = [], []
        for r, tree in zip(placement.replicas, placed):
            rows = placement.batch_rows(r, batch["tokens"].shape[0])
            sub = {k: v[rows].to(r.device) for k, v in batch.items()}
            logits = tp_causal_logits(tree, sub["tokens"], sub["mask"], cfg, r.axis, tc.remat)
            num, den = _masked_ce(logits, sub, tc)
            nums.append(num)
            dens.append(den)
        loss = placement.reduce_dp(nums) / torch.clamp_min(placement.sum_dp(dens), 1.0)
        return loss, {"loss": loss.detach()}

    return _sharded_step(placement, optimizer, loss_fn), placement.place, place_batch


def split_qkv(params: dict, cfg: DecoderConfig) -> dict:
    """The JAX layout of a decoder tree (``wq``, ``wk``, ``wv`` and their
    biases apart), for ``save_params_npz``; tensors detached."""
    out = {k: v.detach() for k, v in params.items() if k != "layers"}
    layers = {k: v.detach() for k, v in params["layers"].items() if k not in ("wqkv", "bqkv")}
    d, kv = cfg.d_model, cfg.kv_dim
    for fused, names in (("wqkv", ("wq", "wk", "wv")), ("bqkv", ("bq", "bk", "bv"))):
        if fused in params["layers"]:
            for name, part in zip(names, torch.split(params["layers"][fused].detach(),
                                                     [d, kv, kv], dim=-1)):
                layers[name] = part.contiguous()
    out["layers"] = layers
    return out


# ------------------------------------------------------------- host batching


def encode_samples(
    samples: list[tuple[str, str]],
    tokenizer,
    max_len: int,
    eos_id: int,
) -> list[tuple[np.ndarray, int]]:
    """(prompt, completion) → (token ids incl. trailing eos, prompt_len).
    Samples longer than ``max_len`` drop the FRONT of the prompt (the
    system block repeats across samples; the tail holds the question)."""
    out = []
    for prompt, completion in samples:
        p = tokenizer.encode(prompt)
        c = tokenizer.encode(completion) + [eos_id]
        if len(p) + len(c) > max_len:
            p = p[-(max_len - len(c)):]
        out.append((np.asarray(p + c, np.int32), len(p)))
    return out


def pack_batch(
    encoded: list[tuple[np.ndarray, int]], max_len: int, pad_id: int
) -> dict[str, np.ndarray]:
    """Right-pad to [B, max_len] with attention + completion loss masks."""
    b = len(encoded)
    tokens = np.full((b, max_len), pad_id, np.int32)
    mask = np.zeros((b, max_len), np.float32)
    loss_mask = np.zeros((b, max_len), np.float32)
    for i, (ids, p_len) in enumerate(encoded):
        n = min(len(ids), max_len)
        tokens[i, :n] = ids[:n]
        mask[i, :n] = 1.0
        loss_mask[i, p_len:n] = 1.0
    return {"tokens": tokens, "mask": mask, "loss_mask": loss_mask}
