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

The (dp, tp)-sharded step (``make_sharded_lm_train_step``) is not ported
yet (ROADMAP Queue A 8).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .decoder import DecoderConfig, causal_logits
from .train import ChainedAdamW, as_batch, value_and_grad
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
    labels = batch["tokens"][:, 1:].long()
    lmask = batch["loss_mask"][:, 1:].float()
    lg = logits[:, :-1]
    ce = F.cross_entropy(lg.reshape(-1, lg.shape[-1]), labels.reshape(-1), reduction="none",
                         label_smoothing=tc.label_smoothing).reshape(labels.shape)
    denom = torch.clamp_min(lmask.sum(), 1.0)
    return (ce * lmask).sum() / denom


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
