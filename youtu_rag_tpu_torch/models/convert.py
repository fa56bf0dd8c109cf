"""Carry an encoder's or a decoder's parameters across as numpy arrays.

``encoder_params_from_numpy`` and ``decoder_params_from_numpy`` turn a
parameter tree of numpy arrays into the port's parameter dict on a device:
the JAX package's tree (``jax.tree.map(np.asarray, params)``), so that both
packages compute the same function, or the tree ``models/pretrained.py``
reads from a checkpoint. The port imports nothing of the JAX package: whoever holds JAX
parameters converts them to numpy on its side.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .decoder import DecoderConfig
from .encoder import EncoderConfig, _check_arch


# bert keys a tree may lack: the pooler and the score head (an embedding
# checkpoint has neither), the head's bias, and a projection after pooling
_BERT_OPTIONAL = ("pooler_w", "pooler_b", "score_head", "score_bias", "out_proj")


def _expected_shapes(cfg: EncoderConfig) -> dict[str, Any]:
    """The parameter tree's shapes for ``cfg`` (the JAX package's
    ``init_encoder_params`` layout, layers stacked on axis 0; None: any
    size, the bert position table's rows, at least ``max_len``)."""
    _check_arch(cfg)
    D, Fd, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size
    if cfg.arch == "bert":
        layer = {name: (L, D, D) for name in ("wq", "wk", "wv", "wo")}
        layer.update({name: (L, D) for name in ("bq", "bk", "bv", "bo", "ln1_scale", "ln1_bias",
                                                "b2", "ln2_scale", "ln2_bias")})
        layer.update(w1=(L, D, Fd), b1=(L, Fd), w2=(L, Fd, D))
        return {"tok_emb": (V, D), "pos_emb": (None, D), "type_emb": (cfg.type_vocab_size, D),
                "emb_ln_scale": (D,), "emb_ln_bias": (D,), "layers": layer,
                "pooler_w": (D, D), "pooler_b": (D,), "score_head": (D, 1), "score_bias": (1,),
                "out_proj": (D, cfg.out_dim)}
    shapes: dict[str, Any] = {"tok_emb": (V, D)}
    if cfg.lex_pool:
        shapes["tok_weight"] = (V,)
        shapes["lex_mix"] = ()
        if not cfg.lex_buckets:
            shapes["lex_proj"] = (D, cfg.out_dim)
    shapes["layers"] = {
        "ln1_scale": (L, D), "ln1_bias": (L, D),
        "wq": (L, D, D), "wk": (L, D, D), "wv": (L, D, D), "wo": (L, D, D),
        "ln2_scale": (L, D), "ln2_bias": (L, D),
        "w1": (L, D, Fd), "b1": (L, Fd), "w2": (L, Fd, D), "b2": (L, D),
    }
    shapes.update(final_ln_scale=(D,), final_ln_bias=(D,), out_proj=(D, cfg.out_dim),
                  score_head=(D, 1))
    return shapes


def encoder_params_from_numpy(tree: dict, cfg: EncoderConfig,
                              device: str | torch.device = "cpu") -> dict:
    """The port's f32 parameter dict on ``device`` from a nested dict of
    numpy arrays. Raises ``ValueError`` on a missing key or a shape that
    ``cfg`` does not give; keys ``cfg`` does not read are left out, and a
    bert tree may lack the optional keys (``_BERT_OPTIONAL``)."""
    optional = _BERT_OPTIONAL if cfg.arch == "bert" else ()

    def walk(want: dict, got: dict, path: str) -> dict:
        out = {}
        for key, shape in want.items():
            where = f"{path}{key}"
            if key not in got:
                if not path and key in optional:
                    continue
                raise ValueError(f"encoder parameters: {where} is missing")
            if isinstance(shape, dict):
                out[key] = walk(shape, got[key], f"{where}/")
                continue
            arr = np.asarray(got[key], dtype=np.float32)
            fits = arr.ndim == len(shape) and all(w is None or a == w
                                                  for a, w in zip(arr.shape, shape))
            if not fits or (key == "pos_emb" and arr.shape[0] < cfg.max_len):
                raise ValueError(f"encoder parameters: {where} has shape {arr.shape}, "
                                 f"the config gives {shape}")
            out[key] = torch.from_numpy(arr.copy()).to(device)
        return out

    return walk(_expected_shapes(cfg), tree, "")


def _decoder_shapes(cfg: DecoderConfig) -> dict[str, Any]:
    """The JAX package's ``init_decoder_params`` layout for ``cfg``."""
    D, Fd, L, V, KV = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size, cfg.kv_dim
    if cfg.arch == "gpt2":
        layers = {name: (L, D, D) for name in ("wq", "wk", "wv", "wo")}
        layers.update({name: (L, D) for name in ("ln1_scale", "ln1_bias", "bq", "bk", "bv",
                                                 "bo", "ln2_scale", "ln2_bias", "b2")})
        layers.update(w1=(L, D, Fd), b1=(L, Fd), w2=(L, Fd, D))
        shapes = {"tok_emb": (V, D), "pos_emb": (cfg.max_len, D), "layers": layers,
                  "final_ln_scale": (D,), "final_ln_bias": (D,)}
    elif cfg.arch == "llama":
        layers = {"ln1_scale": (L, D), "wq": (L, D, D), "wk": (L, D, KV), "wv": (L, D, KV),
                  "wo": (L, D, D), "ln2_scale": (L, D), "w_gate": (L, D, Fd), "w1": (L, D, Fd),
                  "w2": (L, Fd, D)}
        if cfg.qkv_bias:
            layers.update(bq=(L, D), bk=(L, KV), bv=(L, KV))
        shapes = {"tok_emb": (V, D), "layers": layers, "final_ln_scale": (D,)}
    else:
        raise ValueError(f"unknown decoder arch {cfg.arch!r} (gpt2 or llama)")
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (D, V)
    return shapes


def decoder_params_from_numpy(tree: dict, cfg: DecoderConfig,
                              device: str | torch.device = "cpu") -> dict:
    """The port's f32 decoder parameters on ``device`` from a nested dict of
    numpy arrays (the JAX package's tree, or ``load_pretrained_decoder``'s),
    with ``wq``, ``wk`` and ``wv`` fused into ``wqkv`` (``bq``, ``bk``,
    ``bv`` into ``bqkv``). Raises ``ValueError`` on a missing key or a
    shape ``cfg`` does not give (a gpt2 position table may hold more rows
    than ``max_len``); keys ``cfg`` does not read are left out."""
    def walk(want: dict, got: dict, path: str) -> dict:
        out = {}
        for key, shape in want.items():
            where = f"{path}{key}"
            if key not in got:
                raise ValueError(f"decoder parameters: {where} is missing")
            if isinstance(shape, dict):
                out[key] = walk(shape, got[key], f"{where}/")
                continue
            arr = np.asarray(got[key], dtype=np.float32)
            if key == "pos_emb" and arr.ndim == 2 and arr.shape[0] >= shape[0]:
                arr = arr[: shape[0]]
            if arr.shape != shape:
                raise ValueError(f"decoder parameters: {where} has shape {arr.shape}, "
                                 f"the config gives {shape}")
            out[key] = torch.from_numpy(np.array(arr, copy=True)).to(device)
        return out

    params = walk(_decoder_shapes(cfg), tree, "")
    layers = params["layers"]
    layers["wqkv"] = torch.cat([layers.pop(k) for k in ("wq", "wk", "wv")], dim=-1)
    if "bq" in layers:
        layers["bqkv"] = torch.cat([layers.pop(k) for k in ("bq", "bk", "bv")], dim=-1)
    return params


def params_to_device(tree: dict, device: torch.device) -> dict:
    """A parameter dict (tensors) as f32 on ``device``."""
    return {k: params_to_device(v, device) if isinstance(v, dict) else v.to(device, torch.float32)
            for k, v in tree.items()}
