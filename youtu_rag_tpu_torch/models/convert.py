"""Carry an encoder's parameters across as numpy arrays.

``encoder_params_from_numpy`` turns the JAX package's parameter tree,
given as numpy arrays (``jax.tree.map(np.asarray, params)``), into the
port's parameter dict, so that both packages compute the same function.
The port imports nothing of the JAX package: whoever holds JAX parameters
converts them to numpy on its side.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .encoder import EncoderConfig, _check_arch


def _expected_shapes(cfg: EncoderConfig) -> dict[str, Any]:
    """The parameter tree's shapes for ``cfg`` (the JAX package's
    ``init_encoder_params`` layout, layers stacked on axis 0)."""
    _check_arch(cfg)
    D, Fd, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size
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
    ``cfg`` does not give; keys ``cfg`` does not read are left out."""

    def walk(want: dict, got: dict, path: str) -> dict:
        out = {}
        for key, shape in want.items():
            where = f"{path}{key}"
            if key not in got:
                raise ValueError(f"encoder parameters: {where} is missing")
            if isinstance(shape, dict):
                out[key] = walk(shape, got[key], f"{where}/")
                continue
            arr = np.asarray(got[key], dtype=np.float32)
            if arr.shape != shape:
                raise ValueError(f"encoder parameters: {where} has shape {arr.shape}, "
                                 f"the config gives {shape}")
            out[key] = torch.from_numpy(arr.copy()).to(device)
        return out

    return walk(_expected_shapes(cfg), tree, "")
