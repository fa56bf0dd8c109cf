"""Pretrained-weight import for the encoder: a Hugging Face BERT-family
checkpoint directory → the stacked parameter tree of ``models/encoder.py``'s
``arch="bert"`` trunk, as numpy arrays.

The port's counterpart of ``youtu_rag_tpu/models/pretrained.py``: the
encoder half, and (below) the causal-LM loaders of ``models/decoder.py``:
GPT-2 (``GPT2LMHeadModel``, fused c_attn Conv1D weights) and the LLaMA
family (llama, mistral, qwen2: q/k/v biases, a tied or separate head), or
the repo's native ``decoder_params.npz`` + ``decoder_config.json``. The
encoder layout (HF ``BertModel``, optionally wrapped in a
``BertForSequenceClassification`` reranker):

  embeddings.{word,position,token_type}_embeddings.weight, embeddings.LayerNorm.*
  encoder.layer.N.attention.self.{query,key,value}.{weight,bias}
  encoder.layer.N.attention.output.dense.* + LayerNorm.*
  encoder.layer.N.intermediate.dense.* / output.dense.* + LayerNorm.*
  [pooler.dense.*]  [classifier.*]

Optional ``bert.`` / ``model.`` prefixes are stripped; ``nn.Linear``
weights ([out, in]) are transposed to the [in, out] layout and per-layer
tensors stacked on a leading L axis. ``models/convert.py`` carries either
tree onto the device.

The safetensors format is read here (an 8-byte little-endian header
length, a JSON header, then the raw bytes), F16 and BF16 widened exactly to
f32, so neither ``safetensors`` nor ``transformers`` is needed (the card's
machine need not have them); ``pytorch_model.bin`` loads with
``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path

import numpy as np
import torch

from ..utils.log import get_logger
from .wordpiece import WordPieceTokenizer

logger = get_logger("models.pretrained")

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def load_safetensors(path) -> dict[str, np.ndarray]:
    """Read one .safetensors file into numpy arrays: F16 and BF16 widened to
    f32 (numpy has no bf16), the other types as stored."""
    with open(path, "rb") as f:
        (n_header,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n_header))
        data = bytearray(f.read())
    out: dict[str, np.ndarray] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(meta["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {meta['dtype']!r}")
        shape = tuple(meta["shape"])
        begin, end = meta["data_offsets"]
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * dtype.itemsize or end > len(data):
            raise ValueError(f"{path}: tensor {name!r} spans bytes [{begin}, {end}), which do "
                             f"not hold {shape} {meta['dtype']}")
        if count == 0:
            t = torch.empty(shape, dtype=dtype)
        else:
            t = torch.frombuffer(data, dtype=dtype, count=count, offset=begin).reshape(shape)
        if dtype in (torch.float16, torch.bfloat16):
            t = t.float()
        out[name] = t.numpy().copy()
    return out


def _load_raw_weights(model_dir: Path) -> dict[str, np.ndarray]:
    st = model_dir / "model.safetensors"
    if st.exists():
        return load_safetensors(st)
    # sharded checkpoints: model.safetensors.index.json lists shard files
    idx = model_dir / "model.safetensors.index.json"
    if idx.exists():
        with open(idx, encoding="utf-8") as f:
            weight_map = json.load(f)["weight_map"]
        out: dict[str, np.ndarray] = {}
        for shard in sorted(set(weight_map.values())):
            out.update(load_safetensors(model_dir / shard))
        return out
    pt = model_dir / "pytorch_model.bin"
    if pt.exists():
        sd = torch.load(pt, map_location="cpu", weights_only=True)
        return {k: v.float().numpy() for k, v in sd.items()}
    raise FileNotFoundError(f"no model.safetensors / pytorch_model.bin under {model_dir}")


def _strip_prefix(raw: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Normalize key prefixes: 'bert.' / 'model.' wrappers drop away."""
    for prefix in ("bert.", "model.", ""):
        if any(k.startswith(prefix + "embeddings.word_embeddings") for k in raw):
            if not prefix:
                return raw
            return {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in raw.items()}
    raise ValueError(
        "unrecognized checkpoint layout: no embeddings.word_embeddings.weight "
        f"key (saw e.g. {sorted(raw)[:5]}); supported layouts are BERT-family "
        "BertModel trees, optionally under a 'bert.'/'model.' prefix"
    )


def convert_bert_params(raw: dict[str, np.ndarray]) -> dict:
    """HF BertModel state dict → the stacked parameter tree (numpy f32) that
    ``encoder.encode_tokens`` reads for ``arch="bert"``: per-layer weights
    stacked on axis 0, Linear weights transposed to [in, out]; the pooler
    and a 1- or 2-label classifier head when present."""
    raw = _strip_prefix(raw)

    def take(key: str) -> np.ndarray:
        if key not in raw:
            raise KeyError(f"checkpoint missing {key!r} — not a BERT-family layout?")
        return np.asarray(raw[key], np.float32)

    n_layers = 0
    while f"encoder.layer.{n_layers}.attention.self.query.weight" in raw:
        n_layers += 1
    if n_layers == 0:
        raise ValueError("checkpoint has no encoder.layer.N blocks")

    def stack(fmt: str, transpose: bool = False) -> np.ndarray:
        mats = [take(fmt.format(i)) for i in range(n_layers)]
        return np.stack([m.T for m in mats] if transpose else mats)

    pre = "encoder.layer.{}."
    layers = {
        "wq": stack(pre + "attention.self.query.weight", transpose=True),
        "bq": stack(pre + "attention.self.query.bias"),
        "wk": stack(pre + "attention.self.key.weight", transpose=True),
        "bk": stack(pre + "attention.self.key.bias"),
        "wv": stack(pre + "attention.self.value.weight", transpose=True),
        "bv": stack(pre + "attention.self.value.bias"),
        "wo": stack(pre + "attention.output.dense.weight", transpose=True),
        "bo": stack(pre + "attention.output.dense.bias"),
        "ln1_scale": stack(pre + "attention.output.LayerNorm.weight"),
        "ln1_bias": stack(pre + "attention.output.LayerNorm.bias"),
        "w1": stack(pre + "intermediate.dense.weight", transpose=True),
        "b1": stack(pre + "intermediate.dense.bias"),
        "w2": stack(pre + "output.dense.weight", transpose=True),
        "b2": stack(pre + "output.dense.bias"),
        "ln2_scale": stack(pre + "output.LayerNorm.weight"),
        "ln2_bias": stack(pre + "output.LayerNorm.bias"),
    }
    params: dict = {
        "tok_emb": take("embeddings.word_embeddings.weight"),
        "pos_emb": take("embeddings.position_embeddings.weight"),
        "type_emb": take("embeddings.token_type_embeddings.weight"),
        "emb_ln_scale": take("embeddings.LayerNorm.weight"),
        "emb_ln_bias": take("embeddings.LayerNorm.bias"),
        "layers": layers,
    }
    if "pooler.dense.weight" in raw:
        params["pooler_w"] = take("pooler.dense.weight").T
        params["pooler_b"] = take("pooler.dense.bias")
    if "classifier.weight" in raw:  # sequence-classification reranker head
        w = take("classifier.weight")  # [num_labels, D]
        if w.shape[0] == 1:
            params["score_head"] = w.T
            if "classifier.bias" in raw:
                params["score_bias"] = take("classifier.bias")[:1]
        elif w.shape[0] == 2:
            # binary relevance head: score = logit(relevant=1) − logit(0)
            # (taking label 0 alone would rank by the irrelevant logit)
            params["score_head"] = (w[1] - w[0]).reshape(-1, 1)
            if "classifier.bias" in raw:
                b = take("classifier.bias")
                params["score_bias"] = (b[1] - b[0]).reshape(1)
        else:
            raise ValueError(
                f"classifier has {w.shape[0]} labels — not a relevance "
                "reranker head (expected 1 or 2)"
            )
    return params


def _detect_pooling(model_dir: Path, default: str = "cls") -> str:
    """sentence-transformers checkpoints carry 1_Pooling/config.json."""
    pool_cfg = model_dir / "1_Pooling" / "config.json"
    if pool_cfg.exists():
        try:
            with open(pool_cfg, encoding="utf-8") as f:
                pc = json.load(f)
            if pc.get("pooling_mode_mean_tokens"):
                return "mean"
            if pc.get("pooling_mode_cls_token"):
                return "cls"
        except (OSError, ValueError):
            logger.warning("unreadable %s; using %s pooling", pool_cfg, default)
    return default


def load_pretrained_encoder(model_dir, pooling: str | None = None,
                            dtype: torch.dtype | None = None,
                            attention_impl: str | None = None, max_len: int | None = None):
    """Load a BERT-family checkpoint directory (config.json +
    model.safetensors or pytorch_model.bin + vocab.txt, the standard HF
    export of bge/gte/e5-style models).

    Returns (params, EncoderConfig, WordPieceTokenizer): params the numpy
    tree of ``convert_bert_params``; ``dtype`` defaults to bf16 and
    ``attention_impl`` to "xla", as in the JAX package."""
    from .encoder import EncoderConfig

    model_dir = Path(model_dir)
    with open(model_dir / "config.json", encoding="utf-8") as f:
        hf = json.load(f)
    params = convert_bert_params(_load_raw_weights(model_dir))

    hidden_act = hf.get("hidden_act", "gelu")
    if hidden_act not in ("gelu", "gelu_new", "gelu_pytorch_tanh"):
        raise ValueError(f"unsupported hidden_act {hidden_act!r} (need a GELU family)")
    max_pos = int(hf.get("max_position_embeddings", 512))
    cfg = EncoderConfig(
        arch="bert",
        vocab_size=int(hf["vocab_size"]),
        d_model=int(hf["hidden_size"]),
        n_layers=int(hf["num_hidden_layers"]),
        n_heads=int(hf["num_attention_heads"]),
        d_ff=int(hf["intermediate_size"]),
        max_len=min(max_len or max_pos, max_pos),
        out_dim=int(hf["hidden_size"]),
        dtype=dtype if dtype is not None else torch.bfloat16,
        ln_eps=float(hf.get("layer_norm_eps", 1e-12)),
        type_vocab_size=int(hf.get("type_vocab_size", 2)),
        gelu_approximate=hidden_act != "gelu",
        pooling=pooling or _detect_pooling(model_dir),
        attention_impl=attention_impl or "xla",
    )
    if params["tok_emb"].shape != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"word embeddings {params['tok_emb'].shape} do not match the config's "
                         f"vocab_size {cfg.vocab_size} x hidden_size {cfg.d_model}")

    lowercase = hf.get("do_lower_case")
    tok_cfg = model_dir / "tokenizer_config.json"
    if lowercase is None and tok_cfg.exists():
        try:
            with open(tok_cfg, encoding="utf-8") as f:
                lowercase = json.load(f).get("do_lower_case")
        except (OSError, ValueError):
            lowercase = None
    tokenizer = WordPieceTokenizer(
        model_dir / "vocab.txt",
        lowercase=True if lowercase is None else bool(lowercase),
        max_length=cfg.max_len,
    )
    if tokenizer.vocab_size > cfg.vocab_size:
        raise ValueError(
            f"vocab.txt has {tokenizer.vocab_size} ids but the embedding "
            f"matrix holds {cfg.vocab_size}"
        )
    logger.info(
        "loaded %s: L=%d D=%d heads=%d vocab=%d pooling=%s",
        os.path.basename(str(model_dir)), cfg.n_layers, cfg.d_model,
        cfg.n_heads, cfg.vocab_size, cfg.pooling,
    )
    return params, cfg, tokenizer


# ---------------------------------------------------------------------------
# causal-LM checkpoints (models/decoder.py)
# ---------------------------------------------------------------------------


def convert_gpt2_params(raw: dict[str, np.ndarray]) -> dict:
    """HF GPT2LMHeadModel state dict → the stacked decoder param tree.

    GPT-2 uses Conv1D modules storing weights [in, out] — already the
    einsum layout here, so NO transpose (unlike nn.Linear checkpoints).
    The fused c_attn [D, 3D] splits into wq/wk/wv."""
    raw = {
        (k[len("transformer."):] if k.startswith("transformer.") else k): v
        for k, v in raw.items()
    }

    def take(key: str) -> np.ndarray:
        if key not in raw:
            raise KeyError(f"checkpoint missing {key!r} — not a GPT-2 layout?")
        return np.asarray(raw[key], np.float32)

    n_layers = 0
    while f"h.{n_layers}.attn.c_attn.weight" in raw:
        n_layers += 1
    if n_layers == 0:
        raise ValueError("checkpoint has no h.N transformer blocks")

    def stack(fmt: str) -> np.ndarray:
        return np.stack([take(fmt.format(i)) for i in range(n_layers)])

    qkv_w = stack("h.{}.attn.c_attn.weight")  # [L, D, 3D]
    qkv_b = stack("h.{}.attn.c_attn.bias")  # [L, 3D]
    d = qkv_w.shape[1]
    layers = {
        "ln1_scale": stack("h.{}.ln_1.weight"),
        "ln1_bias": stack("h.{}.ln_1.bias"),
        "wq": qkv_w[:, :, :d], "bq": qkv_b[:, :d],
        "wk": qkv_w[:, :, d : 2 * d], "bk": qkv_b[:, d : 2 * d],
        "wv": qkv_w[:, :, 2 * d :], "bv": qkv_b[:, 2 * d :],
        "wo": stack("h.{}.attn.c_proj.weight"),
        "bo": stack("h.{}.attn.c_proj.bias"),
        "ln2_scale": stack("h.{}.ln_2.weight"),
        "ln2_bias": stack("h.{}.ln_2.bias"),
        "w1": stack("h.{}.mlp.c_fc.weight"),
        "b1": stack("h.{}.mlp.c_fc.bias"),
        "w2": stack("h.{}.mlp.c_proj.weight"),
        "b2": stack("h.{}.mlp.c_proj.bias"),
    }
    return {
        "tok_emb": take("wte.weight"),
        "pos_emb": take("wpe.weight"),
        "layers": layers,
        "final_ln_scale": take("ln_f.weight"),
        "final_ln_bias": take("ln_f.bias"),
    }


def convert_llama_params(raw: dict[str, np.ndarray], tie_embeddings: bool) -> dict:
    """HF LlamaForCausalLM-family state dict (llama/mistral/qwen2) → the
    stacked decoder tree. nn.Linear weights transpose to [in, out]."""
    raw = {
        (k[len("model."):] if k.startswith("model.") else k): v
        for k, v in raw.items()
    }

    def take(key: str) -> np.ndarray:
        if key not in raw:
            raise KeyError(f"checkpoint missing {key!r} — not a LLaMA layout?")
        return np.asarray(raw[key], np.float32)

    n_layers = 0
    while f"layers.{n_layers}.self_attn.q_proj.weight" in raw:
        n_layers += 1
    if n_layers == 0:
        raise ValueError("checkpoint has no layers.N transformer blocks")

    def stack(fmt: str, transpose: bool = True) -> np.ndarray:
        mats = [take(fmt.format(i)) for i in range(n_layers)]
        if transpose:
            mats = [m.T for m in mats]
        return np.stack(mats)

    layers = {
        "ln1_scale": stack("layers.{}.input_layernorm.weight", transpose=False),
        "wq": stack("layers.{}.self_attn.q_proj.weight"),
        "wk": stack("layers.{}.self_attn.k_proj.weight"),
        "wv": stack("layers.{}.self_attn.v_proj.weight"),
        "wo": stack("layers.{}.self_attn.o_proj.weight"),
        "ln2_scale": stack("layers.{}.post_attention_layernorm.weight", transpose=False),
        "w_gate": stack("layers.{}.mlp.gate_proj.weight"),
        "w1": stack("layers.{}.mlp.up_proj.weight"),
        "w2": stack("layers.{}.mlp.down_proj.weight"),
    }
    if "layers.0.self_attn.q_proj.bias" in raw:  # qwen2-style qkv biases
        layers["bq"] = stack("layers.{}.self_attn.q_proj.bias", transpose=False)
        layers["bk"] = stack("layers.{}.self_attn.k_proj.bias", transpose=False)
        layers["bv"] = stack("layers.{}.self_attn.v_proj.bias", transpose=False)
    params = {
        "tok_emb": take("embed_tokens.weight"),
        "layers": layers,
        "final_ln_scale": take("norm.weight"),
    }
    if not tie_embeddings:
        params["lm_head"] = take("lm_head.weight").T
    return params


def load_pretrained_decoder(model_dir, dtype: torch.dtype | None = None,
                            max_len: int | None = None):
    """Load a causal-LM checkpoint directory: (params, DecoderConfig),
    params the numpy tree (f32) that ``models.convert.decoder_params_from_numpy``
    carries onto a device.

    The repo's native form comes first (``decoder_params.npz`` +
    ``decoder_config.json``, as ``scripts/train_chat_lm.py`` writes it);
    else config.json + model.safetensors (or pytorch_model.bin, or a
    sharded index) of a gpt2, llama, mistral or qwen2 model. The tokenizer
    loads separately (``models/bpe.py`` reads tokenizer.json)."""
    from .decoder import DecoderConfig, _tree_map, load_decoder_config
    from .encoder import load_params_npz

    model_dir = Path(model_dir)
    native = model_dir / "decoder_params.npz"
    if native.exists():
        cfg = load_decoder_config(model_dir / "decoder_config.json")
        params = _tree_map(lambda t: t.float().numpy(), load_params_npz(native))
        logger.info("loaded native decoder %s: %s L=%d D=%d vocab=%d",
                    os.path.basename(str(model_dir)), cfg.arch, cfg.n_layers, cfg.d_model,
                    cfg.vocab_size)
        return params, cfg
    with open(model_dir / "config.json", encoding="utf-8") as f:
        hf = json.load(f)
    model_type = hf.get("model_type", "")
    raw = _load_raw_weights(model_dir)
    dtype = dtype if dtype is not None else torch.bfloat16
    if model_type == "gpt2":
        params = convert_gpt2_params(raw)
        max_pos = int(hf.get("n_positions", 1024))
        cfg = DecoderConfig(
            arch="gpt2",
            vocab_size=int(hf["vocab_size"]),
            d_model=int(hf["n_embd"]),
            n_layers=int(hf["n_layer"]),
            n_heads=int(hf["n_head"]),
            n_kv_heads=int(hf["n_head"]),
            d_ff=int(hf.get("n_inner") or 4 * hf["n_embd"]),
            max_len=min(max_len or max_pos, max_pos),
            dtype=dtype,
            ln_eps=float(hf.get("layer_norm_epsilon", 1e-5)),
            tie_embeddings=True,
            eos_token_id=int(hf.get("eos_token_id", 50256)),
            bos_token_id=hf.get("bos_token_id"),
        )
    elif model_type in ("llama", "mistral", "qwen2"):
        tie = bool(hf.get("tie_word_embeddings", False))
        params = convert_llama_params(raw, tie_embeddings=tie)
        n_heads = int(hf["num_attention_heads"])
        max_pos = int(hf.get("max_position_embeddings", 4096))
        cfg = DecoderConfig(
            arch="llama",
            vocab_size=int(hf["vocab_size"]),
            d_model=int(hf["hidden_size"]),
            n_layers=int(hf["num_hidden_layers"]),
            n_heads=n_heads,
            n_kv_heads=int(hf.get("num_key_value_heads", n_heads)),
            d_ff=int(hf["intermediate_size"]),
            max_len=min(max_len or max_pos, max_pos),
            dtype=dtype,
            rope_base=float(hf.get("rope_theta", 10000.0)),
            ln_eps=float(hf.get("rms_norm_eps", 1e-6)),
            tie_embeddings=tie,
            eos_token_id=int(hf.get("eos_token_id", 2)),
            bos_token_id=hf.get("bos_token_id"),
            qkv_bias="layers.0.self_attn.q_proj.bias" in {k.removeprefix("model."): None
                                                          for k in raw},
        )
    else:
        raise ValueError(f"unsupported model_type {model_type!r} (gpt2 / llama / mistral "
                         "/ qwen2 layouts are supported)")
    if params["tok_emb"].shape[0] != cfg.vocab_size:
        raise ValueError(f"embeddings {params['tok_emb'].shape} do not match vocab_size "
                         f"{cfg.vocab_size}")
    logger.info("loaded decoder %s: %s L=%d D=%d heads=%d/%d vocab=%d",
                os.path.basename(str(model_dir)), cfg.arch, cfg.n_layers, cfg.d_model,
                cfg.n_heads, cfg.n_kv_heads, cfg.vocab_size)
    return params, cfg
