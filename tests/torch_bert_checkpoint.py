"""Write a BERT-family checkpoint directory in the standard Hugging Face
layout with numpy alone (no ``transformers``, ``safetensors`` or
``tokenizers``): config.json, model.safetensors (F32 or BF16), vocab.txt
and, for an embedder, 1_Pooling/config.json. The weights are drawn from a
seed as BERT initializes them (normal, std 0.02; LayerNorm 1 and 0; biases
small normals so that they matter). The tests use it where ``transformers``
must not be imported, and to check the port's reader against ``transformers``
on the same files."""

import json
import struct
from pathlib import Path

import numpy as np

VOCAB = (
    "[PAD] [UNK] [CLS] [SEP] [MASK] the quick brown fox jump ##s over lazy dog "
    "un ##want ##ed run ##ning hello world , . ! ? ' \" 中 国 人 a b c d e f "
    "##a ##b ##c 1 2 3 ##1 ##2 want"
).split()


def to_bf16_bits(a: np.ndarray) -> np.ndarray:
    """f32 → bf16 bit patterns (uint16), rounded to nearest even."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def write_safetensors(path, tensors: dict[str, np.ndarray], dtype: str = "F32") -> None:
    """The safetensors layout: an 8-byte little-endian header length, a JSON
    header (padded with spaces to 8 bytes), then each tensor's bytes."""
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        a = np.ascontiguousarray(tensors[name], np.float32)
        raw = (to_bf16_bits(a) if dtype == "BF16" else a).tobytes()
        header[name] = {"dtype": dtype, "shape": list(a.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    header["__metadata__"] = {"format": "pt"}
    h = json.dumps(header, separators=(",", ":")).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h + b"".join(blobs))


def bert_state(hidden: int, layers: int, inter: int, vocab: int, max_pos: int, seed: int,
               num_labels: int | None = None, type_vocab: int = 2) -> dict[str, np.ndarray]:
    """A seeded state dict with HF key names: BertModel's (with its pooler),
    or under ``bert.`` with ``classifier.*`` for a sequence classifier."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    sd = {"embeddings.word_embeddings.weight": w(vocab, hidden),
          "embeddings.position_embeddings.weight": w(max_pos, hidden),
          "embeddings.token_type_embeddings.weight": w(type_vocab, hidden),
          "embeddings.LayerNorm.weight": np.ones(hidden, np.float32),
          "embeddings.LayerNorm.bias": np.zeros(hidden, np.float32)}
    for i in range(layers):
        p = f"encoder.layer.{i}."
        for name, (o, n) in {"attention.self.query": (hidden, hidden),
                             "attention.self.key": (hidden, hidden),
                             "attention.self.value": (hidden, hidden),
                             "attention.output.dense": (hidden, hidden),
                             "intermediate.dense": (inter, hidden),
                             "output.dense": (hidden, inter)}.items():
            sd[p + name + ".weight"] = w(o, n)
            sd[p + name + ".bias"] = w(o)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[p + ln + ".weight"] = np.ones(hidden, np.float32)
            sd[p + ln + ".bias"] = np.zeros(hidden, np.float32)
    sd["pooler.dense.weight"] = w(hidden, hidden)
    sd["pooler.dense.bias"] = w(hidden)
    if num_labels is None:
        return sd
    sd = {"bert." + k: v for k, v in sd.items()}
    sd["classifier.weight"] = w(num_labels, hidden)
    sd["classifier.bias"] = w(num_labels)
    return sd


def write_bert_dir(d, hidden: int = 32, layers: int = 2, heads: int = 4, inter: int = 64,
                   max_pos: int = 64, seed: int = 0, num_labels: int | None = None,
                   pooling: str | None = None, dtype: str = "F32", vocab=VOCAB) -> Path:
    """A checkpoint directory ``d``: an embedder (``num_labels`` None) or a
    cross-encoder with a 1- or 2-label head."""
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    cfg = {"architectures": ["BertModel" if num_labels is None
                             else "BertForSequenceClassification"],
           "model_type": "bert", "vocab_size": len(vocab), "hidden_size": hidden,
           "num_hidden_layers": layers, "num_attention_heads": heads,
           "intermediate_size": inter, "max_position_embeddings": max_pos,
           "type_vocab_size": 2, "hidden_act": "gelu", "layer_norm_eps": 1e-12,
           "hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1,
           "initializer_range": 0.02, "pad_token_id": 0}
    if num_labels is not None:
        cfg["id2label"] = {str(i): f"LABEL_{i}" for i in range(num_labels)}
        cfg["label2id"] = {f"LABEL_{i}": i for i in range(num_labels)}
    (d / "config.json").write_text(json.dumps(cfg, indent=1))
    write_safetensors(d / "model.safetensors",
                      bert_state(hidden, layers, inter, len(vocab), max_pos, seed, num_labels),
                      dtype)
    (d / "vocab.txt").write_text("\n".join(vocab) + "\n", encoding="utf-8")
    if pooling is not None:
        (d / "1_Pooling").mkdir(exist_ok=True)
        (d / "1_Pooling" / "config.json").write_text(json.dumps(
            {"word_embedding_dimension": hidden, "pooling_mode_cls_token": pooling == "cls",
             "pooling_mode_mean_tokens": pooling == "mean"}))
    return d
