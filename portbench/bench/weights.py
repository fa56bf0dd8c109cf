"""BERT checkpoints from the seed, in the Hugging Face layout the program's
``from_pretrained`` reads: ``config.json``, ``model.safetensors`` (BF16),
``vocab.txt`` and, for a CLS-pooled embedder, ``1_Pooling/config.json``.

Every weight and bias is drawn N(0, 0.02^2) (the checkpoints'
``initializer_range``), every LayerNorm is 1 and 0. The tensors lie in one
flat bf16 buffer made on the device by one generator call, in the order of
the file, so the file is its header and that buffer's bytes, and the plain
reference reads the same buffer (``state``)."""

from __future__ import annotations

import json
import os
import struct

import torch


def layout(hf: dict, head: bool) -> list[tuple[str, tuple[int, ...], str]]:
    """(name, shape, init) of every tensor, init "normal", "one" or "zero";
    ``head``: a one-label ``BertForSequenceClassification`` (names under
    ``bert.``), else a ``BertModel``."""
    d, inter = int(hf["hidden_size"]), int(hf["intermediate_size"])
    pre = "bert." if head else ""
    out = [(pre + "embeddings.word_embeddings.weight", (int(hf["vocab_size"]), d), "normal"),
           (pre + "embeddings.position_embeddings.weight",
            (int(hf["max_position_embeddings"]), d), "normal"),
           (pre + "embeddings.token_type_embeddings.weight", (int(hf["type_vocab_size"]), d),
            "normal")]

    def ln(name):
        out.extend([(name + ".weight", (d,), "one"), (name + ".bias", (d,), "zero")])

    def lin(name, o, i):
        out.extend([(name + ".weight", (o, i), "normal"), (name + ".bias", (o,), "normal")])

    ln(pre + "embeddings.LayerNorm")
    for i in range(int(hf["num_hidden_layers"])):
        p = f"{pre}encoder.layer.{i}."
        for name in ("attention.self.query", "attention.self.key", "attention.self.value",
                     "attention.output.dense"):
            lin(p + name, d, d)
        ln(p + "attention.output.LayerNorm")
        lin(p + "intermediate.dense", inter, d)
        lin(p + "output.dense", d, inter)
        ln(p + "output.LayerNorm")
    lin(pre + "pooler.dense", d, d)
    if head:
        lin("classifier", 1, d)
    return out


def make(hf: dict, head: bool, seed: int, device, std: float = 0.02) -> tuple[torch.Tensor, list]:
    """(flat bf16 buffer on ``device``, layout) of one checkpoint."""
    lay = layout(hf, head)
    total = sum(_numel(s) for _, s, _ in lay)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    flat = torch.empty(total, dtype=torch.bfloat16, device=device)
    flat.normal_(0.0, std, generator=g)
    off = 0
    for _, shape, init in lay:
        n = _numel(shape)
        if init != "normal":
            flat[off:off + n] = 1.0 if init == "one" else 0.0
        off += n
    return flat, lay


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def state(flat: torch.Tensor, lay: list) -> dict[str, torch.Tensor]:
    """Views of ``flat`` by name (the checkpoint's state dict)."""
    out, off = {}, 0
    for name, shape, _ in lay:
        n = _numel(shape)
        out[name] = flat[off:off + n].view(shape)
        off += n
    return out


def write(directory: str, hf: dict, flat: torch.Tensor, lay: list, vocab: list[str],
          head: bool, pooling: str = "cls") -> None:
    """The checkpoint directory (see the module's docstring)."""
    os.makedirs(directory, exist_ok=True)
    cfg = dict(hf)
    if head:
        cfg.update(architectures=["BertForSequenceClassification"], id2label={"0": "LABEL_0"},
                   label2id={"LABEL_0": 0})
    else:
        cfg.update(architectures=["BertModel"])
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1)
    header, off = {}, 0
    for name, shape, _ in lay:
        nbytes = 2 * _numel(shape)
        header[name] = {"dtype": "BF16", "shape": list(shape), "data_offsets": [off, off + nbytes]}
        off += nbytes
    h = json.dumps(header, separators=(",", ":")).encode()
    h += b" " * (-len(h) % 8)
    with open(os.path.join(directory, "model.safetensors"), "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h)
        f.write(flat.view(torch.int16).cpu().numpy().tobytes())
    with open(os.path.join(directory, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    if not head:
        os.makedirs(os.path.join(directory, "1_Pooling"), exist_ok=True)
        with open(os.path.join(directory, "1_Pooling", "config.json"), "w") as f:
            json.dump({"word_embedding_dimension": int(hf["hidden_size"]),
                       "pooling_mode_cls_token": pooling == "cls",
                       "pooling_mode_mean_tokens": pooling == "mean"}, f)
