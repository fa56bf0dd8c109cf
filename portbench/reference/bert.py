"""Plain PyTorch BERT: the bi-encoder (CLS pooling, L2) and the one-label
cross-encoder (CLS -> tanh pooler -> classifier), as Hugging Face's
``BertModel`` and ``BertForSequenceClassification`` compute them.

float32 with TF32 off, unless ``precision="fp8"``: then every matrix
product's two inputs and every LayerNorm's output (the residual stream)
are rounded to float8 e4m3 (weights with one scale a tensor, activations
with one scale a row), as the program rounds them to bf16: the control
that ``correct`` has to reject. Sequences run in blocks padded to the block's
longest, padding masked out of attention. Imports nothing of the program."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor, dim: int | None) -> torch.Tensor:
    """x rounded to float8 e4m3 under a scale that maps its largest
    magnitude (over ``dim``, or the whole tensor) to 448, back in f32."""
    amax = x.abs().amax() if dim is None else x.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp_min(amax, 1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Bert:
    """f32 parameters of one checkpoint (a dict of HF names to tensors, any
    float type) on ``device``; ``precision`` "f32" or "fp8"."""

    def __init__(self, state: dict[str, torch.Tensor], hf: dict, device, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        pre = "bert." if any(k.startswith("bert.") for k in state) else ""
        self.p = {k[len(pre):] if k.startswith(pre) else k: v.to(device, torch.float32)
                  for k, v in state.items()}
        self.layers = int(hf["num_hidden_layers"])
        self.heads = int(hf["num_attention_heads"])
        self.eps = float(hf.get("layer_norm_eps", 1e-12))
        self.approx_gelu = hf.get("hidden_act", "gelu") != "gelu"
        self.fp8 = precision == "fp8"
        self.device = device
        if self.fp8:
            for k, v in self.p.items():
                if v.ndim == 2 and not k.startswith("embeddings."):
                    self.p[k] = fp8_round(v, None)

    def _lin(self, x: torch.Tensor, name: str) -> torch.Tensor:
        if self.fp8:
            x = fp8_round(x, -1)
        return x @ self.p[name + ".weight"].T + self.p[name + ".bias"]

    def _ln(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """LayerNorm in f32; in fp8 its output, the residual stream, is
        stored in fp8 as the program stores it in bf16."""
        y = F.layer_norm(x, (x.shape[-1],), self.p[name + ".weight"], self.p[name + ".bias"],
                         self.eps)
        return fp8_round(y, -1) if self.fp8 else y

    def hidden(self, ids: torch.Tensor, mask: torch.Tensor, types: torch.Tensor) -> torch.Tensor:
        """Last hidden states [B, T, D] of padded ids, mask (1 = token) and
        token types."""
        b, t = ids.shape
        p = self.p
        x = (p["embeddings.word_embeddings.weight"][ids]
             + p["embeddings.position_embeddings.weight"][:t][None]
             + p["embeddings.token_type_embeddings.weight"][types])
        x = self._ln(x, "embeddings.LayerNorm")
        bias = (1.0 - mask.float())[:, None, None, :] * -1e9
        hd = x.shape[-1] // self.heads
        for i in range(self.layers):
            pre = f"encoder.layer.{i}."

            def heads(name):
                return self._lin(x, pre + name).view(b, t, self.heads, hd).transpose(1, 2)

            q, k, v = heads("attention.self.query"), heads("attention.self.key"), \
                heads("attention.self.value")
            if self.fp8:
                q, k = fp8_round(q, -1), fp8_round(k, -1)
            s = q @ k.transpose(-1, -2) / math.sqrt(hd) + bias
            a = torch.softmax(s, dim=-1)
            if self.fp8:
                a, v = fp8_round(a, -1), fp8_round(v, -2)
            y = (a @ v).transpose(1, 2).reshape(b, t, -1)
            x = self._ln(x + self._lin(y, pre + "attention.output.dense"),
                         pre + "attention.output.LayerNorm")
            h = F.gelu(self._lin(x, pre + "intermediate.dense"),
                       approximate="tanh" if self.approx_gelu else "none")
            x = self._ln(x + self._lin(h, pre + "output.dense"), pre + "output.LayerNorm")
        return x

    def _blocks(self, seqs: list[list[int]], types: list[list[int]] | None, block: int):
        for i in range(0, len(seqs), block):
            part = seqs[i:i + block]
            t = max(len(s) for s in part)
            ids = torch.zeros((len(part), t), dtype=torch.long)
            mask = torch.zeros((len(part), t))
            tt = torch.zeros((len(part), t), dtype=torch.long)
            for j, s in enumerate(part):
                ids[j, :len(s)] = torch.tensor(s)
                mask[j, :len(s)] = 1.0
                if types is not None:
                    tt[j, :len(s)] = torch.tensor(types[i + j])
            yield (ids.to(self.device), mask.to(self.device), tt.to(self.device))

    @torch.no_grad()
    def embed(self, seqs: list[list[int]], block: int = 32) -> torch.Tensor:
        """L2-normalised CLS states [n, D] of [CLS] ... [SEP] sequences."""
        out = [F.normalize(self.hidden(*b)[:, 0], dim=-1) for b in self._blocks(seqs, None, block)]
        return torch.cat(out)

    @torch.no_grad()
    def score(self, seqs: list[list[int]], types: list[list[int]], block: int = 32) -> torch.Tensor:
        """One-label cross-encoder scores [n] of [CLS] a [SEP] b [SEP] pairs."""
        out = []
        for b in self._blocks(seqs, types, block):
            cls = self.hidden(*b)[:, 0]
            pooled = torch.tanh(self._lin(cls, "pooler.dense"))
            out.append(self._lin(pooled, "classifier")[:, 0])
        return torch.cat(out)
