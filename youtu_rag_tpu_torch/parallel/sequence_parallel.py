"""Sequence-parallel encoder: ring attention over S shards of the sequence.

Counterpart of ``youtu_rag_tpu/parallel/sequence_parallel.py``. Very long
inputs (whole documents past the encoder's ``max_len``) split along the
sequence into S shards of ``Tl = T / S`` tokens. Attention runs as ring
attention: each shard keeps its queries while the K/V blocks and their
padding bias travel round the ring, one hop at a time, with an online
softmax in f32, so no [T, T] score matrix exists. Everything else in the
layer is per token. Pooling sums and counts add up over the ring before
the projection.

The ring (``sp_mesh``, the JAX mesh's ``sp`` axis) is one of two things:

- an int S: the S shards live on one device, on a leading axis folded into
  the batch (row ``s * B + b`` is shard s of sequence b). ``ppermute(i →
  i + 1)`` becomes ``torch.roll`` by one along that axis, so at hop j shard
  i holds shard (i - j) mod S's block, as in JAX, and each hop is one
  ``flash_attention_stats`` launch per layer for all shards at once;
- a ``torch.distributed`` process group: one shard per rank. ``ppermute``
  becomes ``batch_isend_irecv`` to rank + 1 and from rank - 1, ``psum`` an
  ``all_reduce``; NCCL on several cards, gloo on the CPU. Every rank passes
  the whole [B, T] batch and takes its own shard; dp × sp is the caller's
  (one sp group per dp replica, each given its slice of the batch).

Copied from JAX exactly: the flash branch (``attention_impl`` "pallas",
"flash" or "pallas_interpret", Tl >= 256, Tl % 128 == 0, hd % 64 == 0; each
hop ``flash_attention_stats``, "pallas_interpret" its plain version on any
device) starts the running max at -1e30; the plain branch computes in f32
without casting p and starts it at -inf; hops combine by the online-softmax
rule and the output is ``(acc / max(l, 1e-30)).to(q.dtype)``. The padding
bias is -1e9. Each shard's RoPE offset is ``shard * Tl``. Parity notes: the
SP forward pools through ``pool_project`` only, never the lexical pools
(as JAX's), and its LayerNorms use eps 1e-6 whatever ``cfg.ln_eps`` says.
Tensor parallelism (JAX's ``tp_axis``) is not ported (ROADMAP Queue A 8).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..models.encoder import (
    EncoderConfig,
    _check_arch,
    _ffn,
    _layer_norm,
    _rope,
    masked_pool_sums,
    pool_project,
)
from ..ops.attention import CLAMP, flash_attention_stats, flash_attention_stats_reference

FLASH_IMPLS = ("pallas", "flash", "pallas_interpret")
PAD_BIAS = -1e9  # the padding keys' bias, riding the ring with K/V


class _LocalRing:
    """S shards on one device, shard-major on a leading axis of the batch."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"sp_mesh={size}: the ring needs at least one shard")
        self.size = size

    def split(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, ...] → [S * B, Tl, ...], row s * B + b = shard s of b."""
        b, t = x.shape[:2]
        tl = t // self.size
        y = x.reshape(b, self.size, tl, *x.shape[2:]).transpose(0, 1)
        return y.reshape(self.size * b, tl, *x.shape[2:])

    def offsets(self, b: int, tl: int, device) -> torch.Tensor:
        """Each row's global start ``shard * Tl`` (f32), shaped for ``_rope``."""
        pos0 = torch.arange(self.size, dtype=torch.float32, device=device) * tl
        return pos0.repeat_interleave(b).view(-1, 1, 1, 1)

    def shift(self, *xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """Shard i receives shard i - 1's block (``ppermute(i → i + 1)``)."""
        return tuple(x.reshape(self.size, -1, *x.shape[1:]).roll(1, 0).reshape(x.shape)
                     for x in xs)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(self.size, -1, *x.shape[1:]).sum(0)

    def first(self, x: torch.Tensor) -> torch.Tensor:
        """Shard 0's rows (global position 0 lives there)."""
        return x.reshape(self.size, -1, *x.shape[1:])[0]


class _GroupRing:
    """One shard per rank of a ``torch.distributed`` process group."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.next = dist.get_global_rank(group, (self.rank + 1) % self.size)
        self.prev = dist.get_global_rank(group, (self.rank - 1) % self.size)

    def split(self, x: torch.Tensor) -> torch.Tensor:
        tl = x.shape[1] // self.size
        return x[:, self.rank * tl : (self.rank + 1) * tl]

    def offsets(self, b: int, tl: int, device) -> float:
        return float(self.rank * tl)

    def shift(self, *xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
        if self.size == 1:
            return xs
        outs = [torch.empty(x.shape, dtype=x.dtype, device=x.device) for x in xs]
        ops = [dist.P2POp(dist.isend, x.contiguous(), self.next, self.group, tag)
               for tag, x in enumerate(xs)]
        ops += [dist.P2POp(dist.irecv, out, self.prev, self.group, tag)
                for tag, out in enumerate(outs)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return tuple(outs)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        x = x.clone()
        dist.all_reduce(x, group=self.group)
        return x

    def first(self, x: torch.Tensor) -> torch.Tensor:
        return self.psum(x if self.rank == 0 else torch.zeros_like(x))


def _ring_of(sp_mesh):
    if isinstance(sp_mesh, int):
        return _LocalRing(sp_mesh)
    if dist.is_available() and isinstance(sp_mesh, dist.ProcessGroup):
        return _GroupRing(sp_mesh)
    raise TypeError(f"sp_mesh must be an int or a torch.distributed process group, got {sp_mesh!r}")


def _ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                    ring, scale: float, impl: str = "xla") -> torch.Tensor:
    """Full (non-causal) ring attention of the local blocks q, k, v
    [G, H, Tl, hd] (RoPE applied) with the local keys' bias [G, Tl]
    (0 live, -1e9 padding), which travels with k and v. Returns
    [G, H, Tl, hd] in q's dtype."""
    g, h, tl, hd = q.shape
    use_flash = impl in FLASH_IMPLS and tl >= 256 and tl % 128 == 0 and hd % 64 == 0
    rows = (g, h, tl)
    l = torch.zeros(rows, dtype=torch.float32, device=q.device)
    acc = torch.zeros((g, h, tl, hd), dtype=torch.float32, device=q.device)
    if use_flash:
        hop = flash_attention_stats_reference if impl == "pallas_interpret" else flash_attention_stats
        # -1e30, not -inf: the combine computes exp(m - m_new), NaN at -inf - -inf
        m = torch.full(rows, CLAMP, dtype=torch.float32, device=q.device)
    else:
        if q.is_cuda:
            torch.backends.cuda.matmul.allow_tf32 = False
        qf = q.float()
        m = torch.full(rows, float("-inf"), dtype=torch.float32, device=q.device)
    for j in range(ring.size):
        if j:
            k, v, bias = ring.shift(k, v, bias)
        if use_flash:
            acc_h, m_h, l_h = hop(q, k, v, bias)
            m_new = torch.maximum(m, m_h)
            a_old = torch.exp(m - m_new)
            a_hop = torch.exp(m_h - m_new)
            l = l * a_old + l_h * a_hop
            acc = acc * a_old[..., None] + acc_h * a_hop[..., None]
        else:
            s = torch.matmul(qf, k.float().transpose(-1, -2)) * scale
            s = s + bias[:, None, None, :]
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.matmul(p, v.float())
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)


def make_sp_encoder(cfg: EncoderConfig, sp_mesh, tp_axis: str | None = None):
    """The sequence-sharded forward over the ring ``sp_mesh`` (module
    docstring). Returns ``fn(params, token_ids, mask) -> (emb [B, out_dim]
    f32, cls [B, d_model] f32)``, ``encode_tokens``' contract: token_ids
    and mask [B, T] tensors on the parameters' device, T a multiple of S
    (``pad_to_multiple``; padding has mask 0)."""
    _check_arch(cfg)
    if tp_axis is not None:
        raise NotImplementedError("tensor parallelism in the SP encoder (tp_axis) is not ported "
                                  "yet (ROADMAP Queue A 8)")
    ring = _ring_of(sp_mesh)
    h, hd, dt = cfg.n_heads, cfg.head_dim, cfg.dtype
    scale = 1.0 / float(np.sqrt(hd))

    @torch.inference_mode()
    def forward(params: dict, token_ids: torch.Tensor, mask: torch.Tensor):
        b, t = token_ids.shape
        if t % ring.size:
            raise ValueError(f"T={t} is not a multiple of the ring's {ring.size} shards")
        tl = t // ring.size
        ids = ring.split(token_ids.long())
        msk = ring.split(mask.float())
        g = ids.shape[0]
        pos0 = ring.offsets(b, tl, ids.device)
        x = params["tok_emb"][ids].to(dt)  # [G, Tl, D]
        kv_bias = (1.0 - msk) * PAD_BIAS  # [G, Tl]: 0 live, -1e9 padding

        def proj(xin, w):
            return torch.matmul(xin, w.to(xin.dtype)).view(g, tl, h, hd).transpose(1, 2)

        for i in range(cfg.n_layers):
            lp = {name: w[i] for name, w in params["layers"].items()}
            hn = _layer_norm(x, lp["ln1_scale"], lp["ln1_bias"])
            q = _rope(proj(hn, lp["wq"]), cfg.rope_base, pos0)
            k = _rope(proj(hn, lp["wk"]), cfg.rope_base, pos0)
            v = proj(hn, lp["wv"])
            y = _ring_attention(q, k, v, kv_bias, ring, scale, cfg.attention_impl)
            y = y.transpose(1, 2).reshape(g, tl, h * hd)
            x = x + torch.matmul(y, lp["wo"].to(x.dtype))
            hn = _layer_norm(x, lp["ln2_scale"], lp["ln2_bias"])
            x = x + _ffn(hn, lp, dt)
        x = _layer_norm(x, params["final_ln_scale"], params["final_ln_bias"])

        # masked mean pool: the shards' sums and counts add up over the ring
        summed, cnt = masked_pool_sums(x, msk)
        emb = pool_project(params, ring.psum(summed), ring.psum(cnt))
        cls = ring.first(x[:, 0, :].float())  # global position 0 is shard 0's
        return emb, cls

    forward.ring_size = ring.size
    return forward


def pad_to_multiple(ids: np.ndarray, mask: np.ndarray, multiple: int):
    """Right-pad [B, T] token ids + mask so T divides the ring size."""
    b, t = ids.shape
    t_pad = ((t + multiple - 1) // multiple) * multiple
    if t_pad == t:
        return ids, mask
    out_ids = np.zeros((b, t_pad), ids.dtype)
    out_mask = np.zeros((b, t_pad), mask.dtype)
    out_ids[:, :t] = ids
    out_mask[:, :t] = mask
    return out_ids, out_mask
