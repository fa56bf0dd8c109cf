"""Attention for the encoder forward: blockwise, flash and the ring hop.

Counterpart of ``youtu_rag_tpu/ops/attention.py``'s ``blockwise_attention``,
``flash_attention`` and ``flash_attention_stats``. The contract is the JAX
kernels':

- ``q, k, v`` are ``[B, H, T, hd]``, ``bias`` is an additive ``[B, T]`` key
  bias (0 live, a large negative number for padding), clamped to -1e30
  (``CLAMP``) so that a -inf bias cannot turn the softmax into NaN;
- scores are ``f32(q)·f32(k)`` summed in f32, times ``1/sqrt(hd)`` (as an
  f32), plus the bias;
- blockwise: one softmax over all keys, the probabilities normalized in
  f32 and *then* cast to ``v.dtype``, ``p·v`` summed in f32, cast to
  ``q.dtype``;
- flash: an online softmax over key blocks, running max starting at
  -1e30; the unnormalized ``exp(s - m)`` is cast to ``v.dtype`` for the
  ``p·v`` product and the sum is divided by the denominator at the end;
- flash_attention_stats: flash's one pass over a K/V span of its own length
  T_kv (one hop of ring attention), ending without the divide: ``acc`` =
  Σ exp(s - m)·cast(v) f32 [B, H, T, hd] and the running max ``m`` (from
  -1e30) and denominator ``l`` f32 [B, H, T];
- a batch row whose every key is masked averages ``v`` uniformly, as the
  JAX kernels do, and gives no NaN.

Each wrapper (``blockwise_attention``, ``flash_attention``,
``flash_attention_stats``) launches its hand-written CUDA kernel
(``csrc/attention.cu``; every bf16 call runs its Hopper kernels,
``csrc/attention_wgmma.cuh``, and f32 calls its mma.sync kernel) for CUDA
tensors and counts the launch in its ``.launches``; for CPU tensors it runs
its plain PyTorch version (``*_reference``). On every device it raises ``ValueError`` outside the
kernel's range: hd 64 or 128, bf16 or f32; T a multiple of 128 and at
least 256 (the stats entry: T and T_kv multiples of 128). The kernels have
no backward, so each wrapper also raises ``ValueError`` for a
differentiable call (grad mode on and q, k or v requiring grad), on the
CPU route too, as JAX refuses to differentiate a Pallas call: the CUDA
kernels write a fresh tensor with no ``grad_fn``, and training through
them would leave ``wq``, ``wk`` and ``wv`` without a gradient. Training
takes plain attention (``attention_impl="xla"``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

CLAMP = -1e30  # the JAX kernels' bias clamp
FLASH_BLOCK_K = 2048  # JAX flash_attention's default key block
STATS_BLOCK_K = 1024  # JAX flash_attention_stats' default key block
HEAD_DIMS = (64, 128)
DTYPES = (torch.bfloat16, torch.float32)
MAX_BH = 65535  # batch x heads ride the grid's y dimension


def _scale(hd: int) -> float:
    return 1.0 / (hd**0.5)


def _fit_block(block: int, t: int) -> int:
    """JAX's block fitting (``ops/attention.py:262-266``): the largest
    halving of ``block`` that divides ``t``, at least 128."""
    b = min(block, t)
    while t % b:
        b //= 2
    return max(b, 128)


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           bias: torch.Tensor) -> str:
    """The kernel's range, on every device. Returns the device type."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k, v must share one [B, H, T, hd] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[2] < 256:
        raise ValueError(f"{name}: T={q.shape[2]}; the kernel takes multiples of 128 from 256")
    return _check_span(name, q, k, v, bias)


def _check_span(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                bias: torch.Tensor) -> str:
    """q [B, H, T, hd] against a K/V span [B, H, T_kv, hd] and its bias
    [B, T_kv], T and T_kv multiples of 128, not under differentiation.
    Returns the device type."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise ValueError(f"{name}: the kernel has no backward; differentiate through "
                         "plain attention (attention_impl='xla')")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or (
            k.shape[:2] + k.shape[3:] != q.shape[:2] + q.shape[3:]):
        raise ValueError(f"{name}: q [B, H, T, hd] and k, v [B, H, T_kv, hd] do not match: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, t, hd = q.shape
    t_kv = k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd}; the kernel takes {HEAD_DIMS}")
    if t < 128 or t % 128 or t_kv < 128 or t_kv % 128:
        raise ValueError(f"{name}: T={t}, T_kv={t_kv}; the kernel takes multiples of 128")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k, v must all be bf16 or all f32, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if tuple(bias.shape) != (b, t_kv) or not bias.is_floating_point():
        raise ValueError(f"{name}: bias must be a float [B, T_kv] = [{b}, {t_kv}] tensor, "
                         f"got {bias.dtype} {tuple(bias.shape)}")
    devices = {x.device for x in (q, k, v, bias)}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on different devices {devices}")
    kind = devices.pop().type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {kind}")
    return kind


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _scores(q: torch.Tensor, k: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``f32(q)·f32(k)ᵀ`` (TF32 off) times the f32 scale, plus the clamped
    bias broadcast over heads and queries: two separate f32 operations,
    as in the JAX kernels."""
    if q.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    bias = torch.clamp_min(bias.float(), CLAMP)
    return s * _scale(q.shape[-1]) + bias[:, None, None, :]


def blockwise_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the blockwise kernel (``_attn_kernel``):
    the full score matrix, one softmax normalized before the cast."""
    s = _scores(q, k, bias)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = (p / p.sum(dim=-1, keepdim=True)).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def _online_softmax(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                    block_k: int):
    """The flash kernels' recurrence over JAX's key blocks
    (``_fit_block(block_k, T_kv)``), so that the running max, and with it
    each bf16 cast of ``exp(s - m)``, falls where the JAX kernel's does.
    Returns (acc [B, H, T, hd], m [B, H, T, 1], l [B, H, T, 1]), f32."""
    t_kv = k.shape[2]
    bk = _fit_block(block_k, t_kv)
    rows = q.shape[:3] + (1,)
    m = torch.full(rows, CLAMP, dtype=torch.float32, device=q.device)
    l = torch.zeros(rows, dtype=torch.float32, device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, t_kv, bk):
        s = _scores(q, k[:, :, k0 : k0 + bk], bias[:, k0 : k0 + bk])
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        pv = torch.matmul(p.to(v.dtype).float(), v[:, :, k0 : k0 + bk].float())
        acc = acc * alpha + pv
        m = m_new
    return acc, m, l


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              bias: torch.Tensor, block_k: int = FLASH_BLOCK_K) -> torch.Tensor:
    """Plain PyTorch version of the flash kernel (``_flash_kernel``): the
    online softmax over JAX's key blocks (``_online_softmax``), then the
    divide."""
    acc, _, l = _online_softmax(q, k, v, bias, block_k)
    return (acc / l).to(q.dtype)


def flash_attention_stats_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    bias: torch.Tensor, block_k: int = STATS_BLOCK_K):
    """Plain PyTorch version of the ring hop's kernel
    (``_flash_stats_kernel``): the online softmax over JAX's key blocks of
    the span, no divide. Returns (acc [B, H, T, hd], m [B, H, T],
    l [B, H, T]), f32."""
    acc, m, l = _online_softmax(q, k, v, bias, block_k)
    return acc, m[..., 0], l[..., 0]


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _library() -> ctypes.CDLL:
    lib = _build.load("attention")
    if lib.blockwise_attention_launch.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        for fn in (lib.blockwise_attention_launch, lib.flash_attention_launch):
            fn.argtypes = [i] + [p] * 5 + [i] * 4 + [i64] * 9 + [ctypes.c_float, p]
            fn.restype = i
        lib.flash_attention_stats_launch.argtypes = (
            [i] + [p] * 7 + [i] * 5 + [i64] * 9 + [ctypes.c_float, p])
        lib.flash_attention_stats_launch.restype = i
        lib.attention_error_string.argtypes = [i]
        lib.attention_error_string.restype = ctypes.c_char_p
    return lib


def _kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself where the kernels can read it through its strides (a
    unit last stride, 16-byte aligned rows, and no zero stride on a
    dimension of extent above 1, which a TMA tensor map cannot take), else
    a contiguous copy."""
    per16 = 16 // x.element_size()
    if (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s % per16 == 0 and (s > 0 or n == 1)
                    for s, n in zip(x.stride()[:3], x.shape[:3]))):
        return x
    return x.contiguous()


def _launch(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/attention.cu``'s entry for ``fn`` on the current
    stream (no sync). Returns [B, H, T, hd] in ``q.dtype``."""
    name = fn.__name__
    b, h, t, hd = q.shape
    if b * h > MAX_BH:
        raise ValueError(f"{name}: B*H = {b * h} above {MAX_BH}")
    q, k, v = (_kernel_layout(x) for x in (q, k, v))
    bias = torch.clamp_min(bias.float(), CLAMP).contiguous()
    out = torch.empty((b, h, t, hd), dtype=q.dtype, device=q.device)
    lib = _library()
    strides = [s for x in (q, k, v) for s in x.stride()[:3]]
    err = getattr(lib, f"{name}_launch")(
        int(q.dtype == torch.float32), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr(), out.data_ptr(), b, h, t, hd, *strides, _scale(hd),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        msg = lib.attention_error_string(err).decode()
        raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")
    fn.launches += 1
    return out


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """softmax(q·kᵀ/sqrt(hd) + bias)·v, probabilities normalized before the
    cast (``blockwise_attention``). q, k, v [B, H, T, hd] bf16 or f32,
    bias [B, T]; returns [B, H, T, hd] in q.dtype. On CUDA: launches on
    the current stream and does not synchronize."""
    if _check("blockwise_attention", q, k, v, bias) == "cpu":
        return blockwise_attention_reference(q, k, v, bias)
    return _launch(blockwise_attention, q, k, v, bias)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """The same function by an online softmax over key tiles
    (``flash_attention``): unnormalized bf16 ``p·v``, divided at the end.
    The kernel's key tile (128 in bf16, the Hopper kernel of
    ``csrc/attention_wgmma.cuh``; 64 in f32) is not JAX's block (up to
    2048), so its bf16 casts of ``exp(s - m)`` use other running maxima
    than the plain version's; they agree within the bf16 rounding of
    ``p``."""
    if _check("flash_attention", q, k, v, bias) == "cpu":
        return flash_attention_reference(q, k, v, bias)
    return _launch(flash_attention, q, k, v, bias)


def flash_attention_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor):
    """One ring-attention hop (``flash_attention_stats``): flash's online
    softmax of q [B, H, T, hd] over the span k, v [B, H, T_kv, hd] with
    its key bias [B, T_kv], without the final divide. Returns (acc
    [B, H, T, hd], m [B, H, T], l [B, H, T]), f32. Hops combine as
    ``parallel/sequence_parallel.py`` does. The kernel's key tile (128 in
    bf16, the Hopper kernel of ``csrc/attention_wgmma.cuh``; 64 in f32) is
    not JAX's block (up to 1024): m is the same maximum, l and acc agree
    within f32 summation order and the bf16 rounding of ``p``. On CUDA:
    launches on the current stream and does not synchronize."""
    name = "flash_attention_stats"
    if _check_span(name, q, k, v, bias) == "cpu":
        return flash_attention_stats_reference(q, k, v, bias)
    b, h, t, hd = q.shape
    t_kv = k.shape[2]
    if b * h > MAX_BH:
        raise ValueError(f"{name}: B*H = {b * h} above {MAX_BH}")
    q, k, v = (_kernel_layout(x) for x in (q, k, v))
    bias = torch.clamp_min(bias.float(), CLAMP).contiguous()
    acc = torch.empty((b, h, t, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    l = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    lib = _library()
    strides = [s for x in (q, k, v) for s in x.stride()[:3]]
    err = lib.flash_attention_stats_launch(
        int(q.dtype == torch.float32), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, h, t, t_kv, hd,
        *strides, _scale(hd), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        msg = lib.attention_error_string(err).decode()
        raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")
    flash_attention_stats.launches += 1
    return acc, m, l


blockwise_attention.launches = 0
flash_attention.launches = 0
flash_attention_stats.launches = 0
