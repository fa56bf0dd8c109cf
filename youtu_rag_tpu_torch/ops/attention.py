"""Attention for the encoder forward: blockwise and flash.

Counterpart of ``youtu_rag_tpu/ops/attention.py``'s ``blockwise_attention``
and ``flash_attention``. The contract is the JAX kernels':

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
- a batch row whose every key is masked averages ``v`` uniformly, as the
  JAX kernels do, and gives no NaN.

Each wrapper (``blockwise_attention``, ``flash_attention``) launches its
hand-written CUDA kernel (``csrc/attention.cu``) for CUDA tensors and
counts the launch in its ``.launches``; for CPU tensors it runs its plain
PyTorch version (``*_reference``). On every device it raises
``ValueError`` outside the kernel's range: hd 64 or 128, T a multiple of
128 and at least 256, bf16 or f32.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

CLAMP = -1e30  # the JAX kernels' bias clamp
FLASH_BLOCK_K = 2048  # JAX flash_attention's default key block
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
    b, h, t, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd}; the kernel takes {HEAD_DIMS}")
    if t < 256 or t % 128:
        raise ValueError(f"{name}: T={t}; the kernel takes multiples of 128 from 256")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k, v must all be bf16 or all f32, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if tuple(bias.shape) != (b, t) or not bias.is_floating_point():
        raise ValueError(f"{name}: bias must be a float [B, T] = [{b}, {t}] tensor, "
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


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              bias: torch.Tensor, block_k: int = FLASH_BLOCK_K) -> torch.Tensor:
    """Plain PyTorch version of the flash kernel (``_flash_kernel``): the
    online softmax over JAX's key blocks (``_fit_block(block_k, T)``), so
    that the running max, and with it each bf16 cast of ``exp(s - m)``,
    falls where the JAX kernel's does."""
    t = q.shape[2]
    bk = _fit_block(block_k, t)
    rows = q.shape[:3] + (1,)
    m = torch.full(rows, CLAMP, dtype=torch.float32, device=q.device)
    l = torch.zeros(rows, dtype=torch.float32, device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, t, bk):
        s = _scores(q, k[:, :, k0 : k0 + bk], bias[:, k0 : k0 + bk])
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        pv = torch.matmul(p.to(v.dtype).float(), v[:, :, k0 : k0 + bk].float())
        acc = acc * alpha + pv
        m = m_new
    return (acc / l).to(q.dtype)


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
        lib.attention_error_string.argtypes = [i]
        lib.attention_error_string.restype = ctypes.c_char_p
    return lib


def _kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself where the kernel can read it through its strides (a
    unit last stride, 16-byte aligned rows), else a contiguous copy."""
    per16 = 16 // x.element_size()
    if (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s % per16 == 0 for s in x.stride()[:3])):
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
    The kernel's key tile (64) is not JAX's block (up to 2048), so its bf16
    casts of ``exp(s - m)`` use other running maxima than the plain
    version's; they agree within the bf16 rounding of ``p``."""
    if _check("flash_attention", q, k, v, bias) == "cpu":
        return flash_attention_reference(q, k, v, bias)
    return _launch(flash_attention, q, k, v, bias)


blockwise_attention.launches = 0
flash_attention.launches = 0
