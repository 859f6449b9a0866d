"""Packed short-sequence self-attention: the CUDA kernel and its plain version.

The kernel (``csrc/short_attention.cu``) replaces the Pallas TPU kernel
``_kernel`` behind ``short_attention_packed``
(``musev_tpu/ops/pallas/short_attention.py``): multi-head self-attention over
packed ``(N, T, C)`` rows with T <= 64, the temporal attention of every
temporal transformer. q/k/v may be the strided column views of a fused QKV
projection (row stride 3C); no copy is made.

``short_attention_packed`` takes CPU tensors to the plain version and CUDA
tensors to the kernel; on CUDA it launches or raises, never falls back. A
call that autograd records (``records``) runs as ``_ShortAttention``, an
``autograd.Function`` whose forward is that same choice and whose backward
recomputes the plain float32 softmax (T <= 64, so its (N, H, T, T) logits are
small) and differentiates it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, records

MAX_SHORT_SEQ = 64
MAX_HEAD_DIM = 256


def short_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    n_heads: int,
    scale: Optional[float] = None,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Heads-split softmax attention over (N, T, C) with fp32 logits.

    Keys at positions >= ``kv_len`` are masked; the outputs of query rows past
    ``kv_len`` are computed over the valid keys and left to the caller.
    """
    n, t, c = q.shape
    d = c // n_heads
    if scale is None:
        scale = d**-0.5
    qh, kh, vh = (x.reshape(n, t, n_heads, d).float() for x in (q, k, v))
    logits = torch.einsum("nqhd,nkhd->nhqk", qh, kh) * scale
    if kv_len is not None and kv_len < t:
        logits[..., kv_len:] = float("-inf")
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("nhqk,nkhd->nqhd", weights, vh)
    return out.reshape(n, t, c).to(q.dtype)


def layout_error(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int
) -> Optional[str]:
    """Why the kernel cannot read the (N, T, C) views q, k and v as they
    are, or None. It copies and writes 16-byte vectors, so it needs a head
    dim that is a multiple of 8 (at most ``MAX_HEAD_DIM``), strides
    (T*ld, ld, 1) with one ld for the three that is a multiple of 8, and
    16-byte aligned bases."""
    t, d = q.shape[1], q.shape[2] // n_heads
    if d % 8 or d > MAX_HEAD_DIM:
        return f"head dim {d} must be a multiple of 8 up to {MAX_HEAD_DIM}"
    ld = q.stride(1)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride() != (t * ld, ld, 1) or ld % 8:
            return (f"{name} strides {x.stride()} must be (T*ld, ld, 1) with one ld "
                    "for q, k and v, a multiple of 8")
        if x.data_ptr() % 16:
            return f"{name} is not 16-byte aligned"
    return None


def short_attention_packed(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    n_heads: int,
    scale: Optional[float] = None,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Self-attention over packed (N, T, C) rows, T <= 64; returns contiguous
    (N, T, C). ``kv_len`` counts the valid leading keys (default T).

    CUDA inputs must be bf16 with strides (T*ld, ld, 1), one ld for q, k and
    v that is a multiple of 8 (the fused projection's 3C qualifies), a head
    dim C / n_heads that is a multiple of 8 and at most 256, and 16-byte
    aligned bases (``layout_error``); anything else raises ``ValueError``."""
    if q.ndim != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("short_attention_packed takes three (N, T, C) tensors of one shape")
    if not (q.device == k.device == v.device) or not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must share device and dtype")
    n, t, c = q.shape
    if t > MAX_SHORT_SEQ:
        raise ValueError(f"short_attention_packed is for T<={MAX_SHORT_SEQ}, got {t}")
    if c % n_heads:
        raise ValueError(f"C={c} not divisible by heads={n_heads}")
    if kv_len is not None and not 1 <= kv_len <= t:
        raise ValueError(f"kv_len={kv_len} outside [1, {t}]")
    if records(q, k, v):
        return _ShortAttention.apply(q, k, v, n_heads, scale, kv_len)
    return _short_attention(q, k, v, n_heads, scale, kv_len)


def _short_attention(q, k, v, n_heads, scale, kv_len):
    """The plain version on a CPU tensor, else one launch of the kernel."""
    if q.device.type == "cpu":
        return short_attention_plain(q, k, v, n_heads, scale, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"short_attention_packed: unsupported device {q.device}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"short_attention kernel takes bfloat16, got {q.dtype}")
    why = layout_error(q, k, v, n_heads)
    if why is not None:
        raise ValueError(f"short_attention kernel: {why}")
    n, t, c = q.shape
    d = c // n_heads
    ld = q.stride(1)
    if scale is None:
        scale = d**-0.5
    out = torch.empty((n, t, c), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.musev_short_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            n, n_heads, t, d, ld, t if kv_len is None else kv_len,
            float(scale), stream,
        )
    _build.check(lib, err, "short_attention_packed")
    short_attention_packed.launches += 1
    return out


short_attention_packed.launches = 0


class _ShortAttention(torch.autograd.Function):
    """``short_attention_packed`` under autograd: the forward is the kernel
    on CUDA (the plain version on the CPU); the backward recomputes
    ``short_attention_plain`` in float32 (autocast off) from the saved q, k
    and v and returns its grads in their dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, n_heads, scale, kv_len):
        ctx.args = (n_heads, scale, kv_len)
        ctx.save_for_backward(q, k, v)
        return _short_attention(q, k, v, n_heads, scale, kv_len)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad(), torch.autocast(g.device.type, enabled=False):
            leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
            out = short_attention_plain(*leaves, *ctx.args)
            grads = torch.autograd.grad(out, leaves, g.float())
        return (*(d.to(x.dtype) for d, x in zip(grads, (q, k, v))), None, None, None)


def _lib() -> ctypes.CDLL:
    lib = _build.load("short_attention")
    fn = lib.musev_short_attention_bf16
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, ll, i, i, i, ll, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib
