"""Flash attention over ``(B, S, H, D)``: the CUDA kernel and its plain version.

The kernel (``csrc/flash_attention.cu``) replaces two Pallas TPU kernels of
``musev_tpu/ops/pallas/flash_attention.py``: ``_unroll_kernel`` (K1, resident
K/V) and ``_carry_kernel`` (K3, K/V parts carried over a grid axis). On Hopper
one kernel loops over every KV tile with the softmax state in registers, so
both regimes are one launch; the TPU's block-size plans have no counterpart.

``flash_attention`` takes CPU tensors to ``flash_attention_plain`` and CUDA
tensors to the kernel; on CUDA it launches or raises, never falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

MAX_HEAD_DIM = 512


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax(q kᵀ · scale + bias) v in fp32 over (B, S, H, D); ``bias``
    broadcasts to (B, H, Sq, Sk)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v.float()).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes (B, S, H, D) tensors")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    b, _, h, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must have one dtype")


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """Attention over (B, S, H, D) tensors; returns contiguous (B, Sq, H, D).

    CUDA inputs must be bf16 with a contiguous head dim d (a multiple of 8,
    at most 512) and batch/sequence/head strides that are multiples of 8
    elements; the views of a fused QKV projection qualify as they are.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention kernel takes bfloat16, got {q.dtype}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel: head dim {d} unsupported")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3]):
            raise ValueError(
                f"flash_attention kernel: {name} strides {x.stride()} need a "
                "contiguous head dim and 8-element-aligned outer strides"
            )
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel: {name} is not 16-byte aligned")
    if scale is None:
        scale = d**-0.5
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.musev_flash_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, sq, sk, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(scale), stream,
        )
    _build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.musev_flash_attention_bf16
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, i, i, i, i, i, ll, ll, ll, ll, ll, ll, ll, ll, ll,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib
