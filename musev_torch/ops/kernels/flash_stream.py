"""Long-KV streaming flash attention: the CUDA kernel and its plain version.

The kernel (``csrc/flash_stream.cu``) replaces the Pallas TPU kernel
``_stream_kernel`` (``musev_tpu/ops/pallas/flash_attention.py:165``): a
thread-block cluster of CN CTAs holds CN x 64 * NC consecutive query rows of
one (b, h) and streams K/V past them once, each K/V tile loaded once per
cluster by TMA multicast into every CTA's shared memory. As in the JAX
package, no dispatcher routes to it; it is an alternative long-KV design held
against ``flash_attention`` on the card.

``flash_stream`` takes CPU tensors to ``flash_attention_plain`` and CUDA
tensors to the kernel; on CUDA it launches or raises, never falls back. The
kernel writes no softmax stats, so it has no backward: a call on CUDA that
autograd records raises (training takes ``flash_attention``, whose launch
with stats is ``mem_efficient_sdpa``'s forward); on the CPU such a call runs
the plain version with autograd through it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, records
from .flash_attention import (
    _check,
    check_kernel_inputs,
    flash_attention_plain,
    strides,
)

MAX_HEAD_DIM = 160


def flash_stream(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """Attention over (B, S, H, D) tensors; returns contiguous (B, Sq, H, D).

    CUDA inputs follow ``flash_attention``'s rules (read through TMA: no
    broadcast views) with head dims up to 160 (the UNet's 40, 80 and 160).
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    if records(q, k, v):
        raise NotImplementedError(
            "flash_stream has no backward (its kernel writes no softmax stats): "
            "train through flash_attention")
    check_kernel_inputs("flash_stream", q, k, v, MAX_HEAD_DIM)
    b, sq, h, d = q.shape
    if scale is None:
        scale = d**-0.5
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.musev_flash_stream_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, sq, k.shape[1], d, *strides(q, k, v), float(scale), stream,
        )
    _build.check(lib, err, "flash_stream")
    flash_stream.launches += 1
    return out


flash_stream.launches = 0


def plan(d: int) -> dict:
    """The plan the kernel takes at head dim ``d``: cluster size, query rows
    per CTA and the clusters the current card holds at once."""
    lib = _lib()
    info = (ctypes.c_int * 3)()
    _build.check(lib, lib.musev_flash_stream_plan(d, info), "flash_stream plan")
    return dict(cluster_size=info[0], rows_per_cta=info[1], active_clusters=info[2])


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_stream")
    fn = lib.musev_flash_stream_bf16
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, i, i, i, i, i, ll, ll, ll, ll, ll, ll, ll, ll, ll,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
        lib.musev_flash_stream_plan.argtypes = [i, ctypes.POINTER(ctypes.c_int)]
        lib.musev_flash_stream_plan.restype = ctypes.c_int
    return lib
