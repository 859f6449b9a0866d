"""Flash attention over ``(B, S, H, D)``: the CUDA kernel and its plain version.

The kernel (``csrc/flash_attention.cu``) replaces two Pallas TPU kernels of
``musev_tpu/ops/pallas/flash_attention.py``: ``_unroll_kernel`` (K1, resident
K/V) and ``_carry_kernel`` (K3, K/V parts carried over a grid axis). On Hopper
one kernel loops over every KV tile with the softmax state in registers, so
both regimes are one launch; the TPU's block-size plans have no counterpart.
Every head dim runs a warp-specialised wgmma/TMA kernel that reads q, k and
v through TMA tensor maps: up to 160 with 64-row consumer warpgroups, above
(the VAE's 512) with two consumer warpgroups sharing 64 query rows.

``flash_attention_parts`` is the JAX package's split-merge route
(``_flash_unroll(with_stats=True)`` per KV part, merged by ``_merge_parts``,
flash_attention.py:575-639): one launch of the same kernel per KV part, each
also writing its per-row softmax stats (m, l), and an exact merge in PyTorch.

The wrappers take CPU tensors to the plain versions and CUDA tensors to the
kernel; on CUDA they launch or raise, never fall back. A call that autograd
records (``records``) returns ``ops.attention.mem_efficient_sdpa``: an
``autograd.Function`` whose forward is the same launches with their softmax
stats (the plain versions on the CPU) and whose backward recomputes the
probabilities chunk by chunk.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build, records

MAX_HEAD_DIM = 512
LOG2E = 1.4426950408889634


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


def flash_attention_stats_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(o, m, l)`` in fp32 math: o as ``flash_attention_plain``; m (B, Sq, H)
    the row max of logits · scale · log2(e), l = Σ exp2(logits · scale ·
    log2(e) − m), the units of the kernel's stats outputs."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (scale * LOG2E)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p / l, v.float()).to(q.dtype)
    return o, m[..., 0].transpose(1, 2).contiguous(), l[..., 0].transpose(1, 2).contiguous()


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


def layout_error(x: torch.Tensor) -> Optional[str]:
    """Why the flash kernels cannot read the (B, S, H, D) view ``x`` as it
    is, or None. They read it through a TMA tensor map, which needs a
    contiguous head dim, batch/sequence/head strides that are multiples of
    8 elements, a 16-byte aligned base, and no dim of extent above 1 that is
    a broadcast (stride 0), which TMA cannot step."""
    if x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3]):
        return (f"strides {x.stride()} need a contiguous head dim and "
                "8-element-aligned outer strides")
    if any(n > 1 and s == 0 for n, s in zip(x.shape[:3], x.stride()[:3])):
        return (f"strides {x.stride()} broadcast a dim (stride 0), which TMA cannot "
                "address: pass it .contiguous()")
    if x.data_ptr() % 16:
        return "is not 16-byte aligned"
    return None


def check_kernel_inputs(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        max_head_dim: int) -> None:
    """What the (B, S, H, D) flash kernels take on CUDA; raises otherwise."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"{name} kernel takes bfloat16, got {q.dtype}")
    d = q.shape[-1]
    if d % 8 or d > max_head_dim:
        raise ValueError(f"{name} kernel: head dim {d} unsupported")
    for label, x in (("q", q), ("k", k), ("v", v)):
        why = layout_error(x)
        if why is not None:
            raise ValueError(f"{name} kernel: {label} {why}")


def strides(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    """The (batch, seq, head) element strides of q, k and v, in that order."""
    return (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float],
            with_stats: bool):
    """One kernel launch; returns (o, m, l), m and l None without stats."""
    check_kernel_inputs("flash_attention", q, k, v, MAX_HEAD_DIM)
    b, sq, h, d = q.shape
    if scale is None:
        scale = d**-0.5
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    m = l = None
    if with_stats:
        m = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    if out.numel() == 0:
        return out, m, l
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.musev_flash_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, sq, k.shape[1], d, *strides(q, k, v), float(scale),
            None if m is None else m.data_ptr(), None if l is None else l.data_ptr(),
            stream,
        )
    _build.check(lib, err, "flash_attention")
    return out, m, l


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """Attention over (B, S, H, D) tensors with batch, sequence and head
    strides that are multiples of 8 elements and not 0 (no broadcast views);
    returns contiguous (B, Sq, H, D).

    CUDA inputs must be bf16 with a contiguous head dim d (a multiple of 8,
    at most 512) and a 16-byte aligned base; the views of a fused QKV
    projection qualify as they are. A broadcast view raises at every head
    dim (TMA cannot step it): the caller makes it contiguous.
    """
    _check(q, k, v)
    if records(q, k, v):
        return _mem_efficient(q, k, v, scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    out, _, _ = _launch(q, k, v, scale, with_stats=False)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_parts(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None,
    part: int = 4096,
) -> torch.Tensor:
    """Attention over KV parts of ``part`` rows, merged exactly.

    Each part is one launch on row views of k and v (no copies) that also
    writes the rows' softmax stats (m, l); the parts' outputs are merged in
    float32 with the rescaling identity of ``_merge_parts``
    (flash_attention.py:606-612). Same input rules as ``flash_attention``.
    """
    _check(q, k, v)
    if part < 1:
        raise ValueError(f"flash_attention_parts: part {part} must be positive")
    if records(q, k, v):
        return _mem_efficient(q, k, v, scale, part)
    if k.shape[1] == 0:
        return torch.zeros_like(q)
    return attention_parts(q, k, v, scale, part)[0].to(q.dtype)


flash_attention_parts.launches = 0


def attention_parts(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float], part: int):
    """The split-merge route's float32 output and merged stats (o, m, l) in
    the kernel's units: one launch per part on CUDA (counted as
    ``flash_attention_parts.launches``), ``flash_attention_stats_plain`` on
    the CPU. Takes at least one KV row."""
    o = m = l = None
    for lo in range(0, k.shape[1], part):
        kp, vp = k[:, lo:lo + part], v[:, lo:lo + part]
        if q.device.type == "cpu":
            oi, mi, li = flash_attention_stats_plain(q, kp, vp, scale)
        else:
            oi, mi, li = _launch(q, kp, vp, scale, with_stats=True)
            flash_attention_parts.launches += 1
        if o is None:
            o, m, l = oi.float(), mi, li
            continue
        o, m, l = merge_stats(o, m, l, oi, mi, li)
    return o, m, l


def merge_stats(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor, oi: torch.Tensor,
                mi: torch.Tensor, li: torch.Tensor):
    """Merge a float32 partial attention output ``o`` (B, Sq, H, D) over
    some keys, with its stats (m, l) in the kernel's units, and the output
    ``oi`` with stats (mi, li) over other keys, exactly, by the rescaling
    identity of ``_merge_parts`` (flash_attention.py:606-612); ``o`` is
    updated in place. Returns (o, m, l) over both key sets."""
    m_new = torch.maximum(m, mi)
    # a row with every key masked so far has max -inf: subtract 0 there
    base = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new), m_new)
    w1 = torch.exp2(m - base) * l
    w2 = torch.exp2(mi - base) * li
    total = w1 + w2
    denom = torch.where(total > 0, total, torch.ones_like(total))
    o.mul_(w1[..., None]).add_(oi.float().mul_(w2[..., None])).div_(denom[..., None])
    return o, m_new, total


def _mem_efficient(q, k, v, scale, part=None):
    from ..attention import mem_efficient_sdpa  # ops.attention imports this module

    return mem_efficient_sdpa(q, k, v, scale, part)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.musev_flash_attention_bf16
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, i, i, i, i, i, ll, ll, ll, ll, ll, ll, ll, ll, ll,
                       ctypes.c_float, p, p, p]
        fn.restype = ctypes.c_int
    return lib
