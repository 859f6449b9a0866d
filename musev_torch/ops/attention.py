"""Scaled-dot-product attention dispatch over ``(B, S, H, D)`` tensors.

Counterpart of ``musev_tpu/ops/attention.py:sdpa``. No fallback:

* a CPU tensor takes the plain PyTorch math;
* a CUDA tensor with no bias goes to the hand-written flash kernel
  (``ops.kernels.flash_attention``): spatial self-attention, both
  ReferenceOnly halves, the ReferenceNet fuse, cross-attention over the text
  and IP-Adapter tokens, CLIP vision and the VAE mid-block;
* a CUDA tensor with a bias (CLIP text's causal mask) stays plain PyTorch
  math, as the JAX package leaves it to XLA.

Long KV follows the JAX package's switch ``MUSEV_FLASH_LONGKV``
(flash_attention.py:55), read at call time: ``carry`` (default) runs one
kernel over the whole KV; ``split`` sends KV that fails the JAX dispatcher's
resident-KV test (flash_attention.py:556-559) to the split-merge route,
``flash_attention_parts``, with the JAX package's part size, so both
packages split at the same sites and rows. ``flash_stream`` is not
dispatched, as in the JAX package. ``F.scaled_dot_product_attention`` is
used on no path.

A call that autograd records (``kernels.records``: grad mode on and an input
that requires grad) takes the training route, the counterpart of the JAX
package's ``training_ctx`` (attention.py:198-202), inside the wrappers,
decided by the autograd state on every device: ``flash_attention`` and
``flash_attention_parts`` return ``mem_efficient_sdpa``, the counterpart of
``_mem_efficient_sdpa`` (attention.py:73-133): an ``autograd.Function`` whose
forward is the wrapper's own kernel launch with its softmax stats on CUDA
(the plain q-chunked forward on the CPU) and which saves only (q, k, v, out,
lse); its backward recomputes each chunk of ``TRAIN_CHUNK`` query rows'
probabilities in float32, so it holds (B, H, TRAIN_CHUNK, Sk) float32 at a
time, not (B, H, Sq, Sk). It takes any query length (the last chunk may be
short), so training and inference run the same kernels at every site. A
bias takes the plain attention in both modes, autograd through it (the JAX
package's ``_xla_sdpa``).
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from ..parallel.context import sp_axis
from .kernels.flash_attention import (
    _launch,
    attention_parts,
    flash_attention,
    flash_attention_parts,
    flash_attention_plain,
)

# the JAX package's training chunk (attention.py:49) and the shortest
# sequence its dispatcher sends to flash or ring attention (:25)
TRAIN_CHUNK = 512
FLASH_MIN_SEQ = 512

# copies of the JAX package's block plans (flash_attention.py:51, :65-74,
# :489-513): they decide which KV extents split and where
_LANE = 128


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _kv_capacity(d_p: int, sub: int) -> int:
    """Largest KV extent (multiple of ``sub``) the TPU unroll kernel holds."""
    lanes = max(d_p, _LANE)
    cap = 5184 * _LANE // lanes
    return max(sub, (cap // sub) * sub)


def _split_sub_kv(d_p: int) -> int:
    return min(2048, _kv_capacity(d_p, 8))


def _pick_block(s: int, target: int) -> int:
    """Largest block <= target (multiple of 8) minimizing pad waste."""
    if s <= target:
        return _cdiv(s, 8) * 8
    best, best_waste = target, (_cdiv(s, target) * target - s) / s
    for cand in range(target, target // 2, -8):
        waste = (_cdiv(s, cand) * cand - s) / s
        if waste < best_waste - 1e-9:
            best, best_waste = cand, waste
            if waste == 0:
                break
    return best


def split_part(sk: int, d: int) -> Optional[int]:
    """KV rows per part of the split-merge route for (sk, d), or None when
    the KV passes the resident test and runs whole."""
    d_p = _cdiv(d, 8) * 8
    sub = min(_pick_block(sk, 864), _kv_capacity(d_p, 8))
    if _cdiv(sk, sub) * sub <= _kv_capacity(d_p, sub):
        return None
    return _kv_capacity(d_p, _split_sub_kv(d_p))


def longkv_impl() -> str:
    impl = os.environ.get("MUSEV_FLASH_LONGKV", "carry")
    if impl not in ("carry", "split"):
        raise ValueError(f"MUSEV_FLASH_LONGKV={impl!r}: expected 'carry' or 'split'")
    return impl


def _chunk_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """Plain q-chunked attention (``_chunk_fwd``, attention.py:52-70): the
    output in q's dtype and the float32 natural-log lse (B, Sq, H), with
    logits bounded to (B, H, TRAIN_CHUNK, Sk)."""
    kt, vt = _heads_first(k), _heads_first(v)
    outs, lses = [], []
    for i in range(0, q.shape[1], TRAIN_CHUNK):
        logits = torch.matmul(_heads_first(q[:, i:i + TRAIN_CHUNK]), kt.transpose(-1, -2))
        logits.mul_(scale)
        lse = torch.logsumexp(logits, dim=-1)  # (B, H, chunk)
        p = logits.sub_(lse[..., None]).exp_()
        outs.append(torch.matmul(p, vt).transpose(1, 2))
        lses.append(lse.transpose(1, 2))
    return torch.cat(outs, dim=1).to(q.dtype), torch.cat(lses, dim=1)


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> contiguous float32 (B, H, S, D)."""
    return x.transpose(1, 2).to(torch.float32, memory_format=torch.contiguous_format)


def natural_lse(m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """log Σ exp(q kᵀ · scale) per row from the flash kernel's exp2-domain
    stats: m the row max of q kᵀ · scale · log2(e), l = Σ exp2(that - m)."""
    return (m + torch.log2(l)).mul_(math.log(2.0))


class MemEfficientAttention(torch.autograd.Function):
    """Exact attention whose backward holds one chunk of probabilities at a
    time (``_mem_efficient_sdpa``, attention.py:73-133).

    Forward on CUDA: one flash launch with softmax stats (bf16, the kernel's
    input rules), or with ``part`` one launch per KV part merged by
    ``attention_parts``; the kernel's exp2-domain stats give the natural-log
    ``lse = ln 2 * (m + log2 l)``. On the CPU: ``_chunk_fwd``, or the
    parts' plain stats merged alike. Saves only (q, k, v, out, lse). Backward (``_mem_sdpa_bwd``, :91-131), plain
    PyTorch in float32 (autocast off, also where the caller's backward runs
    under autocast) over chunks of TRAIN_CHUNK query rows (the last may
    be shorter: the JAX package pads q to a whole chunk, and padded rows
    add nothing to dk and dv): p = exp(q kᵀ · scale - lse), delta =
    Σ_d do·out, dv += pᵀ do, ds = p (do vᵀ - delta), dq = scale · ds k,
    dk += scale · dsᵀ q, with lse and delta subtracted inside the products
    (q and do carry them as an extra column against a column of ones on k
    and v). ``MemEfficientAttention.launches`` counts the forward's
    whole-KV kernel launches (the parts' count as
    ``flash_attention_parts.launches``).
    """

    launches = 0

    @staticmethod
    def forward(ctx, q, k, v, scale, part):
        with torch.autocast(q.device.type, enabled=False):
            if part is not None:
                o, m, l = attention_parts(q, k, v, scale, part)
                out, lse = o.to(q.dtype), natural_lse(m, l)
            elif q.device.type == "cuda":
                out, m, l = _launch(q, k, v, scale, with_stats=True)
                MemEfficientAttention.launches += 1
                lse = natural_lse(m, l)
            else:
                out, lse = _chunk_fwd(q, k, v, scale)
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        # float32 whatever autocast state the caller's backward runs under
        with torch.autocast(do.device.type, enabled=False):
            return MemEfficientAttention._backward(ctx, do)

    @staticmethod
    def _backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        scale = ctx.scale
        kt, vt = _heads_first(k), _heads_first(v)
        # a column of ones on k and v takes -lse and -delta into the products
        # below, so no pass over a (B, H, chunk, Sk) buffer broadcasts them
        ones = kt.new_ones(*kt.shape[:-1], 1)
        k1, v1 = torch.cat([kt, ones], -1), torch.cat([vt, ones], -1)
        delta = (do.float() * out.float()).sum(-1)  # (B, Sq, H)
        dk = torch.zeros_like(kt)
        dv = torch.zeros_like(vt)
        dq = torch.empty_like(q)
        for i in range(0, q.shape[1], TRAIN_CHUNK):
            rows = slice(i, i + TRAIN_CHUNK)
            qc, doc = _heads_first(q[:, rows]), _heads_first(do[:, rows])
            q1 = torch.cat([qc * scale, -lse[:, rows].transpose(1, 2)[..., None]], -1)
            do1 = torch.cat([doc, -delta[:, rows].transpose(1, 2)[..., None]], -1)
            # p = exp(scale * q k^T - lse) and ds / scale = p * (do v^T - delta),
            # each formed in place in one (B, H, chunk, Sk) float32 buffer
            p = torch.matmul(q1, k1.transpose(-1, -2)).exp_()
            dv.add_(torch.matmul(p.transpose(-1, -2), doc))
            ds = torch.matmul(do1, v1.transpose(-1, -2)).mul_(p)
            del p
            dq[:, rows] = torch.matmul(ds, kt).mul_(scale).transpose(1, 2).to(q.dtype)
            dk.add_(torch.matmul(ds.transpose(-1, -2), qc).mul_(scale))
        return (dq, dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype), None,
                None)


def mem_efficient_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: Optional[float] = None,
                       part: Optional[int] = None) -> torch.Tensor:
    """``MemEfficientAttention`` over (B, S, H, D) tensors (``_xla_chunked_sdpa``);
    ``part`` runs the forward over KV parts of that many rows."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return MemEfficientAttention.apply(q, k, v, float(scale), part)


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention over (B, S, H, D) tensors; under autograd the kernel
    wrappers take the training route themselves. Under a sequence-parallel
    axis (``parallel.context.sp_axis``) a self-attention site of at least
    ``FLASH_MIN_SEQ`` tokens, divisible by the axis size, runs as ring
    attention (ops/attention.py:180-196)."""
    sp = sp_axis()
    if (sp is not None and bias is None and q.shape[1] == k.shape[1]
            and q.shape[1] >= FLASH_MIN_SEQ):
        from ..parallel.mesh import axis_size
        from ..parallel.ring_attention import sp_sdpa

        n = axis_size(sp)
        if n > 1 and q.shape[1] % n == 0:
            return sp_sdpa(q, k, v, axis=sp, scale=scale)
    if bias is not None:
        return flash_attention_plain(q, k, v, scale=scale, bias=bias)
    if longkv_impl() == "split":
        part = split_part(k.shape[1], q.shape[-1])
        if part is not None:
            return flash_attention_parts(q, k, v, scale=scale, part=part)
    return flash_attention(q, k, v, scale=scale)
