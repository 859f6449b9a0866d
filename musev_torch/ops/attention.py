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
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .kernels.flash_attention import (
    flash_attention,
    flash_attention_parts,
    flash_attention_plain,
)

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


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention over (B, S, H, D) tensors."""
    if bias is not None:
        return flash_attention_plain(q, k, v, scale=scale, bias=bias)
    if longkv_impl() == "split":
        part = split_part(k.shape[1], q.shape[-1])
        if part is not None:
            return flash_attention_parts(q, k, v, scale=scale, part=part)
    return flash_attention(q, k, v, scale=scale)
