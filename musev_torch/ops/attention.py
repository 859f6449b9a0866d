"""Scaled-dot-product attention dispatch over ``(B, S, H, D)`` tensors.

Counterpart of ``musev_tpu/ops/attention.py:sdpa``. One rule, no fallback:

* a CPU tensor takes the plain PyTorch math (``flash_attention_plain``);
* a CUDA tensor with no bias goes to the hand-written flash kernel
  (``ops.kernels.flash_attention``): spatial self-attention, both
  ReferenceOnly halves, cross-attention over the text tokens and the VAE
  mid-block;
* a CUDA tensor with a bias (CLIP's causal mask) stays plain PyTorch math,
  as the JAX package leaves it to XLA.

``F.scaled_dot_product_attention`` is used on no path.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernels.flash_attention import flash_attention, flash_attention_plain


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention over (B, S, H, D) tensors."""
    if bias is None:
        return flash_attention(q, k, v, scale=scale)
    return flash_attention_plain(q, k, v, scale=scale, bias=bias)
