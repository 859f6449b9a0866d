"""Adaptive instance normalization over ``(B, T, H, W, C)`` videos.

Counterpart of ``musev_tpu/ops/adain.py`` (reference data_util.py:499-602):
generated frames are renormalized to the per-(batch, channel) statistics of the
vision-condition frames over (T, H, W), biased variance floored at ``eps``,
all in float32.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .index_ops import splice_with_index, take_frames


def adain(src: torch.Tensor, dst: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    s, d = src.float(), dst.float()
    dims = (1, 2, 3)
    var, mean = torch.var_mean(s, dim=dims, correction=0, keepdim=True)
    var_d, mean_d = torch.var_mean(d, dim=dims, correction=0, keepdim=True)
    std = torch.sqrt(torch.clamp(var, min=eps))
    std_d = torch.sqrt(torch.clamp(var_d, min=eps))
    return ((s - mean) / std * std_d + mean_d).to(src.dtype)


def adain_to_condition_frames(
    x: torch.Tensor, gen_index: Sequence[int], cond_index: Sequence[int], eps: float = 1e-6
) -> torch.Tensor:
    """AdaIN the generated frames of ``x`` to the condition frames and re-splice."""
    src = take_frames(x, gen_index)
    dst = take_frames(x, cond_index)
    return splice_with_index(adain(src, dst, eps), gen_index, dst, cond_index)
