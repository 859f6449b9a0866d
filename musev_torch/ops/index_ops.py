"""Frame-index algebra for vision-conditioned denoising.

Counterpart of the parts of ``musev_tpu/ops/index_ops.py`` that the UNet and
the serial-denoise carry use (reference musev/data/data_util.py:242-681).
Videos are ``(B, T, H, W, C)``; the time axis defaults to 1. Indices are
static Python sequences.
"""

from __future__ import annotations

from typing import Sequence

import torch


def take_frames(x: torch.Tensor, index: Sequence[int], axis: int = 1) -> torch.Tensor:
    idx = torch.as_tensor(list(index), dtype=torch.long, device=x.device)
    return torch.index_select(x, axis, idx)


def splice_with_index(
    data1: torch.Tensor,
    data1_index: Sequence[int],
    data2: torch.Tensor,
    data2_index: Sequence[int],
    axis: int = 1,
) -> torch.Tensor:
    """Merge two tensors along ``axis``: ``out[..., data1_index[i], ...] =
    data1[..., i, ...]`` and likewise for data2 (reference
    concat_two_tensor_with_index, data_util.py:242-268)."""
    shape = list(data1.shape)
    shape[axis] = data1.shape[axis] + data2.shape[axis]
    out = data1.new_zeros(shape)
    for data, index in ((data1, data1_index), (data2, data2_index)):
        idx = torch.as_tensor(list(index), dtype=torch.long, device=out.device)
        out.index_copy_(axis, idx, data.to(out.dtype))
    return out


def frame_mask(
    num_frames: int, zero_index: Sequence[int], dtype=torch.float32, device=None
) -> torch.Tensor:
    """``(num_frames,)``: 0 at ``zero_index``, 1 elsewhere."""
    mask = torch.ones(num_frames, dtype=dtype, device=device)
    mask[list(zero_index)] = 0
    return mask


def fuse_part_tensor(
    src: torch.Tensor,
    dst: torch.Tensor,
    overlap: int,
    weight: float = 0.5,
    skip_step: int = 0,
    axis: int = 1,
) -> torch.Tensor:
    """Blend the last ``overlap`` frames of ``src`` into frames
    ``[skip_step, skip_step + overlap)`` of ``dst``; returns a new tensor
    (serial-denoise carry, reference fuse_part_tensor, data_util.py:655-681)."""
    if overlap == 0:
        return dst
    tail = src.narrow(axis, src.shape[axis] - overlap, overlap).to(dst.dtype)
    out = dst.clone()
    part = out.narrow(axis, skip_step, overlap)
    part.copy_(weight * tail + (1.0 - weight) * part)
    return out
