"""Sparse causal attention masks for temporal attention (a copy of
``musev_tpu/ops/attention_mask.py``; numpy only).

Reference: musev/utils/attention_util.py:29-74
(generate_sparse_causcal_attn_mask): each frame attends to itself, a band of
``n_near`` previous frames, and the first frame — the optional
``self_attn_mask`` mode of TransformerTemporalModel.
"""

from __future__ import annotations

import numpy as np


def sparse_causal_mask(
    num_frames: int,
    n_near: int = 1,
    attend_first: bool = True,
    dtype=np.float32,
) -> np.ndarray:
    """(T, T) additive mask: 0 where attending is allowed, -inf elsewhere."""
    allow = np.zeros((num_frames, num_frames), dtype=bool)
    for i in range(num_frames):
        lo = max(0, i - n_near)
        allow[i, lo : i + 1] = True
        if attend_first:
            allow[i, 0] = True
    mask = np.where(allow, 0.0, -np.inf).astype(dtype)
    return mask
