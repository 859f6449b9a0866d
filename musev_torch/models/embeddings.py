"""Sinusoidal time/frame embeddings and the 2D sin-cos position grid
(counterpart of ``musev_tpu/models/embeddings.py``).

diffusers ``Timesteps``/``TimestepEmbedding`` as MuseV instantiates them
(flip_sin_to_cos=True, downscale_freq_shift=0), and MuseV's spatial sin-cos
grid with optional length normalization (musev/models/embeddings.py:24-52),
which ``TimestepEmbedding`` projects for the temporal transformers.
"""

from __future__ import annotations

import math

import numpy as np

import torch
import torch.nn.functional as F
from torch import nn


def sinusoidal_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """(N,) -> (N, dim) in float32, [cos | sin] with max period 10000."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device
    ) / half
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


class TimestepEmbedding(nn.Module):
    """linear -> silu -> linear (keys ``linear_1``, ``linear_2``)."""

    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, embed_dim)
        self.linear_2 = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


def get_2d_sincos_pos_embed(
    embed_dim: int,
    grid_h: int,
    grid_w: int,
    norm_length: bool = False,
    max_length: int = 2048,
) -> np.ndarray:
    """(H*W, embed_dim) float32 numpy, reference musev/models/embeddings.py:24-52
    (a copy of the JAX package's): positions 0..n-1, or spread over
    [0, max_length] with ``norm_length``; [sin | cos] of the w-major grid
    row, then of its column."""
    if norm_length and grid_h <= max_length and grid_w <= max_length:
        h = np.linspace(0, max_length, grid_h)
        w = np.linspace(0, max_length, grid_w)
    else:
        h = np.arange(grid_h, dtype=np.float32)
        w = np.arange(grid_w, dtype=np.float32)
    grid = np.meshgrid(w, h)  # w goes first, like the reference
    grid = np.stack(grid, axis=0).reshape([2, 1, grid_h, grid_w])

    def _1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000**omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    emb_h = _1d(embed_dim // 2, grid[0])
    emb_w = _1d(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)
