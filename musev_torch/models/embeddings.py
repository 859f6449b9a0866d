"""Sinusoidal time/frame embeddings (counterpart of ``musev_tpu/models/embeddings.py``).

diffusers ``Timesteps``/``TimestepEmbedding`` as MuseV instantiates them
(flip_sin_to_cos=True, downscale_freq_shift=0).
"""

from __future__ import annotations

import math

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
