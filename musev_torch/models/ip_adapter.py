"""IP-Adapter image projections: ``ImageProjModel``, ``Resampler``, ``MLPProjModel``.

Counterpart of ``musev_tpu/models/ip_adapter.py`` (the tencent-ailab
ip_adapter package as musev/models/ip_adapter_loader.py:43-44 and
ip_adapter_face_loader.py:36-38 load it). Each maps a CLIP-vision or face
embedding to the cross-attention tokens of the UNet's dual-KV branches:

- ``ImageProjModel`` ("IPAdapter"): one linear from the pooled CLIP image
  embedding to ``num_tokens`` tokens, then LayerNorm;
- ``Resampler`` ("IPAdapterPlus", "IPAdapterPlus-face"): a perceiver
  readout of ``num_queries`` learned latents over the penultimate layer's
  patch tokens; its feed-forward uses tanh GELU, as ``jax.nn.gelu``'s
  default in the JAX package (ROADMAP queue 3, GELU);
- ``MLPProjModel`` (IPAdapterFaceID): Linear, exact GELU, Linear, LayerNorm
  from an insightface identity embedding.

Module names are the keys of the "image_proj" part of the published
``ip_adapter.bin`` files.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops.attention import sdpa
from .common import LayerNorm


class ImageProjModel(nn.Module):
    def __init__(self, clip_dim: int = 1024, cross_dim: int = 768, num_tokens: int = 4):
        super().__init__()
        self.proj = nn.Linear(clip_dim, cross_dim * num_tokens)
        self.norm = LayerNorm(cross_dim)

    def forward(self, image_emb: torch.Tensor) -> torch.Tensor:
        """(B, clip_dim) -> (B, num_tokens, cross_dim)."""
        x = self.proj(image_emb)
        return self.norm(x.reshape(x.shape[0], -1, self.norm.weight.shape[0]))


class MLPProjModel(nn.Module):
    def __init__(self, id_dim: int = 512, cross_dim: int = 768, num_tokens: int = 4):
        super().__init__()
        self.proj = nn.Sequential(nn.Linear(id_dim, id_dim * 2), nn.GELU(),
                                  nn.Linear(id_dim * 2, cross_dim * num_tokens))
        self.norm = LayerNorm(cross_dim)

    def forward(self, id_emb: torch.Tensor) -> torch.Tensor:
        """(B, id_dim) -> (B, num_tokens, cross_dim)."""
        x = self.proj(id_emb)
        return self.norm(x.reshape(x.shape[0], -1, self.norm.weight.shape[0]))


@dataclasses.dataclass(frozen=True)
class ResamplerConfig:
    dim: int = 1024
    depth: int = 4
    heads: int = 12
    num_queries: int = 16
    embedding_dim: int = 1280  # CLIP ViT-H hidden size
    output_dim: int = 768
    ff_mult: int = 4


class _PerceiverAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.norm1 = LayerNorm(dim)  # the media (image tokens)
        self.norm2 = LayerNorm(dim)  # the latents
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_kv = nn.Linear(dim, dim * 2, bias=False)
        self.to_out = nn.Linear(dim, dim, bias=False)

    def forward(self, x: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
        """Queries from the latents; keys and values from [media; latents],
        the two halves of one ``to_kv`` product."""
        lat = self.norm2(latents)
        q = self.to_q(lat).unflatten(-1, (self.heads, -1))
        k, v = self.to_kv(torch.cat([self.norm1(x), lat], dim=1)).chunk(2, dim=-1)
        k, v = (t.unflatten(-1, (self.heads, -1)) for t in (k, v))
        return self.to_out(sdpa(q, k, v).flatten(2))


class Resampler(nn.Module):
    def __init__(self, cfg: ResamplerConfig = ResamplerConfig()):
        super().__init__()
        self.cfg = cfg
        d, inner = cfg.dim, cfg.dim * cfg.ff_mult
        self.latents = nn.Parameter(torch.randn(1, cfg.num_queries, d) / d**0.5)
        self.proj_in = nn.Linear(cfg.embedding_dim, d)
        self.proj_out = nn.Linear(d, cfg.output_dim)
        self.norm_out = LayerNorm(cfg.output_dim)
        self.layers = nn.ModuleList([
            nn.ModuleList([_PerceiverAttention(d, cfg.heads), nn.Sequential(
                LayerNorm(d), nn.Linear(d, inner, bias=False), nn.GELU(approximate="tanh"),
                nn.Linear(inner, d, bias=False))])
            for _ in range(cfg.depth)
        ])

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S, embedding_dim) patch tokens -> (B, num_queries, output_dim)."""
        x = self.proj_in(tokens)
        lat = self.latents.to(x.dtype).expand(x.shape[0], -1, -1)
        for attn, ff in self.layers:
            lat = lat + attn(x, lat)
            lat = lat + ff(lat)
        return self.norm_out(self.proj_out(lat))
