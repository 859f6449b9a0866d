"""CLIP vision transformer, the IP-Adapter image encoder.

Counterpart of ``musev_tpu/models/clip_vision.py`` (transformers
``CLIPVisionModelWithProjection``, ViT-H/14 by default): pre-LN transformer
with quick-gelu over a class token and 14x14 patches, returning the last
hidden state and the projected pooled embedding that ``ImageProjModel``
consumes. Module names are the transformers keys. Its self-attention has no
mask, so on CUDA it runs on the flash kernel through ``ops.attention.sdpa``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa
from .clip_text import _MLP, _SelfAttention, quick_gelu
from .common import LayerNorm

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1280
    num_layers: int = 32
    num_heads: int = 16
    intermediate_size: int = 5120
    projection_dim: int = 1024
    layer_norm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.patch_embedding = nn.Conv2d(3, d, cfg.patch_size, stride=cfg.patch_size,
                                         bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.position_embedding = nn.Embedding(cfg.num_patches + 1, d)


class _Layer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.layer_norm1 = LayerNorm(d, cfg.layer_norm_eps)
        self.self_attn = _SelfAttention(d)
        self.layer_norm2 = LayerNorm(d, cfg.layer_norm_eps)
        self.mlp = _MLP(d, cfg.intermediate_size)

    def forward(self, x: torch.Tensor, heads: int) -> torch.Tensor:
        b, s, _ = x.shape
        a = self.self_attn
        y = self.layer_norm1(x)
        q, k, v = (p(y).reshape(b, s, heads, -1) for p in (a.q_proj, a.k_proj, a.v_proj))
        x = x + a.out_proj(sdpa(q, k, v).reshape(b, s, -1))
        return x + self.mlp.fc2(quick_gelu(self.mlp.fc1(self.layer_norm2(x))))


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList([_Layer(cfg) for _ in range(cfg.num_layers)])


class _VisionModel(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.embeddings = _Embeddings(cfg)
        self.pre_layrnorm = LayerNorm(d, cfg.layer_norm_eps)  # the checkpoints' spelling
        self.encoder = _Encoder(cfg)
        self.post_layernorm = LayerNorm(d, cfg.layer_norm_eps)


class CLIPVisionModel(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.vision_model = _VisionModel(cfg)
        self.visual_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)


def clip_vision_encode(
    model: CLIPVisionModel, pixels: torch.Tensor, penultimate: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, 3) normalized pixels -> (hidden_states (B, 1 + P, D),
    projected pooled embedding (B, projection_dim)). ``penultimate``: the
    hidden states are those that enter the last layer (the IP-Adapter-Plus
    image tokens); the pooled embedding is the last layer's either way."""
    vm = model.vision_model
    emb = vm.embeddings
    b = pixels.shape[0]
    w = emb.patch_embedding.weight
    patches = F.conv2d(pixels.permute(0, 3, 1, 2).to(w.dtype), w,
                       stride=emb.patch_embedding.stride)
    tokens = patches.flatten(2).transpose(1, 2)  # (B, P, D), row-major patches
    cls = emb.class_embedding.to(tokens.dtype).expand(b, 1, -1)
    x = torch.cat([cls, tokens], dim=1)
    x = x + emb.position_embedding.weight[None, : x.shape[1]].to(x.dtype)
    x = vm.pre_layrnorm(x)
    hidden = None
    for i, layer in enumerate(vm.encoder.layers):
        if penultimate and i == len(vm.encoder.layers) - 1:
            hidden = x
        x = layer(x, model.cfg.num_heads)
    pooled = vm.post_layernorm(x[:, 0])
    return x if hidden is None else hidden, model.visual_projection(pooled)


def preprocess_clip_image(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """(B, H, W, 3) in [0, 255] -> normalized (B, size, size, 3) float32:
    antialiased bilinear resize, as ``jax.image.resize(..., "bilinear")``."""
    x = images.float().permute(0, 3, 1, 2) / 255.0
    x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                      antialias=True)
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=x.device)
    std = torch.tensor(CLIP_IMAGE_STD, device=x.device)
    return (x.permute(0, 2, 3, 1) - mean) / std
