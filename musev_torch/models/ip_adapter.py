"""IP-Adapter image projection: ``ImageProjModel``.

Counterpart of ``image_proj`` in ``musev_tpu/models/ip_adapter.py`` (the
tencent-ailab ip_adapter package as musev/models/ip_adapter_loader.py:43-44
loads it): one linear from the pooled CLIP image embedding to
``num_tokens`` cross-attention tokens, then LayerNorm. Keys ``proj`` and
``norm`` are those of the "image_proj" part of an ``ip_adapter.bin``. The
Resampler (IP-Adapter-Plus) and the FaceID ``MLPProjModel`` are not ported
yet.
"""

from __future__ import annotations

import torch
from torch import nn

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

