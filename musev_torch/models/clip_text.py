"""CLIP text encoder (SD1.5's clip-vit-large-patch14 topology).

Counterpart of ``musev_tpu/models/clip_text.py``: causal pre-LN transformer
with quick-gelu, returning the last hidden state. Submodules follow the
transformers ``CLIPTextModel`` keys (``text_model.encoder.layers.{i}...``).
The causal mask is an additive bias, so attention here is plain PyTorch math
on every device (``ops.attention.sdpa`` with a bias).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops.attention import sdpa
from .common import LayerNorm


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class _SelfAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)


class _MLP(nn.Module):
    def __init__(self, d: int, inner: int):
        super().__init__()
        self.fc1 = nn.Linear(d, inner)
        self.fc2 = nn.Linear(inner, d)


class _Layer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.layer_norm1 = LayerNorm(d, cfg.layer_norm_eps)
        self.self_attn = _SelfAttention(d)
        self.layer_norm2 = LayerNorm(d, cfg.layer_norm_eps)
        self.mlp = _MLP(d, cfg.intermediate_size)

    def forward(self, x: torch.Tensor, heads: int, bias: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        a = self.self_attn
        y = self.layer_norm1(x)
        q, k, v = (p(y).reshape(b, s, heads, -1) for p in (a.q_proj, a.k_proj, a.v_proj))
        x = x + a.out_proj(sdpa(q, k, v, bias=bias).reshape(b, s, -1))
        return x + self.mlp.fc2(quick_gelu(self.mlp.fc1(self.layer_norm2(x))))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([_Layer(cfg) for _ in range(cfg.num_layers)])


class _TextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = _TextModel(cfg)


def clip_text_encode(model: CLIPTextModel, input_ids: torch.Tensor) -> torch.Tensor:
    """(B, S) integer token ids -> (B, S, hidden) last hidden state."""
    tm = model.text_model
    emb = tm.embeddings
    s = input_ids.shape[1]
    ids = input_ids.clamp(0, emb.token_embedding.num_embeddings - 1)
    x = emb.token_embedding(ids) + emb.position_embedding.weight[None, :s]
    causal = torch.full((s, s), float("-inf"), device=x.device).triu(1)[None, None]
    for layer in tm.encoder.layers:
        x = layer(x, model.cfg.num_heads, causal)
    return tm.final_layer_norm(x)
