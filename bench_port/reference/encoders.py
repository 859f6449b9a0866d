"""CLIP text and vision encoders, the IP-Adapter projection and the SD VAE,
as plain equations.

CLIP (transformers ``CLIPTextModel`` / ``CLIPVisionModelWithProjection``
keys): pre-LN transformers with quick-GELU; the text model is causal and
returns its last hidden state, the vision model returns the projected
pooled class token. IP-Adapter ``ImageProjModel`` (tencent-ailab
ip_adapter): one linear to ``tokens`` x ``cross_dim``, then LayerNorm. The
VAE is diffusers' ``AutoencoderKL`` (SD1.5): encoding returns the scaled
mean of the latent distribution, the decoder is nearest-neighbour upsampling
with resnets and one single-head attention in each mid block.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, GroupNorm, LayerNorm, Linear, NumericsUser, attention
from .unet import ResnetBlock

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class ClipSizes:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    vocab_size: int = 49408  # text
    max_positions: int = 77  # text
    image_size: int = 224  # vision
    patch_size: int = 14  # vision
    projection_dim: int = 1024  # vision


class _SelfAttention(NumericsUser):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj, self.k_proj = Linear(d, d), Linear(d, d)
        self.v_proj, self.out_proj = Linear(d, d), Linear(d, d)


class _MLP(nn.Module):
    def __init__(self, d: int, inner: int):
        super().__init__()
        self.fc1, self.fc2 = Linear(d, inner), Linear(inner, d)


class _Layer(nn.Module):
    def __init__(self, s: ClipSizes):
        super().__init__()
        d = s.hidden_size
        self.heads = s.num_heads
        self.layer_norm1, self.layer_norm2 = LayerNorm(d), LayerNorm(d)
        self.self_attn = _SelfAttention(d)
        self.mlp = _MLP(d, s.intermediate_size)

    def forward(self, x, bias=None):
        n, s, _ = x.shape
        a = self.self_attn
        y = self.layer_norm1(x)
        q, k, v = (p(y).reshape(n, s, self.heads, -1) for p in (a.q_proj, a.k_proj, a.v_proj))
        x = x + a.out_proj(attention(a.numerics, q, k, v, bias).reshape(n, s, -1))
        h = self.mlp.fc1(self.layer_norm2(x))
        return x + self.mlp.fc2(h * torch.sigmoid(1.702 * h))


class _Layers(nn.Module):
    def __init__(self, s: ClipSizes):
        super().__init__()
        self.layers = nn.ModuleList([_Layer(s) for _ in range(s.num_layers)])


class _TextEmbeddings(nn.Module):
    def __init__(self, s: ClipSizes):
        super().__init__()
        self.token_embedding = nn.Embedding(s.vocab_size, s.hidden_size)
        self.position_embedding = nn.Embedding(s.max_positions, s.hidden_size)


class _TextModel(nn.Module):
    def __init__(self, s: ClipSizes):
        super().__init__()
        self.embeddings = _TextEmbeddings(s)
        self.encoder = _Layers(s)
        self.final_layer_norm = LayerNorm(s.hidden_size)


class CLIPText(nn.Module):
    def __init__(self, s: ClipSizes):
        super().__init__()
        self.text_model = _TextModel(s)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, S) token ids -> (B, S, D) last hidden state."""
        tm = self.text_model
        s = ids.shape[1]
        x = tm.embeddings.token_embedding.weight.float()[ids]
        x = x + tm.embeddings.position_embedding.weight.float()[None, :s]
        causal = torch.full((s, s), float("-inf"), device=x.device).triu(1)[None, None]
        for layer in tm.encoder.layers:
            x = layer(x, causal)
        return tm.final_layer_norm(x)


class _VisionEmbeddings(nn.Module):
    def __init__(self, s: ClipSizes):
        super().__init__()
        d = s.hidden_size
        self.patch_embedding = nn.Conv2d(3, d, s.patch_size, stride=s.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.position_embedding = nn.Embedding((s.image_size // s.patch_size) ** 2 + 1, d)


class _VisionModel(nn.Module):
    def __init__(self, s: ClipSizes):
        super().__init__()
        self.embeddings = _VisionEmbeddings(s)
        self.pre_layrnorm = LayerNorm(s.hidden_size)
        self.encoder = _Layers(s)
        self.post_layernorm = LayerNorm(s.hidden_size)


class CLIPVision(NumericsUser):
    def __init__(self, s: ClipSizes):
        super().__init__()
        self.s = s
        self.vision_model = _VisionModel(s)
        self.visual_projection = Linear(s.hidden_size, s.projection_dim, bias=False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) in [0, 255] -> (N, projection_dim): an antialiased
        bilinear resize to the model's size, CLIP's normalisation, patches,
        the class token, the layers, the pooled class token projected."""
        vm, s = self.vision_model, self.s
        x = images.float().permute(0, 3, 1, 2) / 255.0
        x = F.interpolate(x, size=(s.image_size, s.image_size), mode="bilinear",
                          align_corners=False, antialias=True)
        mean = torch.tensor(CLIP_MEAN, device=x.device)[:, None, None]
        std = torch.tensor(CLIP_STD, device=x.device)[:, None, None]
        x = (x - mean) / std
        emb = vm.embeddings
        q = self.numerics.q
        tokens = F.conv2d(q(x), q(emb.patch_embedding.weight), stride=s.patch_size)
        tokens = tokens.flatten(2).transpose(1, 2)
        cls = emb.class_embedding.float().expand(tokens.shape[0], 1, -1)
        h = torch.cat([cls, tokens], dim=1) + emb.position_embedding.weight.float()[None]
        h = vm.pre_layrnorm(h)
        for layer in vm.encoder.layers:
            h = layer(h)
        return self.visual_projection(vm.post_layernorm(h[:, 0]))


class ImageProj(nn.Module):
    """IP-Adapter ImageProjModel: (N, clip_dim) -> (N, tokens, cross_dim)."""

    def __init__(self, clip_dim: int = 1024, cross_dim: int = 768, tokens: int = 4):
        super().__init__()
        self.proj = Linear(clip_dim, cross_dim * tokens)
        self.norm = LayerNorm(cross_dim)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        x = self.proj(emb)
        return self.norm(x.reshape(x.shape[0], -1, self.norm.weight.shape[0]))


@dataclasses.dataclass(frozen=True)
class VAESizes:
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


class _VAEAttention(NumericsUser):
    def __init__(self, c: int, g: int):
        super().__init__()
        self.group_norm = GroupNorm(g, c, 1e-6)
        self.to_q, self.to_k, self.to_v = Linear(c, c), Linear(c, c), Linear(c, c)
        self.to_out = nn.ModuleList([Linear(c, c)])

    def forward(self, x):
        n, h, w, c = x.shape
        y = self.group_norm(x).reshape(n, h * w, 1, c)
        o = attention(self.numerics, self.to_q(y), self.to_k(y), self.to_v(y))
        return self.to_out[0](o.reshape(n, h, w, c)) + x


class _Mid(nn.Module):
    def __init__(self, c: int, g: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(c, c, None, g, 1e-6),
                                      ResnetBlock(c, c, None, g, 1e-6)])
        self.attentions = nn.ModuleList([_VAEAttention(c, g)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Conv(nn.Module):
    def __init__(self, c: int, stride: int = 1, padding: int = 1):
        super().__init__()
        self.conv = Conv2d(c, c, 3, stride=stride, padding=padding)


class _Stage(nn.Module):
    def __init__(self, cin: int, c: int, n: int, g: int, resample: str = ""):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(cin if j == 0 else c, c, None, g, 1e-6)
                                      for j in range(n)])
        if resample == "down":
            self.downsamplers = nn.ModuleList([_Conv(c, 2, 0)])
        elif resample == "up":
            self.upsamplers = nn.ModuleList([_Conv(c)])


class _Encoder(nn.Module):
    def __init__(self, s: VAESizes):
        super().__init__()
        chs, g = s.block_out_channels, s.norm_num_groups
        self.conv_in = Conv2d(3, chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList([
            _Stage(chs[max(i - 1, 0)], c, s.layers_per_block, g,
                   "down" if i < len(chs) - 1 else "") for i, c in enumerate(chs)])
        self.mid_block = _Mid(chs[-1], g)
        self.conv_norm_out = GroupNorm(g, chs[-1], 1e-6)
        self.conv_out = Conv2d(chs[-1], 2 * s.latent_channels, 3, padding=1)


class _Decoder(nn.Module):
    def __init__(self, s: VAESizes):
        super().__init__()
        rev, g = list(reversed(s.block_out_channels)), s.norm_num_groups
        self.conv_in = Conv2d(s.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _Mid(rev[0], g)
        self.up_blocks = nn.ModuleList([
            _Stage(rev[max(i - 1, 0)], c, s.layers_per_block + 1, g,
                   "up" if i < len(rev) - 1 else "") for i, c in enumerate(rev)])
        self.conv_norm_out = GroupNorm(g, rev[-1], 1e-6)
        self.conv_out = Conv2d(rev[-1], 3, 3, padding=1)


class VAE(nn.Module):
    def __init__(self, s: VAESizes):
        super().__init__()
        self.s = s
        self.encoder, self.decoder = _Encoder(s), _Decoder(s)
        lc = s.latent_channels
        self.quant_conv = Conv2d(2 * lc, 2 * lc, 1)
        self.post_quant_conv = Conv2d(lc, lc, 1)

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) in [-1, 1] -> (N, H/8, W/8, 4) scaled latent means."""
        enc = self.encoder
        x = enc.conv_in(images.float())
        for stage in enc.down_blocks:
            for res in stage.resnets:
                x = res(x)
            if hasattr(stage, "downsamplers"):
                x = stage.downsamplers[0].conv(F.pad(x, (0, 0, 0, 1, 0, 1)))
        x = enc.conv_out(F.silu(enc.conv_norm_out(enc.mid_block(x))))
        return self.quant_conv(x)[..., :self.s.latent_channels] * self.s.scaling_factor

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """(N, h, w, 4) scaled latents -> (N, 8h, 8w, 3) in about [-1, 1]."""
        dec = self.decoder
        x = self.post_quant_conv(latents.float() / self.s.scaling_factor)
        x = dec.mid_block(dec.conv_in(x))
        for stage in dec.up_blocks:
            for res in stage.resnets:
                x = res(x)
            if hasattr(stage, "upsamplers"):
                x = stage.upsamplers[0].conv(x.repeat_interleave(2, 1).repeat_interleave(2, 2))
        return dec.conv_out(F.silu(dec.conv_norm_out(x)))
