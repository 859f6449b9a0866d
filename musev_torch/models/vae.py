"""AutoencoderKL (SD1.5 VAE) with a segmented video codec.

Counterpart of ``musev_tpu/models/vae.py``. Encoding returns the latent
distribution's mean (reference ``latent_dist.mean``,
pipeline_controlnet.py:361-367); video decode/encode loop over time segments
so device memory stays flat for long videos (reference decoder_t_segment).
The mid-block attention (one head, d = 512) runs through ``ops.attention.sdpa``:
on CUDA, the flash kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa
from .common import Conv2d, GroupNorm
from .unet_blocks import ResnetBlock


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


def _resnet(in_c: int, out_c: int, groups: int) -> ResnetBlock:
    return ResnetBlock(in_c, out_c, None, groups, eps=1e-6)


class VAEAttention(nn.Module):
    """Single-head self-attention over the pixels, with residual."""

    def __init__(self, c: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, c, eps=1e-6)
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        y = self.group_norm(x).reshape(n, h * w, 1, c)
        o = sdpa(self.to_q(y), self.to_k(y), self.to_v(y))
        return self.to_out[0](o.reshape(n, h, w, c)) + x


class _MidBlock(nn.Module):
    def __init__(self, c: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([_resnet(c, c, groups), _resnet(c, c, groups)])
        self.attentions = nn.ModuleList([VAEAttention(c, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Stage(nn.Module):
    def __init__(self, in_c: int, out_c: int, n_layers: int, groups: int,
                 resample: str = ""):
        super().__init__()
        self.resnets = nn.ModuleList(
            [_resnet(in_c if j == 0 else out_c, out_c, groups) for j in range(n_layers)]
        )
        if resample == "down":
            self.downsamplers = nn.ModuleList([_Conv(out_c, stride=2, padding=0)])
        elif resample == "up":
            self.upsamplers = nn.ModuleList([_Conv(out_c)])


class _Conv(nn.Module):
    """Holds a resampling conv under the reference's ``.conv`` key."""

    def __init__(self, c: int, stride: int = 1, padding: int = 1):
        super().__init__()
        self.conv = Conv2d(c, c, 3, stride=stride, padding=padding)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chs, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = Conv2d(cfg.in_channels, chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList([
            _Stage(chs[max(i - 1, 0)], c, cfg.layers_per_block, g,
                   "down" if i < len(chs) - 1 else "")
            for i, c in enumerate(chs)
        ])
        self.mid_block = _MidBlock(chs[-1], g)
        self.conv_norm_out = GroupNorm(g, chs[-1], eps=1e-6)
        self.conv_out = Conv2d(chs[-1], 2 * cfg.latent_channels, 3, padding=1)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev, g = list(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        self.conv_in = Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _MidBlock(rev[0], g)
        self.up_blocks = nn.ModuleList([
            _Stage(rev[max(i - 1, 0)], c, cfg.layers_per_block + 1, g,
                   "up" if i < len(rev) - 1 else "")
            for i, c in enumerate(rev)
        ])
        self.conv_norm_out = GroupNorm(g, rev[-1], eps=1e-6)
        self.conv_out = Conv2d(rev[-1], cfg.out_channels, 3, padding=1)


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        lc = cfg.latent_channels
        self.quant_conv = Conv2d(2 * lc, 2 * lc, 1)
        self.post_quant_conv = Conv2d(lc, lc, 1)


def vae_encode(vae: AutoencoderKL, images: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) in [-1, 1] -> (N, H/8, W/8, 4) scaled latent means."""
    enc = vae.encoder
    x = enc.conv_in(images)
    for stage in enc.down_blocks:
        for res in stage.resnets:
            x = res(x)
        if hasattr(stage, "downsamplers"):
            # diffusers pads (0, 1) bottom/right before the stride-2 conv
            x = stage.downsamplers[0].conv(F.pad(x, (0, 0, 0, 1, 0, 1)))
    x = enc.mid_block(x)
    x = enc.conv_out(F.silu(enc.conv_norm_out(x)))
    mean = vae.quant_conv(x)[..., : vae.cfg.latent_channels]
    return mean * vae.cfg.scaling_factor


def vae_decode(vae: AutoencoderKL, latents: torch.Tensor) -> torch.Tensor:
    """(N, h, w, 4) scaled latents -> (N, 8h, 8w, 3) in [-1, 1]."""
    dec = vae.decoder
    x = vae.post_quant_conv(latents / vae.cfg.scaling_factor)
    x = dec.mid_block(dec.conv_in(x))
    for stage in dec.up_blocks:
        for res in stage.resnets:
            x = res(x)
        if hasattr(stage, "upsamplers"):
            x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            x = stage.upsamplers[0].conv(x)
    return dec.conv_out(F.silu(dec.conv_norm_out(x)))


def vae_decode_video(vae: AutoencoderKL, latents: torch.Tensor, segment: int = 16,
                     mesh=None, axis: Optional[str] = None) -> torch.Tensor:
    """(B, T, h, w, 4) -> (B, T, H, W, 3), decoded ``segment`` frames at a time.

    With ``mesh``/``axis`` (musev_tpu/models/vae.py:216-280) the frames are
    padded with copies of the last to a multiple of the axis size, each rank
    decodes its contiguous shard in ``segment``-frame chunks, so memory per
    device stays flat at any T, and the pixels are gathered on every rank
    with the padding cut. The VAE is per frame: nothing else crosses ranks."""
    from ..parallel.mesh import batch_sharding, replicated

    b, t = latents.shape[:2]
    flat = latents.reshape(b * t, *latents.shape[2:])
    if mesh is not None:
        flat = batch_sharding(flat, mesh, axis)
        segment = min(segment, flat.shape[0])
    out = torch.cat([vae_decode(vae, flat[s:s + segment])
                     for s in range(0, flat.shape[0], segment)])
    if mesh is not None:
        out = replicated(out, b * t, mesh, axis)
    return out.reshape(b, t, *out.shape[1:])


def vae_encode_video(vae: AutoencoderKL, frames: torch.Tensor,
                     segment: int = 16) -> torch.Tensor:
    """(B, T, H, W, 3) -> (B, T, h, w, 4)."""
    b, t = frames.shape[:2]
    flat = frames.reshape(b * t, *frames.shape[2:])
    out = torch.cat([vae_encode(vae, flat[s:s + segment]) for s in range(0, b * t, segment)])
    return out.reshape(b, t, *out.shape[1:])
