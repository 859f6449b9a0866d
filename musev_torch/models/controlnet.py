"""ControlNet and PoseGuider (counterpart of ``musev_tpu/models/controlnet.py``).

The ControlNet is the diffusers ControlNetModel that MuseV's pose path loads
(pipeline_controlnet.py:2022-2038): a conditioning-embedding stem (strided
convs) added to conv_in's output, the SD1.5 down and mid trunk (the
ReferenceNet's, built by the same class), and one 1x1 "zero" conv per skip
feature plus one for the mid block. Its outputs, the 12 down residuals and
the mid residual scaled by ``conditioning_scale``, are added to the UNet's
skips and mid block. The PoseGuider is the stem alone, stored as the
reference's InflatedConv3d layers (kernels (O, I, 1, k, k)); its output is
added to the UNet's conv_in activations (pipeline_controlnet.py:1774-1783).
Module names are the reference torch keys.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import Conv2d
from .referencenet import ReferenceNet2D, trunk_apply


@dataclasses.dataclass(frozen=True)
class ControlNetConfig:
    in_channels: int = 4
    cond_channels: int = 3
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    cond_embed_channels: Tuple[int, ...] = (16, 32, 96, 256)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_heads: int = 8
    norm_num_groups: int = 32
    norm_eps: float = 1e-5

    @property
    def temb_dim(self) -> int:
        return self.block_out_channels[0] * 4


class InflatedConv2d(nn.Conv3d):
    """A 2-D conv kept as the reference's InflatedConv3d (kernel (1, k, k)),
    applied to channels-last ``(N, H, W, C)`` frames."""

    def __init__(self, in_c: int, out_c: int, k: int, stride: int = 1, padding: int = 0):
        super().__init__(in_c, out_c, (1, k, k), stride=(1, stride, stride),
                         padding=(0, padding, padding))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight[:, :, 0], self.bias,
                     self.stride[1:], self.padding[1:])
        return y.permute(0, 2, 3, 1).contiguous()


class CondEmbedding(nn.Module):
    """conv_in, (conv, strided conv) pairs as ``blocks``, conv_out; SiLU
    after every conv but the last. (N, H, W, 3) in [0, 1] -> (N, H/8, W/8,
    out_c) for three pairs."""

    def __init__(self, cfg: ControlNetConfig, out_c: int, conv=Conv2d):
        super().__init__()
        chs = cfg.cond_embed_channels
        self.conv_in = conv(cfg.cond_channels, chs[0], 3, padding=1)
        self.blocks = nn.ModuleList()
        for c_in, c_out in zip(chs[:-1], chs[1:]):
            self.blocks.append(conv(c_in, c_in, 3, padding=1))
            self.blocks.append(conv(c_in, c_out, 3, stride=2, padding=1))
        self.conv_out = conv(chs[-1], out_c, 3, padding=1)

    def forward(self, cond_image: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.conv_in(cond_image))
        for conv in self.blocks:
            x = F.silu(conv(x))
        return self.conv_out(x)


class ControlNet(ReferenceNet2D):
    """The SD1.5 down and mid trunk with the conditioning stem and zero convs."""

    def __init__(self, cfg: ControlNetConfig):
        super().__init__(cfg)
        chs = cfg.block_out_channels
        self.controlnet_cond_embedding = CondEmbedding(cfg, chs[0])
        skip_cs = [chs[0]]
        for i, c in enumerate(chs):
            skip_cs += [c] * (cfg.layers_per_block + (i < len(chs) - 1))
        self.controlnet_down_blocks = nn.ModuleList([Conv2d(c, c, 1) for c in skip_cs])
        self.controlnet_mid_block = Conv2d(chs[-1], chs[-1], 1)


def controlnet_apply(
    net: ControlNet,
    sample: torch.Tensor,
    timestep,
    encoder_hidden_states: torch.Tensor,
    cond_image: torch.Tensor,
    conditioning_scale: float = 1.0,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Run the control trunk.

    sample (N, h, w, 4) latent frames; cond_image (N, 8h, 8w, 3) in [0, 1];
    encoder_hidden_states (N, S, D); timestep a scalar. Returns the 12 down
    residuals and the mid residual, each scaled by ``conditioning_scale``.
    """
    x = net.conv_in(sample)
    x = x + net.controlnet_cond_embedding(cond_image.to(x.dtype))
    feats, mid = trunk_apply(net, x, timestep, encoder_hidden_states)
    down = [zc(f) * conditioning_scale for zc, f in zip(net.controlnet_down_blocks, feats)]
    return down, net.controlnet_mid_block(mid) * conditioning_scale


class PoseGuider(CondEmbedding):
    """The conditioning stem alone (Moore-AnimateAnyone PoseGuider, reference
    musev/models/controlnet.py:326-371), in InflatedConv3d layers; its
    output width is the UNet's conv_in width, ``block_out_channels[0]``."""

    def __init__(self, cfg: ControlNetConfig):
        super().__init__(cfg, cfg.block_out_channels[0], conv=InflatedConv2d)
        self.cfg = cfg


def pose_guider_apply(net: PoseGuider, cond_image: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) in [0, 1] -> (N, H/8, W/8, block_out_channels[0])."""
    return net(cond_image.to(net.conv_in.weight.dtype))
