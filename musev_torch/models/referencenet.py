"""ReferenceNet2D: an SD UNet trunk that emits its intermediate features.

Counterpart of ``musev_tpu/models/referencenet.py`` (reference
musev/models/referencenet.py): conv_in, the down blocks and the mid block of
a 2D UNet. With block embeddings only, the reference prunes the decoder head
(referencenet.py:624-636), so the up blocks are built only under
``need_self_attn_embs``, whose write mode records every spatial block's
normalised self-attention input (attention.py:242-259): the 6 down, 1 mid
and 9 up sites of SD1.5, in that order. Module names are the reference torch
keys.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn

from .common import Conv2d
from .embeddings import TimestepEmbedding, sinusoidal_embedding
from .unet_blocks import Downsample, ResnetBlock, SpatialTransformer, Upsample


@dataclasses.dataclass(frozen=True)
class ReferenceNetConfig:
    in_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_heads: int = 8
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    need_self_attn_embs: bool = False

    @property
    def temb_dim(self) -> int:
        return self.block_out_channels[0] * 4


class _Block(nn.Module):
    def __init__(self, cfg: ReferenceNetConfig, in_c, out_c: int, n: int, attn: bool):
        """``in_c``: the first resnet's input width, or every resnet's as a list."""
        super().__init__()
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        ins = in_c if isinstance(in_c, list) else [in_c] + [out_c] * (n - 1)
        self.resnets = nn.ModuleList([ResnetBlock(c, out_c, cfg.temb_dim, g, eps) for c in ins])
        if attn:
            self.attentions = nn.ModuleList([
                SpatialTransformer(out_c, cfg.cross_attention_dim, cfg.attention_heads, g)
                for _ in range(n)
            ])


class ReferenceNet2D(nn.Module):
    def __init__(self, cfg: ReferenceNetConfig):
        super().__init__()
        self.cfg = cfg
        chs = cfg.block_out_channels
        self.conv_in = Conv2d(cfg.in_channels, chs[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(chs[0], cfg.temb_dim)
        self.down_blocks = nn.ModuleList()
        out_c = chs[0]
        for i, c in enumerate(chs):
            last = i == len(chs) - 1  # SD1.5: the last down block has no attention
            block = _Block(cfg, out_c, c, cfg.layers_per_block, not last)
            if not last:
                block.downsamplers = nn.ModuleList([Downsample(c)])
            self.down_blocks.append(block)
            out_c = c
        self.mid_block = _Block(cfg, chs[-1], chs[-1], 2, False)
        self.mid_block.attentions = nn.ModuleList([
            SpatialTransformer(chs[-1], cfg.cross_attention_dim, cfg.attention_heads,
                               cfg.norm_num_groups)
        ])
        # the decoder, for the up blocks' self-attention sites (a ControlNet's
        # config has no such field)
        if getattr(cfg, "need_self_attn_embs", False):
            skips = [chs[0]]
            for i, c in enumerate(chs):
                skips += [c] * (cfg.layers_per_block + (i < len(chs) - 1))
            self.up_blocks = nn.ModuleList()
            prev = chs[-1]
            for i, c in enumerate(reversed(chs)):  # SD1.5: the first up block has no attention
                n = cfg.layers_per_block + 1
                ins = [(prev if j == 0 else c) + skips.pop() for j in range(n)]
                block = _Block(cfg, ins, c, n, i > 0)
                if i < len(chs) - 1:
                    block.upsamplers = nn.ModuleList([Upsample(c)])
                self.up_blocks.append(block)
                prev = c


def _temb(net: ReferenceNet2D, x: torch.Tensor, timestep) -> torch.Tensor:
    ts = torch.as_tensor(timestep, dtype=torch.float32, device=x.device).reshape(-1)
    ch0 = net.cfg.block_out_channels[0]
    return net.time_embedding(sinusoidal_embedding(ts.expand(x.shape[0]), ch0).to(x.dtype))


def trunk_apply(
    net: ReferenceNet2D, x: torch.Tensor, timestep, context: torch.Tensor,
    self_attn_out: Optional[list] = None,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The down and mid blocks over ``x`` (N, h, w, c0), the stem's output, at
    a scalar ``timestep`` with cross-attention ``context`` (N, S, D). Returns
    the 12 skip features (the stem, every down layer and downsampler) and
    the mid-block output, each (N, h', w', c'); ``self_attn_out`` receives
    each spatial block's normalised self-attention input."""
    temb = _temb(net, x, timestep)
    kw = dict(num_frames=1, cond_index=None, do_cfg=False, reference_attn=False,
              self_attn_out=self_attn_out)
    feats = [x]
    for block in net.down_blocks:
        for j, resnet in enumerate(block.resnets):
            x = resnet(x, temb)
            if hasattr(block, "attentions"):
                x = block.attentions[j](x, context, **kw)
            feats.append(x)
        if hasattr(block, "downsamplers"):
            x = block.downsamplers[0](x)
            feats.append(x)
    mid = net.mid_block
    x = mid.resnets[0](x, temb)
    x = mid.attentions[0](x, context, **kw)
    x = mid.resnets[1](x, temb)
    return feats, x


def referencenet_apply(
    net: ReferenceNet2D, sample: torch.Tensor, timestep, encoder_hidden_states: torch.Tensor,
    self_attn_embs: Optional[list] = None,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Run the trunk on reference latents.

    sample (B, H, W, C) reference-image latents; timestep a scalar, 0 in the
    pipeline as in the reference (``ref_timestep = torch.zeros_like``,
    pipeline_controlnet.py:895); encoder_hidden_states (B, S, D) text or
    IP-Adapter image tokens. Returns the 12 down-block embeddings (conv_in,
    every down layer and downsampler) and the mid-block embedding, each
    (B, 1, h, w, c) with a singleton time axis (referencenet.py:1017-1034).
    ``self_attn_embs``, a list, receives the write mode's embeddings, (B,
    h*w, c) per spatial site: the net needs ``need_self_attn_embs``, whose
    up blocks then run too.
    """
    if self_attn_embs is not None and not net.cfg.need_self_attn_embs:
        raise ValueError("self_attn_embs needs a ReferenceNet built with need_self_attn_embs")
    embs, mid = trunk_apply(net, net.conv_in(sample), timestep, encoder_hidden_states,
                            self_attn_out=self_attn_embs)
    if self_attn_embs is not None:
        temb, x, skips = _temb(net, sample, timestep), mid, list(embs)
        kw = dict(num_frames=1, cond_index=None, do_cfg=False, reference_attn=False,
                  self_attn_out=self_attn_embs)
        for block in net.up_blocks:
            for j, resnet in enumerate(block.resnets):
                x = resnet(torch.cat([x, skips.pop()], dim=-1), temb)
                if hasattr(block, "attentions"):
                    x = block.attentions[j](x, encoder_hidden_states, **kw)
            if hasattr(block, "upsamplers"):
                x = block.upsamplers[0](x, out_hw=skips[-1].shape[1:3] if skips else None)
    return [e[:, None] for e in embs], mid[:, None]
