"""The MuseV 3D UNet and the ReferenceNet trunk, as plain equations.

MuseV (TMElyralab/MuseV): ``musev/models/unet_3d_condition.py`` (forward
:773-1280), ``unet_3d_blocks.py``, ``resnet.py:33-135`` (the temporal
convolution), ``temporal_transformer.py:57-308``,
``attention_processor.py`` (ReferenceOnly self-attention :430-494, the
IP-Adapter branch :267-339, the ReferenceNet fuse :557-750) and
``referencenet.py``. Only what the benchmark's presets run is here: the
``musev`` and ``musev_referencenet`` UNets at their defaults (no ControlNet,
FaceID, spatial position embedding or temporal mask). Modules carry the
reference's torch key names, so one state dict loads into this and into the
measured program. Frames are folded into the batch for spatial layers; under
classifier-free guidance the batch is ``[uncond; cond]``.

Departures from MuseV that the measured program makes too, kept so the two
compute the same function: the feed-forward's GEGLU takes the tanh GELU,
and the block-level AdaIN is the identity (its result is discarded in MuseV,
data_util.py:600-601).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (
    Conv2d,
    GroupNorm,
    LayerNorm,
    Linear,
    NumericsUser,
    TemporalConv,
    attention,
)


@dataclasses.dataclass(frozen=True)
class UNetSizes:
    """The widths and switches of a preset's UNet3D (unet_loader.py:232-268)."""

    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    in_channels: int = 4
    out_channels: int = 4
    cross_attention_dim: int = 768
    attention_heads: int = 8
    norm_num_groups: int = 32
    need_transformer_in: bool = True  # musev: a temporal transformer after conv_in
    use_anivv1_cfg: bool = False  # SiLU on the time and frame embeddings, frame index x speed
    resnet_skip_time_act: bool = False
    keep_vision_condition: bool = False  # the condition frames' time embedding zeroed
    need_refer_emb: bool = False  # the 13 ReferenceNet fuse sites
    ip_adapter_dim: Optional[int] = None  # the IP-Adapter branch at every attn2


def sinusoidal(t: torch.Tensor, dim: int) -> torch.Tensor:
    """(N,) -> (N, dim): [cos | sin], max period 10000 (flip_sin_to_cos, shift 0)."""
    half = dim // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / half)
    arg = freq[None] * t.float()[:, None]
    return torch.cat([torch.cos(arg), torch.sin(arg)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, d_in: int, d: int):
        super().__init__()
        self.linear_1 = Linear(d_in, d)
        self.linear_2 = Linear(d, d)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, temb_dim: Optional[int], groups: int,
                 eps: float = 1e-5, skip_time_act: bool = False):
        super().__init__()
        self.skip_time_act = skip_time_act
        self.norm1 = GroupNorm(groups, cin, eps)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        if temb_dim is not None:
            self.time_emb_proj = Linear(temb_dim, cout)
        self.norm2 = GroupNorm(groups, cout, eps)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = Conv2d(cin, cout, 1)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            t = temb if self.skip_time_act else F.silu(temb)
            h = h + self.time_emb_proj(t)[:, None, None, :]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x.float() + h


class Downsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2d(c, c, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))


class Attention(NumericsUser):
    """Multi-head attention (to_q / to_k / to_v / to_out.0, no q/k/v bias);
    ``ip_dim`` adds the IP-Adapter pair to_k_ip / to_v_ip, whose attention
    over the image tokens is scaled and added to the text attention's."""

    def __init__(self, dim: int, kv_dim: Optional[int] = None, heads: int = 8,
                 ip_dim: Optional[int] = None):
        super().__init__()
        kv_dim = kv_dim or dim
        self.heads = heads
        self.to_q = Linear(dim, dim, bias=False)
        self.to_k = Linear(kv_dim, dim, bias=False)
        self.to_v = Linear(kv_dim, dim, bias=False)
        self.to_out = nn.ModuleList([Linear(dim, dim)])
        if ip_dim is not None:
            self.to_k_ip = Linear(ip_dim, dim, bias=False)
            self.to_v_ip = Linear(ip_dim, dim, bias=False)

    def heads_of(self, x):
        return x.unflatten(-1, (self.heads, -1))

    def forward(self, x, context=None, ip_context=None, ip_scale: float = 1.0):
        ctx = x if context is None else context
        q, k, v = (self.heads_of(p(t)) for p, t in ((self.to_q, x), (self.to_k, ctx),
                                                     (self.to_v, ctx)))
        out = attention(self.numerics, q, k, v)
        if ip_context is not None and hasattr(self, "to_k_ip") and ip_scale > 0:
            k_ip, v_ip = self.heads_of(self.to_k_ip(ip_context)), self.heads_of(
                self.to_v_ip(ip_context))
            out = out + ip_scale * attention(self.numerics, q, k_ip, v_ip)
        return self.to_out[0](out.flatten(2))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(), Linear(4 * dim, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class TransformerBlock(nn.Module):
    """norm1/attn1, norm2/attn2, norm3/ff; ``cross_dim=None`` makes attn2 a
    second self-attention (the temporal blocks)."""

    def __init__(self, dim: int, cross_dim: Optional[int], heads: int,
                 ip_dim: Optional[int] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads=heads)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, cross_dim, heads=heads, ip_dim=ip_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context=None, self_attn=None, ip_context=None, ip_scale=1.0):
        h = self.norm1(x)
        x = x + (self.attn1(h) if self_attn is None else self_attn(self.attn1, h))
        x = x + self.attn2(self.norm2(x), context, ip_context, ip_scale)
        return x + self.ff(self.norm3(x))


def reference_only(attn: Attention, h: torch.Tensor, num_frames: int,
                   cond_index: Optional[Sequence[int]], do_cfg: bool) -> torch.Tensor:
    """ReferenceOnly self-attention over (B*T, HW, C): the cond half's
    frames attend to [their own tokens; every condition frame's tokens],
    the uncond half's to their own."""
    if cond_index is None or num_frames == 1:
        return attn(h)
    bt, hw, c = h.shape
    x = h.reshape(bt // num_frames, num_frames, hw, c)
    half = x.shape[0] // 2 if do_cfg else 0
    outs = [attn(x[:half].reshape(-1, hw, c))] if half else []
    cond = x[half:]
    vis = cond[:, list(cond_index)].reshape(cond.shape[0], 1, -1, c)
    kv = torch.cat([cond, vis.expand(-1, num_frames, -1, -1)], dim=2)
    outs.append(attn(cond.reshape(-1, hw, c), context=kv.reshape(-1, kv.shape[2], c)))
    return torch.cat(outs, dim=0)


class SpatialTransformer(nn.Module):
    """GroupNorm -> 1x1 conv -> transformer block -> 1x1 conv, + residual."""

    def __init__(self, c: int, cross_dim: int, heads: int, groups: int,
                 ip_dim: Optional[int] = None):
        super().__init__()
        self.norm = GroupNorm(groups, c, 1e-6)
        self.proj_in = Conv2d(c, c, 1)
        self.transformer_blocks = nn.ModuleList([TransformerBlock(c, cross_dim, heads, ip_dim)])
        self.proj_out = Conv2d(c, c, 1)

    def forward(self, x, text, *, num_frames=1, cond_index=None, do_cfg=False,
                reference=False, ip_tokens=None, ip_scale=1.0):
        n, h, w, c = x.shape
        y = self.proj_in(self.norm(x)).reshape(n, h * w, c)
        self_attn = None
        if reference:
            def self_attn(attn, hh):
                return reference_only(attn, hh, num_frames, cond_index, do_cfg)
        y = self.transformer_blocks[0](y, text, self_attn, ip_tokens, ip_scale)
        return self.proj_out(y.reshape(n, h, w, c)) + x.float()


class TemporalConvLayer(nn.Module):
    """4 x (GroupNorm over each video -> SiLU -> time conv), residual scaled
    by |temporal_weight|. Keys: (GN, SiLU, Conv) then (GN, SiLU, Dropout, Conv)."""

    def __init__(self, c: int, groups: int):
        super().__init__()
        self.conv1 = nn.ModuleList([GroupNorm(groups, c), nn.SiLU(), TemporalConv(c)])
        for name in ("conv2", "conv3", "conv4"):
            setattr(self, name, nn.ModuleList([GroupNorm(groups, c), nn.SiLU(), nn.Identity(),
                                               TemporalConv(c)]))
        self.temporal_weight = nn.Parameter(torch.zeros(1))

    def forward(self, x, num_frames):
        bt, h, w, c = x.shape
        v = x.float().reshape(bt // num_frames, num_frames, h, w, c)
        y = v
        for stage in (self.conv1, self.conv2, self.conv3, self.conv4):
            y = stage[-1](F.silu(stage[0](y)))
        return (v + self.temporal_weight.float().abs() * y).reshape(bt, h, w, c)


class TemporalTransformer(nn.Module):
    """Attention over time per pixel: GroupNorm over each video, rows (B*H*W,
    T, C) with the frame embedding added, two self-attentions and the
    feed-forward, residual scaled by |temporal_weight|."""

    def __init__(self, c: int, heads: int, femb_dim: int, groups: int):
        super().__init__()
        self.norm = GroupNorm(groups, c, 1e-6)
        self.proj_in = Linear(c, c)
        self.frame_emb_proj = Linear(femb_dim, c)
        self.transformer_blocks = nn.ModuleList([TransformerBlock(c, None, heads)])
        self.proj_out = Linear(c, c)
        self.temporal_weight = nn.Parameter(torch.zeros(1))

    def forward(self, x, femb, num_frames):
        bt, h, w, c = x.shape
        b = bt // num_frames
        v = x.float().reshape(b, num_frames, h, w, c)
        y = self.norm(v).reshape(b, num_frames, h * w, c).transpose(1, 2)  # (b, HW, T, C)
        y = self.proj_in(y) + self.frame_emb_proj(F.silu(femb))[:, None]
        y = self.transformer_blocks[0](y.reshape(b * h * w, num_frames, c))
        y = self.proj_out(y).reshape(b, h * w, num_frames, c).transpose(1, 2)
        out = v + self.temporal_weight.float().abs() * y.reshape(b, num_frames, h, w, c)
        return out.reshape(bt, h, w, c)


class ReferEmbFuse(Attention):
    """Each frame row attends to [the reference tokens; its own tokens], added
    to it."""

    def forward(self, x, refer, num_frames):
        bt, h, w, c = x.shape
        tokens = x.float().reshape(bt, h * w, c)
        ref = refer.float().reshape(bt // num_frames, -1, c).repeat_interleave(num_frames, 0)
        out = super().forward(tokens, context=torch.cat([ref, tokens], dim=1))
        return out.reshape(bt, h, w, c) + x.float()


class _Block(nn.Module):
    def __init__(self, s: UNetSizes, ins: Sequence[int], c: int, cross: bool, temporal: bool):
        super().__init__()
        g, temb = s.norm_num_groups, 4 * s.block_out_channels[0]
        self.resnets = nn.ModuleList([ResnetBlock(i, c, temb, g, 1e-5, s.resnet_skip_time_act)
                                      for i in ins])
        self.temp_convs = nn.ModuleList([TemporalConvLayer(c, g) for _ in ins])
        if cross:
            self.attentions = nn.ModuleList([
                SpatialTransformer(c, s.cross_attention_dim, s.attention_heads, g,
                                   s.ip_adapter_dim) for _ in ins])
            if temporal:
                self.temp_attentions = nn.ModuleList([
                    TemporalTransformer(c, s.attention_heads, temb, g) for _ in ins])


class UNet3D(nn.Module):
    """SD1.5 down blocks (cross, cross, cross, plain), the mid block, up
    blocks (plain, cross, cross, cross), each layer a resnet, a temporal
    convolution, a spatial and a temporal transformer."""

    def __init__(self, s: UNetSizes):
        super().__init__()
        self.s = s
        chs, g = s.block_out_channels, s.norm_num_groups
        ch0, temb = chs[0], 4 * chs[0]
        self.conv_in = Conv2d(s.in_channels, ch0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch0, temb)
        self.frame_embedding = TimestepEmbedding(ch0, temb)
        if s.need_transformer_in:
            self.transformer_in = TemporalTransformer(ch0, s.attention_heads, temb, g)
        if s.need_refer_emb:
            self.first_refer_emb_attns = ReferEmbFuse(ch0, heads=s.attention_heads)
            self.mid_block_refer_emb_attns = ReferEmbFuse(chs[-1], heads=s.attention_heads)
        skips, out_c = [ch0], ch0
        self.down_blocks = nn.ModuleList()
        for i, c in enumerate(chs):
            last = i == len(chs) - 1
            block = _Block(s, [out_c] + [c] * (s.layers_per_block - 1), c, not last, True)
            skips += [c] * s.layers_per_block
            if not last:
                block.downsamplers = nn.ModuleList([Downsample(c)])
                skips.append(c)
            if s.need_refer_emb:
                block.refer_emb_attns = nn.ModuleList([
                    ReferEmbFuse(c, heads=s.attention_heads)
                    for _ in range(s.layers_per_block + (0 if last else 1))])
            self.down_blocks.append(block)
            out_c = c
        mid = chs[-1]
        self.mid_block = _Block(s, [mid, mid], mid, False, False)
        self.mid_block.attentions = nn.ModuleList([
            SpatialTransformer(mid, s.cross_attention_dim, s.attention_heads, g, s.ip_adapter_dim)])
        self.mid_block.temp_attentions = nn.ModuleList([
            TemporalTransformer(mid, s.attention_heads, temb, g)])
        self.up_blocks = nn.ModuleList()
        prev = mid
        for i, c in enumerate(reversed(chs)):
            ins = [(prev if j == 0 else c) + skips.pop() for j in range(s.layers_per_block + 1)]
            block = _Block(s, ins, c, i > 0, True)
            if i < len(chs) - 1:
                block.upsamplers = nn.ModuleList([Upsample(c)])
            self.up_blocks.append(block)
            prev = c
        self.conv_norm_out = GroupNorm(g, ch0)
        self.conv_out = Conv2d(ch0, s.out_channels, 3, padding=1)

    def forward(self, sample: torch.Tensor, timestep: float, text: torch.Tensor, *,
                cond_index: Optional[Sequence[int]] = None, do_cfg: bool = True,
                motion_speed: float = 8.0, use_temporal: bool = True,
                refer_embs: Optional[List[torch.Tensor]] = None,
                mid_refer_emb: Optional[torch.Tensor] = None,
                ip_tokens: Optional[torch.Tensor] = None,
                ip_scale: float = 1.0) -> torch.Tensor:
        """sample (B, T, h, w, 4) with the condition frames in place at
        ``cond_index``; text (B, S, D); refer_embs (12) and mid_refer_emb
        (B, 1, h', w', c'); ip_tokens (B, S_ip, D_ip). Returns (B, T, h, w, 4)."""
        s = self.s
        b, t, h0, w0, _ = sample.shape
        ch0 = s.block_out_channels[0]
        dev = sample.device
        temb = self.time_embedding(sinusoidal(torch.full((b,), float(timestep), device=dev), ch0))
        if s.use_anivv1_cfg:
            temb = F.silu(temb)
        temb = temb.repeat_interleave(t, 0)
        if s.keep_vision_condition and use_temporal and t > 1 and cond_index is not None:
            keep = torch.ones(t, device=dev)
            keep[list(cond_index)] = 0.0
            temb = temb * keep.repeat(b)[:, None]
        femb = None
        if use_temporal:
            fidx = torch.arange(t, dtype=torch.float32, device=dev)
            if s.use_anivv1_cfg:
                fidx = torch.floor(fidx * motion_speed)
            femb = self.frame_embedding(sinusoidal(fidx, ch0))[None].expand(b, t, -1)
            if s.use_anivv1_cfg:
                femb = F.silu(femb)
        text = text.float().repeat_interleave(t, 0)
        ip = None if ip_tokens is None or s.ip_adapter_dim is None else \
            ip_tokens.float().repeat_interleave(t, 0)
        spatial = dict(num_frames=t, cond_index=cond_index if use_temporal else None,
                       do_cfg=do_cfg, reference=True, ip_tokens=ip, ip_scale=ip_scale)

        def layer(block, j, x):
            x = block.resnets[j](x, temb)
            if use_temporal:
                x = block.temp_convs[j](x, t)
            if hasattr(block, "attentions"):
                x = block.attentions[j](x, text, **spatial)
            if hasattr(block, "temp_attentions") and use_temporal:
                x = block.temp_attentions[j](x, femb, t)
            return x

        fuse = s.need_refer_emb and refer_embs is not None
        refer = iter(refer_embs or ())
        x = self.conv_in(sample.float().reshape(b * t, h0, w0, -1))
        if hasattr(self, "transformer_in") and use_temporal:
            x = self.transformer_in(x, femb, t)
        if fuse:
            x = self.first_refer_emb_attns(x, next(refer), t)
        skips = [x]
        for block in self.down_blocks:
            fusers = iter(block.refer_emb_attns if fuse else ())
            for j in range(len(block.resnets)):
                x = layer(block, j, x)
                if fuse:
                    x = next(fusers)(x, next(refer), t)
                skips.append(x)
            if hasattr(block, "downsamplers"):
                x = block.downsamplers[0](x)
                if fuse:
                    x = next(fusers)(x, next(refer), t)
                skips.append(x)
        mid = self.mid_block
        x = mid.resnets[0](x, temb)
        if use_temporal:
            x = mid.temp_convs[0](x, t)
        x = mid.attentions[0](x, text, **spatial)
        if use_temporal:
            x = mid.temp_attentions[0](x, femb, t)
        x = mid.resnets[1](x, temb)
        if use_temporal:
            x = mid.temp_convs[1](x, t)
        if s.need_refer_emb and mid_refer_emb is not None:
            x = self.mid_block_refer_emb_attns(x, mid_refer_emb, t)
        for block in self.up_blocks:
            for j in range(len(block.resnets)):
                x = layer(block, j, torch.cat([x, skips.pop()], dim=-1))
            if hasattr(block, "upsamplers"):
                x = block.upsamplers[0](x)
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.reshape(b, t, h0, w0, -1)


class _RefBlock(nn.Module):
    def __init__(self, s: UNetSizes, cin: int, c: int, n: int, attn: bool):
        super().__init__()
        g, temb = s.norm_num_groups, 4 * s.block_out_channels[0]
        self.resnets = nn.ModuleList([ResnetBlock(cin if j == 0 else c, c, temb, g)
                                      for j in range(n)])
        if attn:
            self.attentions = nn.ModuleList([
                SpatialTransformer(c, s.cross_attention_dim, s.attention_heads, g)
                for _ in range(n)])


class ReferenceNet(nn.Module):
    """conv_in, the down blocks and the mid block of an SD1.5 UNet; emits
    the stem, every down layer's and downsampler's output and the mid
    block's (MuseV referencenet.py, its decoder head pruned)."""

    def __init__(self, s: UNetSizes):
        super().__init__()
        chs = s.block_out_channels
        self.conv_in = Conv2d(s.in_channels, chs[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(chs[0], 4 * chs[0])
        self.down_blocks = nn.ModuleList()
        out_c = chs[0]
        for i, c in enumerate(chs):
            last = i == len(chs) - 1
            block = _RefBlock(s, out_c, c, s.layers_per_block, not last)
            if not last:
                block.downsamplers = nn.ModuleList([Downsample(c)])
            self.down_blocks.append(block)
            out_c = c
        self.mid_block = _RefBlock(s, chs[-1], chs[-1], 2, False)
        self.mid_block.attentions = nn.ModuleList([
            SpatialTransformer(chs[-1], s.cross_attention_dim, s.attention_heads,
                               s.norm_num_groups)])

    def forward(self, latents: torch.Tensor, context: torch.Tensor):
        """latents (N, h, w, 4) at timestep 0; context (N, S, D). Returns the
        12 down features and the mid feature, each (N, 1, h', w', c')."""
        ch0 = self.conv_in.out_channels
        x = self.conv_in(latents.float())
        temb = self.time_embedding(sinusoidal(torch.zeros(x.shape[0], device=x.device), ch0))
        feats = [x]
        for block in self.down_blocks:
            for j, res in enumerate(block.resnets):
                x = res(x, temb)
                if hasattr(block, "attentions"):
                    x = block.attentions[j](x, context)
                feats.append(x)
            if hasattr(block, "downsamplers"):
                x = block.downsamplers[0](x)
                feats.append(x)
        mid = self.mid_block
        x = mid.resnets[1](mid.attentions[0](mid.resnets[0](x, temb), context), temb)
        return [f[:, None] for f in feats], x[:, None]
