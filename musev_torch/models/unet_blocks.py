"""SD1.5 UNet blocks inflated to video (counterpart of ``musev_tpu/models/unet_blocks.py``).

Module and parameter names follow the reference's torch keys, so a MuseV
state dict loads with ``load_state_dict(strict=True)``. Spatial ops take
``(B*T, H, W, C)`` (frames folded into the batch); temporal ops take the same
and regroup internally. Under classifier-free guidance the leading batch is
``[uncond; cond]`` and ReferenceOnly self-attention gives the uncond half a
plain self-attention (reference attention.py:319-334).

Attention sites: self-attention over at most ``MAX_SHORT_SEQ`` tokens with no
context and no mask (the temporal rows) goes to the packed short-attention
kernel; the temporal rows under the sparse-causal mask go to the plain
masked attention (``sdpa`` with a bias), as the JAX package sends them to
XLA; every other site goes through ``ops.attention.sdpa`` (the flash kernel
on CUDA):
spatial self- and cross-attention, the IP-Adapter and FaceID dual-KV
branches and the ReferenceNet fuse (``ReferEmbFuse``, KV = [reference
tokens; own tokens]). A spatial block can also write its normalised
self-attention input (the ReferenceNet's write mode) and read another
net's as extra ReferenceOnly keys (``refer_tokens``).
The JAX package's T -> multiple-of-8 padding of temporal rows is a TPU
re-tiling device and is not ported: the short kernel takes any T <= 64.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa
from ..ops.attention_mask import sparse_causal_mask
from ..ops.kernels.pivot import pivot_rows, unpivot_rows
from ..ops.kernels.short_attention import MAX_SHORT_SEQ, short_attention_packed
from .common import Conv2d, FeedForward, GroupNorm, LayerNorm, TemporalConv


class ResnetBlock(nn.Module):
    def __init__(self, in_c: int, out_c: int, temb_dim: Optional[int], groups: int = 32,
                 eps: float = 1e-5, skip_time_act: bool = False):
        super().__init__()
        self.skip_time_act = skip_time_act
        self.norm1 = GroupNorm(groups, in_c, eps)
        self.conv1 = Conv2d(in_c, out_c, 3, padding=1)
        if temb_dim is not None:
            self.time_emb_proj = nn.Linear(temb_dim, out_c)
        self.norm2 = GroupNorm(groups, out_c, eps)
        self.conv2 = Conv2d(out_c, out_c, 3, padding=1)
        if in_c != out_c:
            self.conv_shortcut = Conv2d(in_c, out_c, 1)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (N, H, W, C); temb (N, temb_dim) or None (the VAE's resnets)."""
        h = self.conv1(self.norm1(x, silu=True))
        if temb is not None:
            t = temb if self.skip_time_act else F.silu(temb)
            h = h + self.time_emb_proj(t)[:, None, None, :]
        h = self.conv2(self.norm2(h, silu=True))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Downsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2d(c, c, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2d(c, c, 3, padding=1)

    def forward(self, x: torch.Tensor, out_hw: Optional[Sequence[int]] = None) -> torch.Tensor:
        n, h, w, c = x.shape
        out_hw = (h * 2, w * 2) if out_hw is None else tuple(out_hw)
        if out_hw == (h * 2, w * 2):
            y = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        else:
            y = F.interpolate(x.permute(0, 3, 1, 2), size=out_hw, mode="nearest-exact")
            y = y.permute(0, 2, 3, 1).contiguous()
        return self.conv(y)


class Attention(nn.Module):
    """Multi-head attention with fused projections (keys to_q/to_k/to_v/to_out.0).

    ``ip_kv_dim`` adds the IP-Adapter dual-KV projections to_k_ip/to_v_ip
    (attention_processor.py:267-339): a second attention over the image
    tokens, scaled and added to the text-attention output. ``ip_face_kv_dim``
    adds the FaceID pair ip_adapter_face_to_k_ip/_v_ip, a third attention
    over the face tokens added after it.
    """

    def __init__(self, query_dim: int, kv_dim: Optional[int] = None, heads: int = 8,
                 ip_kv_dim: Optional[int] = None, ip_face_kv_dim: Optional[int] = None):
        super().__init__()
        kv_dim = kv_dim or query_dim
        self.heads = heads
        self.to_q = nn.Linear(query_dim, query_dim, bias=False)
        self.to_k = nn.Linear(kv_dim, query_dim, bias=False)
        self.to_v = nn.Linear(kv_dim, query_dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(query_dim, query_dim)])
        if ip_kv_dim is not None:
            self.to_k_ip = nn.Linear(ip_kv_dim, query_dim, bias=False)
            self.to_v_ip = nn.Linear(ip_kv_dim, query_dim, bias=False)
        if ip_face_kv_dim is not None:
            self.ip_adapter_face_to_k_ip = nn.Linear(ip_face_kv_dim, query_dim, bias=False)
            self.ip_adapter_face_to_v_ip = nn.Linear(ip_face_kv_dim, query_dim, bias=False)

    def project(self, x: torch.Tensor, context: Optional[torch.Tensor]):
        """(q, k, v) projections: self-attention is one matmul with the
        concatenated (bias-free) weights and cross-attention fuses k|v, so
        q/k/v are column views of one product."""
        if context is None:
            w = torch.cat([self.to_q.weight, self.to_k.weight, self.to_v.weight], 0)
            return (x @ w.t().to(x.dtype)).chunk(3, dim=-1)
        w = torch.cat([self.to_k.weight, self.to_v.weight], 0)
        k, v = (context @ w.t().to(context.dtype)).chunk(2, dim=-1)
        return self.to_q(x), k, v

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                ip_context: Optional[torch.Tensor] = None, ip_scale: float = 1.0,
                ip_face_context: Optional[torch.Tensor] = None,
                ip_face_scale: float = 1.0, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (N, S, C); context (N, S_kv, C_kv) or None for self-attention;
        ip_context (N, S_ip, C_ip) image tokens for the IP branch;
        ip_face_context (N, S_f, C_f) face tokens for the FaceID branch;
        bias an additive logit bias broadcast to (N, H, S, S_kv) (the
        sparse-causal temporal mask), which sends the call to the plain
        masked attention as the JAX package sends it to XLA."""
        qp, kp, vp = self.project(x, context)
        if (context is None and ip_context is None and ip_face_context is None
                and bias is None and x.shape[1] <= MAX_SHORT_SEQ):
            return self.to_out[0](short_attention_packed(qp, kp, vp, self.heads))
        q, k, v = (t.unflatten(-1, (self.heads, -1)) for t in (qp, kp, vp))
        out = sdpa(q, k, v, bias=bias)
        for ctx, scale, names in (
                (ip_context, ip_scale, ("to_k_ip", "to_v_ip")),
                (ip_face_context, ip_face_scale,
                 ("ip_adapter_face_to_k_ip", "ip_adapter_face_to_v_ip"))):
            if ctx is not None and hasattr(self, names[0]) and scale > 0:
                extra_k, extra_v = (getattr(self, n)(ctx).unflatten(-1, (self.heads, -1))
                                    for n in names)
                out = out + scale * sdpa(q, extra_k, extra_v)
        return self.to_out[0](out.flatten(2))


def reference_self_attention(
    attn: Attention,
    norm_h: torch.Tensor,
    *,
    num_frames: int,
    cond_index: Optional[Sequence[int]],
    do_cfg: bool,
    refer_tokens: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """ReferenceOnly self-attention over (B*T, HW, C): cond rows attend to
    [own frame tokens; all vision-condition frame tokens; ``refer_tokens``]
    (attention_processor.py:430-494), ``refer_tokens`` (B, S_ref, C) another
    net's tokens shared by the frames of a row; under CFG the uncond half
    gets plain self-attention."""
    bt, hw, c = norm_h.shape
    use_vis = cond_index is not None and num_frames > 1
    if not use_vis and refer_tokens is None:
        return attn(norm_h)
    b = bt // num_frames
    x = norm_h.reshape(b, num_frames, hw, c)

    def with_reference(rows: torch.Tensor, refer: Optional[torch.Tensor]) -> torch.Tensor:
        bb = rows.shape[0]
        parts = [rows]
        if use_vis:
            vis = rows[:, list(cond_index)].reshape(bb, 1, -1, c)
            parts.append(vis.expand(bb, num_frames, vis.shape[2], c))
        if refer is not None:
            parts.append(refer[:, None].to(rows.dtype).expand(bb, num_frames, *refer.shape[1:]))
        kv = torch.cat(parts, dim=2).reshape(bb * num_frames, -1, c)
        return attn(rows.reshape(bb * num_frames, hw, c), context=kv)

    if do_cfg:
        half = b // 2
        out_u = attn(x[:half].reshape(-1, hw, c))
        refer_c = None if refer_tokens is None else refer_tokens[half:]
        return torch.cat([out_u, with_reference(x[half:], refer_c)], dim=0)
    return with_reference(x, refer_tokens)


class BasicTransformerBlock(nn.Module):
    """norm1/attn1, norm2/attn2, norm3/ff. ``cross_dim=None`` makes attn2 a
    second self-attention (the temporal blocks' double_self_attention)."""

    def __init__(self, dim: int, cross_dim: Optional[int], heads: int,
                 ip_dim: Optional[int] = None, ip_face_dim: Optional[int] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads=heads)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, cross_dim, heads=heads, ip_kv_dim=ip_dim,
                               ip_face_kv_dim=ip_face_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                self_attn=None, norm_out: Optional[list] = None,
                bias: Optional[torch.Tensor] = None, **ip) -> torch.Tensor:
        """``self_attn``: replaces attn1 as ``(attn1, norm_h) -> out``;
        ``norm_out``: a list that receives attn1's normalised input (the
        write mode); ``bias``: both attentions' logit bias (the temporal
        blocks' sparse-causal mask); ``ip``: attn2's IP-Adapter and FaceID
        inputs."""
        norm_h = self.norm1(x)
        if norm_out is not None:
            norm_out.append(norm_h)
        x = x + (self.attn1(norm_h, bias=bias) if self_attn is None
                 else self_attn(self.attn1, norm_h))
        x = x + self.attn2(self.norm2(x), context=context, bias=bias, **ip)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """Transformer2DModel: GN -> 1x1 conv -> block -> 1x1 conv + residual."""

    def __init__(self, channels: int, cross_dim: int, heads: int, groups: int = 32,
                 ip_dim: Optional[int] = None, ip_face_dim: Optional[int] = None):
        super().__init__()
        self.norm = GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, cross_dim, heads, ip_dim, ip_face_dim)]
        )
        self.proj_out = Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor, text_ctx: torch.Tensor, *, num_frames: int,
                cond_index: Optional[Sequence[int]], do_cfg: bool,
                reference_attn: bool, vision_clip_tokens: Optional[torch.Tensor] = None,
                ip_adapter_scale: float = 1.0, face_tokens: Optional[torch.Tensor] = None,
                ip_adapter_face_scale: float = 1.0,
                refer_tokens: Optional[torch.Tensor] = None,
                self_attn_out: Optional[list] = None,
                ref_attn_fn=None) -> torch.Tensor:
        """x (B*T, H, W, C); text_ctx (B*T, S, cross_dim); vision_clip_tokens
        (B*T, S_ip, ip_dim) IP-Adapter image tokens and face_tokens (B*T,
        S_f, ip_face_dim) FaceID tokens, or None; refer_tokens (B, S_ref, C)
        extra ReferenceOnly keys; self_attn_out receives attn1's input;
        ``ref_attn_fn`` ``(attn1, norm_h) -> out`` replaces the ReferenceOnly
        self-attention (the frame-parallel program, whose vision tokens come
        from other ranks)."""
        n, h, w, c = x.shape
        y = self.proj_in(self.norm(x)).reshape(n, h * w, c)
        self_attn = None
        if reference_attn and ref_attn_fn is not None:
            self_attn = ref_attn_fn
        elif reference_attn:
            def self_attn(attn, norm_h):
                return reference_self_attention(
                    attn, norm_h, num_frames=num_frames, cond_index=cond_index,
                    do_cfg=do_cfg, refer_tokens=refer_tokens,
                )
        y = self.transformer_blocks[0](
            y, text_ctx, self_attn=self_attn, norm_out=self_attn_out,
            ip_context=vision_clip_tokens, ip_scale=ip_adapter_scale,
            ip_face_context=face_tokens, ip_face_scale=ip_adapter_face_scale)
        return self.proj_out(y.reshape(n, h, w, c)) + x


def _temporal_conv_stage(dim: int, groups: int, with_dropout: bool) -> nn.ModuleList:
    # reference Sequential indices: (GN, SiLU, Conv) or (GN, SiLU, Dropout, Conv); the
    # SiLU entry keeps the indices and is not called (the GroupNorm fuses it)
    mods = [GroupNorm(groups, dim), nn.SiLU()]
    if with_dropout:
        mods.append(nn.Identity())
    mods.append(TemporalConv(dim))
    return nn.ModuleList(mods)


class TemporalConvLayer(nn.Module):
    """4x (GN -> SiLU -> time conv), residual scaled by |temporal_weight|
    (reference resnet.py:33-135)."""

    def __init__(self, dim: int, groups: int = 32):
        super().__init__()
        self.conv1 = _temporal_conv_stage(dim, groups, False)
        self.conv2 = _temporal_conv_stage(dim, groups, True)
        self.conv3 = _temporal_conv_stage(dim, groups, True)
        self.conv4 = _temporal_conv_stage(dim, groups, True)
        self.temporal_weight = nn.Parameter(torch.full((1,), 1e-5))

    def forward(self, x: torch.Tensor, *, num_frames: int,
                cond_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        bt, h, w, c = x.shape
        v = x.reshape(bt // num_frames, num_frames, h, w, c)
        identity = v
        for stage in (self.conv1, self.conv2, self.conv3, self.conv4):
            v = stage[-1](stage[0](v, silu=True))
        if cond_mask is not None:
            v = v * cond_mask[None, :, None, None, None].to(v.dtype)
        v = identity + self.temporal_weight.abs().to(v.dtype) * v
        return v.reshape(bt, h, w, c)


def temporal_attn_bias(mode: Optional[str], num_frames: int, n_near: int,
                       device) -> Optional[torch.Tensor]:
    """The (1, 1, T, T) additive sparse-causal mask of ``mode``
    ("sparse_causal": a band of ``n_near`` previous frames and the first
    frame; "sparse_causal_near": the band only), or None."""
    if mode is None:
        return None
    if mode not in ("sparse_causal", "sparse_causal_near"):
        raise ValueError(f"temporal_self_attn_mask {mode!r}: expected 'sparse_causal' or "
                         "'sparse_causal_near'")
    mask = sparse_causal_mask(num_frames, n_near=n_near, attend_first=mode == "sparse_causal")
    return torch.from_numpy(mask).to(device)[None, None]


class TemporalTransformer(nn.Module):
    """TransformerTemporalModel: attention over time per pixel, rows
    (B*H*W, T, C) (reference temporal_transformer.py:57-308).
    ``spatial_emb_dim`` adds ``spatial_emb_proj``, which projects the
    UNet's spatial position embedding and adds it to every pixel row."""

    def __init__(self, channels: int, heads: int, femb_dim: int, groups: int = 32,
                 spatial_emb_dim: Optional[int] = None):
        super().__init__()
        self.norm = GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, channels)
        self.frame_emb_proj = nn.Linear(femb_dim, channels)
        if spatial_emb_dim is not None:
            self.spatial_emb_proj = nn.Linear(spatial_emb_dim, channels)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, None, heads)]
        )
        self.proj_out = nn.Linear(channels, channels)
        self.temporal_weight = nn.Parameter(torch.full((1,), 1e-5))

    def core(self, y: torch.Tensor, femb: torch.Tensor,
             spatial_emb: Optional[torch.Tensor] = None,
             bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """y (B, S, T, C) pixel-major group-normalized rows; femb (B, T,
        femb_dim); spatial_emb (S, femb_dim), projected and added per pixel
        row; bias the (1, 1, T, T) temporal mask of both attentions."""
        b, s, t, c = y.shape
        y = self.proj_in(y) + self.frame_emb_proj(F.silu(femb))[:, None].to(y.dtype)
        if spatial_emb is not None and hasattr(self, "spatial_emb_proj"):
            y = y + self.spatial_emb_proj(spatial_emb.to(y.dtype))[None, :, None, :]
        rows = self.transformer_blocks[0](y.reshape(b * s, t, c), bias=bias)
        return self.proj_out(rows).reshape(b, s, t, c)

    def forward(self, x: torch.Tensor, femb: torch.Tensor, *, num_frames: int,
                cond_mask: Optional[torch.Tensor] = None,
                spatial_emb: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B*T, H, W, C); femb (B, T, femb_dim); spatial_emb (H*W,
        femb_dim) and bias as ``core`` takes them. GN runs per batch element
        over the (T, H, W, C) video (temporal_transformer.py:117-119); its
        apply is fused into the pivot to pixel-major rows."""
        bt, h, w, c = x.shape
        b = bt // num_frames
        v = x.reshape(b, num_frames, h, w, c)
        scale, shift = self.norm.scale_shift(v)
        scale, shift = (s[:, None].expand(b, num_frames, c) for s in (scale, shift))
        y = pivot_rows(x.reshape(b, num_frames, h * w, c), scale, shift)
        y = self.core(y, femb, spatial_emb, bias)
        y = unpivot_rows(y).reshape(b, num_frames, h, w, c)
        if cond_mask is not None:
            y = y * cond_mask[None, :, None, None, None].to(y.dtype)
        out = v + self.temporal_weight.abs().to(y.dtype) * y
        return out.reshape(bt, h, w, c)


class ReferEmbFuse(Attention):
    """ReferenceNet feature fusion by attention (ReferEmbFuseAttention,
    attention_processor.py:557-750; ``refer_emb_fuse`` in the JAX package).
    Each frame row attends to KV = [the reference tokens; its own tokens] and
    the result is added to it; ``to_out`` is zero-initialised in the
    reference, so fusion starts as the identity."""

    def forward(self, x: torch.Tensor, refer_emb: torch.Tensor, *,
                num_frames: int) -> torch.Tensor:
        """x (B*T, H, W, C); refer_emb (B, T_ref, H_ref, W_ref, C)."""
        bt, h, w, c = x.shape
        tokens = x.reshape(bt, h * w, c)
        ref = refer_emb.reshape(bt // num_frames, -1, c).to(tokens.dtype)
        kv = torch.cat([ref.repeat_interleave(num_frames, dim=0), tokens], dim=1)
        return super().forward(tokens, context=kv).reshape(bt, h, w, c) + x
