"""The MuseV 3D UNet (counterpart of ``musev_tpu/models/unet3d.py``).

Behavioral reference: musev/models/unet_3d_condition.py (structure :212-610,
forward :773-1280) and unet_3d_blocks.py. Submodules carry the reference's
torch key names. Frames are folded into the batch for spatial ops; CFG runs
as ``[uncond; cond]`` batch halves.

AdaIN: the reference enables ``need_adain_temporal_cond`` for every preset but
its ``batch_adain_conditioned_tensor`` discards the result for 4-D inputs
(data_util.py:600-601), so block-level AdaIN is a no-op in the released
models; ``adain_fix=False`` (default) reproduces that.

``UNet3DConfig`` has the JAX config's fields for what is ported, including
the ``musev_referencenet`` preset's ReferenceNet block-emb fusion (13
``ReferEmbFuse`` sites: the stem, after every down layer and downsampler, and
after the mid block), the IP-Adapter and FaceID dual-KV cross-attention and
the ReferenceNet self-attention embeddings (``refer_self_attn_embs``: written
or read at every spatial site, down, mid and up in that order), and the pose
preset's ControlNet residuals and PoseGuider embedding as inputs of
``unet3d_apply``, the spatial position embedding
(``need_spatial_position_emb``: a 2D sin-cos grid per latent resolution,
projected by ``spatial_position_embedding`` and by each temporal
transformer's ``spatial_emb_proj``, added to its pixel rows) and the
sparse-causal temporal mask (``temporal_self_attn_mask``: both attentions
of every temporal transformer under an additive (T, T) mask, on the plain
masked attention). No preset turns the last two on; the config has every
field of the JAX ``UNet3DConfig``.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.adain import adain_to_condition_frames
from ..ops.index_ops import frame_mask, splice_with_index
from .common import Conv2d, GroupNorm
from .embeddings import TimestepEmbedding, get_2d_sincos_pos_embed, sinusoidal_embedding
from .unet_blocks import (
    Downsample,
    ReferEmbFuse,
    ResnetBlock,
    SpatialTransformer,
    TemporalConvLayer,
    TemporalTransformer,
    Upsample,
    temporal_attn_bias,
)


@dataclasses.dataclass(frozen=True)
class UNet3DConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock3D",
        "CrossAttnDownBlock3D",
        "CrossAttnDownBlock3D",
        "DownBlock3D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock3D",
        "CrossAttnUpBlock3D",
        "CrossAttnUpBlock3D",
        "CrossAttnUpBlock3D",
    )
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_heads: int = 8
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    temporal_conv: bool = True
    temporal_transformer: bool = True
    need_transformer_in: bool = True
    reference_attn: bool = True
    need_adain_temporal_cond: bool = True
    adain_fix: bool = False
    keep_vision_condition: bool = False
    use_anivv1_cfg: bool = False
    resnet_skip_time_act: bool = False
    need_refer_emb: bool = False  # ReferenceNet block-emb fusion
    ip_adapter_cross_attn: bool = False
    ip_adapter_dim: int = 768  # IP-Adapter image-token width after projection
    need_ip_adapter_face: bool = False  # the IPAdapterFaceID branch at every attn2
    ip_adapter_face_dim: int = 768
    keep_content_condition: bool = False
    need_spatial_position_emb: bool = False  # hw sincos emb in temporal rows
    # sparse-causal mask on temporal self-attention: None | "sparse_causal"
    # (band of n_near previous frames + the first frame) | "sparse_causal_near"
    # (band only); the reference declares it (temporal_transformer.py:101,
    # attention_util.py:29-74) but never applies it, the JAX package wires it
    temporal_self_attn_mask: Optional[str] = None
    temporal_attn_n_near: int = 1
    norm_spatial_length: bool = False
    spatial_max_length: int = 2048

    @property
    def temb_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @property
    def femb_dim(self) -> int:
        return self.block_out_channels[0] * 4


def musev_config(**overrides) -> UNet3DConfig:
    """The ``musev`` preset (unet_loader.py:232-242)."""
    return UNet3DConfig(**overrides)


def musev_referencenet_config(**overrides) -> UNet3DConfig:
    """The ``musev_referencenet`` preset (unet_loader.py:243-268)."""
    kw: Dict[str, Any] = dict(
        need_transformer_in=False,
        use_anivv1_cfg=True,
        resnet_skip_time_act=True,
        keep_vision_condition=True,
        need_refer_emb=True,
        ip_adapter_cross_attn=True,
    )
    kw.update(overrides)
    return UNet3DConfig(**kw)


def _is_cross(name: str) -> bool:
    return "CrossAttn" in name


def _spatial_transformer(cfg: UNet3DConfig, c: int) -> SpatialTransformer:
    ip_dim = cfg.ip_adapter_dim if cfg.ip_adapter_cross_attn else None
    face_dim = cfg.ip_adapter_face_dim if cfg.need_ip_adapter_face else None
    return SpatialTransformer(c, cfg.cross_attention_dim, cfg.attention_heads,
                              cfg.norm_num_groups, ip_dim, face_dim)


def _temporal_transformer(cfg: UNet3DConfig, c: int) -> TemporalTransformer:
    sp_dim = cfg.femb_dim if cfg.need_spatial_position_emb else None
    return TemporalTransformer(c, cfg.attention_heads, cfg.femb_dim, cfg.norm_num_groups,
                               spatial_emb_dim=sp_dim)


class _Block(nn.Module):
    """One down/up/mid block: ModuleLists under the reference's key names."""

    def __init__(self, cfg: UNet3DConfig, in_cs: Sequence[int], out_c: int, cross: bool,
                 temporal_attn: bool):
        super().__init__()
        g = cfg.norm_num_groups
        self.resnets = nn.ModuleList([
            ResnetBlock(c, out_c, cfg.temb_dim, g, cfg.norm_eps, cfg.resnet_skip_time_act)
            for c in in_cs
        ])
        n = len(in_cs)
        if cfg.temporal_conv:
            self.temp_convs = nn.ModuleList([TemporalConvLayer(out_c, g) for _ in range(n)])
        n_attn = n if cross else 0
        if n_attn:
            self.attentions = nn.ModuleList([
                _spatial_transformer(cfg, out_c) for _ in range(n_attn)
            ])
        if cross and temporal_attn:
            self.temp_attentions = nn.ModuleList([
                _temporal_transformer(cfg, out_c) for _ in range(n_attn)
            ])


class UNet3D(nn.Module):
    def __init__(self, cfg: UNet3DConfig):
        super().__init__()
        self.cfg = cfg
        chs = cfg.block_out_channels
        ch0 = chs[0]
        g = cfg.norm_num_groups
        self.conv_in = Conv2d(cfg.in_channels, ch0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch0, cfg.temb_dim)
        if cfg.temporal_transformer:
            self.frame_embedding = TimestepEmbedding(ch0, cfg.femb_dim)
        if cfg.need_transformer_in and cfg.temporal_transformer:
            self.transformer_in = _temporal_transformer(cfg, ch0)
        if cfg.need_spatial_position_emb:
            self.spatial_position_embedding = TimestepEmbedding(ch0 * 2, cfg.femb_dim)
        self._spatial_grids: Dict[Tuple[int, int], torch.Tensor] = {}
        if cfg.need_refer_emb:
            self.first_refer_emb_attns = ReferEmbFuse(ch0, heads=cfg.attention_heads)
            self.mid_block_refer_emb_attns = ReferEmbFuse(chs[-1], heads=cfg.attention_heads)

        skip_channels = [ch0]
        self.down_blocks = nn.ModuleList()
        out_c = ch0
        for i, btype in enumerate(cfg.down_block_types):
            in_c, out_c = out_c, chs[i]
            ins = [in_c] + [out_c] * (cfg.layers_per_block - 1)
            block = _Block(cfg, ins, out_c, _is_cross(btype), cfg.temporal_transformer)
            skip_channels += [out_c] * cfg.layers_per_block
            last = i == len(chs) - 1
            if not last:
                block.downsamplers = nn.ModuleList([Downsample(out_c)])
                skip_channels.append(out_c)
            if cfg.need_refer_emb:
                block.refer_emb_attns = nn.ModuleList([
                    ReferEmbFuse(out_c, heads=cfg.attention_heads)
                    for _ in range(cfg.layers_per_block + (0 if last else 1))
                ])
            self.down_blocks.append(block)

        mid_c = chs[-1]
        self.mid_block = _Block(cfg, [mid_c, mid_c], mid_c, False, False)
        self.mid_block.attentions = nn.ModuleList([_spatial_transformer(cfg, mid_c)])
        if cfg.temporal_transformer:
            self.mid_block.temp_attentions = nn.ModuleList([_temporal_transformer(cfg, mid_c)])

        self.up_blocks = nn.ModuleList()
        rev = list(reversed(chs))
        prev_out = rev[0]
        for i, btype in enumerate(cfg.up_block_types):
            out_c = rev[i]
            ins = []
            for j in range(cfg.layers_per_block + 1):
                ins.append((prev_out if j == 0 else out_c) + skip_channels.pop())
            block = _Block(cfg, ins, out_c, _is_cross(btype), cfg.temporal_transformer)
            if i < len(cfg.up_block_types) - 1:
                block.upsamplers = nn.ModuleList([Upsample(out_c)])
            self.up_blocks.append(block)
            prev_out = out_c

        self.conv_norm_out = GroupNorm(g, ch0, cfg.norm_eps)
        self.conv_out = Conv2d(ch0, cfg.out_channels, 3, padding=1)

    def spatial_grid(self, h: int, w: int, device) -> torch.Tensor:
        """The (h*w, 2*ch0) sin-cos grid of an h x w latent, made once per
        (h, w) and device (unet_3d_condition.py:955-971; recomputed per
        scale instead of resized, which is exact for sincos grids)."""
        key = (h, w, str(device))
        if key not in self._spatial_grids:
            cfg = self.cfg
            grid = get_2d_sincos_pos_embed(cfg.block_out_channels[0] * 2, h, w,
                                           norm_length=cfg.norm_spatial_length,
                                           max_length=cfg.spatial_max_length)
            self._spatial_grids[key] = torch.from_numpy(grid).to(device)
        return self._spatial_grids[key]


def prepare_unet_inputs(
    unet: UNet3D,
    sample: torch.Tensor,
    timestep,
    text_emb: torch.Tensor,
    *,
    motion_speed: float,
    use_temporal: bool,
    cond_index: Optional[Sequence[int]],
    vision_clip_emb: Optional[torch.Tensor] = None,
    ip_adapter_face_emb: Optional[torch.Tensor] = None,
):
    """Returns ``(temb, femb, text_ctx, clip_ctx, face_ctx, cond_mask)``:
    temb, text_ctx, clip_ctx and face_ctx are aligned to the (B*T, ...) frame
    rows of ``sample``; femb is (B, T, D); clip_ctx and face_ctx are None
    without IP-Adapter or FaceID tokens."""
    cfg = unet.cfg
    b, num_frames = sample.shape[:2]
    dtype, device = sample.dtype, sample.device
    ch0 = cfg.block_out_channels[0]

    ts = torch.as_tensor(timestep, dtype=torch.float32, device=device).reshape(-1)
    ts = ts.expand(b)
    temb = unet.time_embedding(sinusoidal_embedding(ts, ch0).to(dtype))
    if cfg.use_anivv1_cfg:
        temb = F.silu(temb)
    temb = temb.repeat_interleave(num_frames, dim=0)
    if cfg.keep_vision_condition and use_temporal and num_frames > 1 and cond_index is not None:
        keep = frame_mask(num_frames, cond_index, dtype=temb.dtype, device=device)
        temb = temb * keep.repeat(b)[:, None]

    femb = None
    if cfg.temporal_transformer and use_temporal:
        fidx = torch.arange(num_frames, dtype=torch.float32, device=device)
        if cfg.use_anivv1_cfg:
            fidx = torch.floor(fidx * motion_speed)
        femb = sinusoidal_embedding(fidx, ch0)[None].expand(b, num_frames, -1)
        femb = unet.frame_embedding(femb.to(dtype))
        if cfg.use_anivv1_cfg:
            femb = F.silu(femb)

    def rows(emb):  # (B, S, D) per video or (B, T, S, D) per frame -> (B*T, S, D)
        if emb.ndim == 3:
            return emb.repeat_interleave(num_frames, dim=0)
        return emb.reshape(-1, *emb.shape[2:])

    text_ctx = rows(text_emb)
    clip_ctx = None
    if vision_clip_emb is not None and cfg.ip_adapter_cross_attn:
        clip_ctx = rows(vision_clip_emb)
    face_ctx = None
    if ip_adapter_face_emb is not None and cfg.need_ip_adapter_face:
        face_ctx = rows(ip_adapter_face_emb)

    cond_mask = None
    if cfg.keep_content_condition and use_temporal and num_frames > 1 and cond_index is not None:
        cond_mask = frame_mask(num_frames, cond_index, device=device)
    return temb, femb, text_ctx, clip_ctx, face_ctx, cond_mask


@dataclasses.dataclass
class UNetOps:
    """Strategy hooks of the block loop (``unet3d_core``; the JAX package's
    ``UNetOps``, musev_tpu/models/unet3d.py:283-299).

    The loop knows only frame-local row tensors (N, H, W, C); whatever mixes
    frames or needs the batch's structure goes through these hooks, each
    called with the module of its site. ``default_ops`` runs one program
    with the frames folded into the batch; the frame-parallel program
    (``parallel.frame_parallel``) swaps in collective-backed versions over
    row shards."""

    spatial: Callable  # (SpatialTransformer, x) -> x
    temporal_conv: Callable  # (TemporalConvLayer, x) -> x
    temporal_attn: Callable  # (TemporalTransformer, x) -> x
    refer_fuse: Callable  # (ReferEmbFuse, x, refer_emb) -> x
    adain: Callable  # (x) -> x
    use_temporal: bool = True


def default_ops(
    unet: UNet3D,
    *,
    num_frames: int,
    use_temporal: bool,
    do_cfg: bool,
    gen_index: Optional[Sequence[int]],
    cond_index: Optional[Sequence[int]],
    cond_mask: Optional[torch.Tensor],
    femb: Optional[torch.Tensor],
    text_ctx: torch.Tensor,
    device,
    clip_ctx: Optional[torch.Tensor] = None,
    ip_adapter_scale: float = 1.0,
    face_ctx: Optional[torch.Tensor] = None,
    ip_adapter_face_scale: float = 1.0,
    refer_self_attn_embs: Optional[list] = None,
    refer_self_attn_mode: Optional[str] = None,
    grad_checkpoint: bool = False,
) -> UNetOps:
    """The one-program hooks over frame rows (B*T, H, W, C) folded from B
    videos of ``num_frames`` frames."""
    cfg = unet.cfg
    spatial_kw: Dict[str, Any] = dict(
        num_frames=num_frames,
        cond_index=cond_index if use_temporal else None,
        do_cfg=do_cfg,
        reference_attn=cfg.reference_attn,
        vision_clip_tokens=clip_ctx,
        ip_adapter_scale=ip_adapter_scale,
        face_tokens=face_ctx,
        ip_adapter_face_scale=ip_adapter_face_scale,
    )
    if refer_self_attn_mode not in (None, "write", "read"):
        raise ValueError(f"refer_self_attn_mode {refer_self_attn_mode!r}: expected "
                         "'write' or 'read'")
    site = itertools.count()  # the spatial sites in call order

    def spatial(mod, x):
        i = next(site)
        kw = dict(spatial_kw)
        if refer_self_attn_embs is not None and refer_self_attn_mode == "write":
            kw["self_attn_out"] = refer_self_attn_embs
        elif refer_self_attn_embs is not None and refer_self_attn_mode == "read":
            kw["refer_tokens"] = refer_self_attn_embs[i]
        return mod(x, text_ctx, **kw)

    def temporal_conv(mod, x):
        return mod(x, num_frames=num_frames, cond_mask=cond_mask)

    bias = temporal_attn_bias(cfg.temporal_self_attn_mask, num_frames,
                              cfg.temporal_attn_n_near, device) if use_temporal else None
    spatial_embs: Dict[Tuple[int, int], torch.Tensor] = {}

    def spatial_emb(x):
        # the grid projected by spatial_position_embedding, once per call
        # and resolution, in the activations' dtype
        if not cfg.need_spatial_position_emb:
            return None
        h, w = x.shape[1], x.shape[2]
        # a checkpointed unit recomputes it: a cache hit would skip the ops
        # whose saved tensors the recompute must give back
        if grad_checkpoint or (h, w) not in spatial_embs:
            grid = unet.spatial_grid(h, w, x.device).to(x.dtype)
            spatial_embs[(h, w)] = unet.spatial_position_embedding(grid)
        return spatial_embs[(h, w)]

    def temporal_attn(mod, x):
        return mod(x, femb, num_frames=num_frames, cond_mask=cond_mask,
                   spatial_emb=spatial_emb(x), bias=bias)

    def refer_fuse(mod, x, refer_emb):
        return mod(x, refer_emb, num_frames=num_frames)

    def adain(x):
        if (cfg.need_adain_temporal_cond and cfg.adain_fix and num_frames > 1
                and gen_index is not None and cond_index is not None):
            bt, h, w, c = x.shape
            v = x.reshape(bt // num_frames, num_frames, h, w, c)
            return adain_to_condition_frames(v, gen_index, cond_index).reshape(bt, h, w, c)
        return x

    return UNetOps(spatial=spatial, temporal_conv=temporal_conv, temporal_attn=temporal_attn,
                   refer_fuse=refer_fuse, adain=adain, use_temporal=use_temporal)


def unet3d_core(
    unet: UNet3D,
    x: torch.Tensor,
    temb: torch.Tensor,
    ops: UNetOps,
    *,
    down_block_refer_embs: Optional[Sequence[torch.Tensor]] = None,
    mid_block_refer_emb: Optional[torch.Tensor] = None,
    controlnet_down_residuals: Optional[Sequence[torch.Tensor]] = None,
    controlnet_mid_residual: Optional[torch.Tensor] = None,
    pose_guider_emb: Optional[torch.Tensor] = None,
    grad_checkpoint: bool = False,
) -> torch.Tensor:
    """The UNet block loop over frame rows ``x (N, H, W, C)``: frame-local
    compute (convs, resnets, samplers, head) inline, the rest through
    ``ops``.

    ``grad_checkpoint`` runs each layer of a down or up block (its resnet,
    temporal conv, spatial and temporal transformers and AdaIN) and the mid
    block's whole sequence under ``torch.utils.checkpoint`` (non-reentrant):
    only the unit's input is kept for the backward, which recomputes the
    unit. The stem, the down- and upsamplers, the ReferenceNet fuses and the
    output head are not checkpointed. Checkpointing the whole UNet, as
    ``jax.checkpoint`` does in the JAX package's training step, would not
    lower PyTorch's peak: its recompute stores every activation again.
    """
    cfg = unet.cfg
    fuse_down = cfg.need_refer_emb and down_block_refer_embs is not None

    def temporal_conv(mod, x):
        return ops.temporal_conv(mod, x) if ops.use_temporal else x

    def temporal_attn(mod, x):
        return ops.temporal_attn(mod, x) if ops.use_temporal else x

    def layer(block, j, x):
        x = block.resnets[j](x, temb)
        if hasattr(block, "temp_convs"):
            x = temporal_conv(block.temp_convs[j], x)
        if hasattr(block, "attentions"):
            x = ops.spatial(block.attentions[j], x)
        if hasattr(block, "temp_attentions"):
            x = temporal_attn(block.temp_attentions[j], x)
        return ops.adain(x)

    def unit(fn, *args):
        if grad_checkpoint:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def mid_layers(mid, x):
        x = mid.resnets[0](x, temb)
        if hasattr(mid, "temp_convs"):
            x = temporal_conv(mid.temp_convs[0], x)
        x = ops.spatial(mid.attentions[0], x)
        if hasattr(mid, "temp_attentions"):
            x = temporal_attn(mid.temp_attentions[0], x)
        x = mid.resnets[1](x, temb)
        if hasattr(mid, "temp_convs"):
            x = temporal_conv(mid.temp_convs[1], x)
        return ops.adain(x)

    x = unet.conv_in(x)
    if pose_guider_emb is not None:
        x = x + pose_guider_emb.to(x.dtype)
    if hasattr(unet, "transformer_in"):
        x = temporal_attn(unet.transformer_in, x)
    refer = iter(down_block_refer_embs or ())
    if fuse_down:  # the stem and the 11 down sites take the 12 down embeddings in order
        x = ops.refer_fuse(unet.first_refer_emb_attns, x, next(refer))

    skips = [x]
    for block in unet.down_blocks:
        fusers = iter(block.refer_emb_attns if fuse_down else ())
        for j in range(len(block.resnets)):
            x = unit(layer, block, j, x)
            if fuse_down:
                x = ops.refer_fuse(next(fusers), x, next(refer))
            skips.append(x)
        if hasattr(block, "downsamplers"):
            x = ops.adain(block.downsamplers[0](x))
            if fuse_down:
                x = ops.refer_fuse(next(fusers), x, next(refer))
            skips.append(x)
    if controlnet_down_residuals is not None:
        skips = [s + r.to(s.dtype) for s, r in zip(skips, controlnet_down_residuals)]
        x = skips[-1]

    x = unit(mid_layers, unet.mid_block, x)
    if cfg.need_refer_emb and mid_block_refer_emb is not None:
        x = ops.refer_fuse(unet.mid_block_refer_emb_attns, x, mid_block_refer_emb)
    if controlnet_mid_residual is not None:
        x = x + controlnet_mid_residual.to(x.dtype)

    for block in unet.up_blocks:
        for j in range(len(block.resnets)):
            x = torch.cat([x, skips.pop()], dim=-1)
            x = unit(layer, block, j, x)
        if hasattr(block, "upsamplers"):
            out_hw = skips[-1].shape[1:3] if skips else None
            x = block.upsamplers[0](x, out_hw=out_hw)

    x = unet.conv_norm_out(x, silu=True)
    return unet.conv_out(x)


def unet3d_apply(
    unet: UNet3D,
    sample: torch.Tensor,
    timestep,
    text_emb: torch.Tensor,
    *,
    condition_latents: Optional[torch.Tensor] = None,
    gen_index: Optional[Sequence[int]] = None,
    cond_index: Optional[Sequence[int]] = None,
    do_cfg: bool = False,
    motion_speed: float = 8.0,
    skip_temporal: bool = False,
    down_block_refer_embs: Optional[Sequence[torch.Tensor]] = None,
    mid_block_refer_emb: Optional[torch.Tensor] = None,
    refer_self_attn_embs: Optional[list] = None,
    refer_self_attn_mode: Optional[str] = None,
    vision_clip_emb: Optional[torch.Tensor] = None,
    ip_adapter_scale: float = 1.0,
    ip_adapter_face_emb: Optional[torch.Tensor] = None,
    ip_adapter_face_scale: float = 1.0,
    controlnet_down_residuals: Optional[Sequence[torch.Tensor]] = None,
    controlnet_mid_residual: Optional[torch.Tensor] = None,
    pose_guider_emb: Optional[torch.Tensor] = None,
    grad_checkpoint: bool = False,
) -> torch.Tensor:
    """Predict noise for a window of frames.

    sample (B, T_gen, H, W, C) noisy latents; timestep scalar or (B,);
    text_emb (B, S, D) or (B, T, S, D); condition_latents (B, n_vc, H, W, C)
    spliced in at ``cond_index``. ``down_block_refer_embs`` (12 tensors) and
    ``mid_block_refer_emb``, each (B, T_ref, h, w, c), are the ReferenceNet
    features fused at the referencenet preset's fuse sites;
    ``vision_clip_emb`` (B, S_ip, D) the IP-Adapter image tokens and
    ``ip_adapter_face_emb`` (B, S_f, D_f) the FaceID tokens.
    ``refer_self_attn_embs`` under ``refer_self_attn_mode`` "write" is a
    list that receives every spatial site's normalised self-attention input
    (B*T, HW, C); under "read", entry i (B, S_ref, C) joins site i's
    ReferenceOnly keys. ``grad_checkpoint`` recomputes the block layers in
    the backward (``unet3d_core``). Returns (B, T_total, H, W, C) over the
    spliced video (condition frames included).
    """
    if grad_checkpoint and refer_self_attn_embs is not None:
        raise ValueError("grad_checkpoint takes no refer_self_attn_embs: a recomputed layer "
                         "would write or read its site again")
    if condition_latents is not None:
        if gen_index is None or cond_index is None:
            raise ValueError("condition_latents need gen_index and cond_index")
        sample = splice_with_index(condition_latents, cond_index, sample, gen_index)
    b, num_frames, h0, w0, _ = sample.shape
    use_temporal = not skip_temporal
    temb, femb, text_ctx, clip_ctx, face_ctx, cond_mask = prepare_unet_inputs(
        unet, sample, timestep, text_emb, motion_speed=motion_speed,
        use_temporal=use_temporal, cond_index=cond_index, vision_clip_emb=vision_clip_emb,
        ip_adapter_face_emb=ip_adapter_face_emb,
    )
    ops = default_ops(
        unet, num_frames=num_frames, use_temporal=use_temporal, do_cfg=do_cfg,
        gen_index=gen_index, cond_index=cond_index, cond_mask=cond_mask, femb=femb,
        text_ctx=text_ctx, device=sample.device, clip_ctx=clip_ctx,
        ip_adapter_scale=ip_adapter_scale, face_ctx=face_ctx,
        ip_adapter_face_scale=ip_adapter_face_scale, refer_self_attn_embs=refer_self_attn_embs,
        refer_self_attn_mode=refer_self_attn_mode,
        grad_checkpoint=grad_checkpoint,
    )
    x = unet3d_core(
        unet, sample.reshape(b * num_frames, h0, w0, -1), temb, ops,
        down_block_refer_embs=down_block_refer_embs, mid_block_refer_emb=mid_block_refer_emb,
        controlnet_down_residuals=controlnet_down_residuals,
        controlnet_mid_residual=controlnet_mid_residual, pose_guider_emb=pose_guider_emb,
        grad_checkpoint=grad_checkpoint,
    )
    return x.reshape(b, num_frames, h0, w0, -1)
