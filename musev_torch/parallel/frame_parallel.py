"""Frame-parallel UNet execution (counterpart of
``musev_tpu/parallel/frame_parallel.py``): the frame rows of ALL context
windows sharded over the ranks of one mesh axis.

Window data parallelism ties the rank count to the window plan; here every
(window, CFG, frame) row of the denoise step is sharded, so any plan spreads
over all ranks: the default plan (3 windows of 12 + 1 frames, CFG: 78 rows)
is 10 rows a rank on 8 instead of 13. Almost all of the UNet is frame-local
(convs, resnets, spatial norms, cross-attention, feed-forward) and runs
unchanged on the local rows. The frame-mixing rest becomes three small
collective patterns:

* temporal conv (3 taps over T): a halo exchange (``ppermute``) of one
  boundary row per direction per CFG group, masked at window edges; the
  video GroupNorm's statistics take one all-reduce through the rows' slot
  one-hot;
* temporal attention (per pixel over T): an ``all_to_all`` from rows to a
  1/n slice of the pixels with every frame resident, the GroupNorm
  statistics all-reduced, then the unsharded path's own kernels: the pivot
  with the fused GroupNorm apply (K6), the temporal transformer's core with
  the packed short attention (K4) and the pivot back (K7); a second
  ``all_to_all`` returns the rows;
* ReferenceOnly self-attention: each window's vision-condition tokens are
  assembled by a one-hot row selector and an all-reduce, and every cond row
  attends to [own tokens; its window's vision tokens; ReferenceNet tokens]
  through the flash kernel (K3's long KV); uncond rows run plain
  self-attention (K1).

Under CFG the rows are sharded as two groups (uncond rows, cond rows), each
rank holding an equal slice of each, so the two attention forms stay apart
per tensor. The port runs one process per rank: every rank prepares the
embeddings of the whole batch, takes its rows, runs the local program with
its kernels on its shards, and ends with the full output (the all-gather
that ``fp_collective_model`` counts), so the scheduler step runs
replicated. ``StubComm`` runs one rank's program on one device with
collective-shaped data movement, the JAX package's single-chip measuring
mode.

The collectives are differentiable (the halo's backward shifts the other
way, an ``all_to_all``'s runs back, an all-reduce's all-reduces), so a loss
backpropagates through the program; the grads of replicated params are then
summed over the ranks (``train.sync_grads``).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.controlnet import controlnet_apply
from ..models.unet3d import UNet3D, UNet3DConfig, UNetOps, prepare_unet_inputs, unet3d_core
from ..models.unet_blocks import Attention, temporal_attn_bias
from ..ops.index_ops import splice_with_index
from ..ops.kernels.pivot import pivot_rows, unpivot_rows
from .mesh import all_reduce_sum, axis_group, gather_leading

# ---------------------------------------------------------------------------
# communication backends


def _ppermute(x: torch.Tensor, shift: int, group) -> torch.Tensor:
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    dst, src = (rank + shift) % n, (rank - shift) % n
    if dst == rank and dist.get_backend(group) == "gloo":
        return x.clone()  # gloo holds no pair to its own rank; NCCL sends to itself
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, dst), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int, group) -> torch.Tensor:
    """``lax.all_to_all(tiled=True)``: chunk j of ``split_axis`` goes to rank
    j; the chunks received are concatenated along ``concat_axis`` in rank
    order."""
    n = dist.get_world_size(group)
    chunks = torch.stack(x.chunk(n, dim=split_axis))
    out = torch.empty_like(chunks)
    dist.all_to_all_single(out, chunks, group=group)
    return torch.cat(out.unbind(0), dim=concat_axis)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, group):
        ctx.shift, ctx.group = shift, group
        return _ppermute(x, shift, group)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, -ctx.shift, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_axis, concat_axis, group):
        ctx.axes, ctx.group = (split_axis, concat_axis), group
        return _all_to_all(x, split_axis, concat_axis, group)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return _all_to_all(g, concat_axis, split_axis, ctx.group), None, None, None


class RealComm:
    """Collectives over one process group (one ``DeviceMesh`` dimension)."""

    def __init__(self, group):
        self.group = group
        self.n = dist.get_world_size(group)

    def psum(self, x):
        return all_reduce_sum(x, self.group)

    def ppermute(self, x, shift: int):
        """shift=+1: receive the left neighbour's value (rows flow forward);
        shift=-1: receive from the right."""
        return _PPermute.apply(x, shift, self.group)

    def all_to_all(self, x, split_axis: int, concat_axis: int):
        return _AllToAll.apply(x, split_axis, concat_axis, self.group)

    def all_gather(self, x):
        return gather_leading(x, self.group)

    def axis_index(self) -> int:
        return dist.get_rank(self.group)


class StubComm:
    """One rank's program on one device with collective-shaped data movement.

    Shapes, local operations and memory traffic are one rank's of the n-way
    program; values crossing ranks are fakes (``psum`` multiplies by n so
    normalisation statistics keep realistic magnitudes; ``ppermute`` is the
    identity; ``all_to_all`` splits and concatenates locally), and the time
    of the links is left to the payload model (``fp_collective_model``)."""

    def __init__(self, n: int):
        self.n = n

    def psum(self, x):
        return x * self.n

    def ppermute(self, x, shift: int):
        return x

    def all_to_all(self, x, split_axis: int, concat_axis: int):
        return torch.cat(x.chunk(self.n, dim=split_axis), dim=concat_axis)

    def all_gather(self, x):
        return x.repeat(self.n, *([1] * (x.ndim - 1)))

    def axis_index(self) -> int:
        return 0


# ---------------------------------------------------------------------------
# static row-shard metadata


@dataclasses.dataclass(frozen=True)
class GroupMeta:
    """One CFG group's frame rows, flattened (batch-entry-major) and padded
    to the rank count."""

    n_batch: int  # window-batch entries in the group
    t: int  # frames per entry (vision-condition frames included)
    n: int  # ranks
    use_ref: bool  # concat-KV reference attention for these rows

    @property
    def rows(self) -> int:
        return self.n_batch * self.t

    @property
    def rows_pad(self) -> int:
        return -(-self.rows // self.n) * self.n

    @property
    def local(self) -> int:
        return self.rows_pad // self.n

    @property
    def pad(self) -> int:
        return self.rows_pad - self.rows

    def pad_index(self) -> np.ndarray:
        """Row gather map (rows_pad,) duplicating head rows into the pad."""
        return np.arange(self.rows_pad) % self.rows


@dataclasses.dataclass(frozen=True)
class FPMeta:
    n: int
    groups: Tuple[GroupMeta, ...]
    cond_index: Optional[Tuple[int, ...]]

    @property
    def local_total(self) -> int:
        return sum(g.local for g in self.groups)

    def block_starts(self) -> List[int]:
        starts = [0]
        for g in self.groups:
            starts.append(starts[-1] + g.local)
        return starts

    def batch_starts(self) -> List[int]:
        starts = [0]
        for g in self.groups:
            starts.append(starts[-1] + g.n_batch)
        return starts


def _shard_rows(arr: torch.Tensor, g: GroupMeta, b_start: int,
                rank: Optional[int] = None) -> torch.Tensor:
    """Slice a (B_total*T, ...) row tensor to the group, padded to rows_pad;
    with ``rank``, only that rank's ``g.local`` rows of it."""
    idx = g.pad_index()
    if rank is not None:
        idx = idx[rank * g.local:(rank + 1) * g.local]
    rows = arr[b_start * g.t:(b_start + g.n_batch) * g.t]
    return rows.index_select(0, torch.as_tensor(idx, device=arr.device))


def _row_ids(g: GroupMeta, slot_offset: int) -> Dict[str, np.ndarray]:
    """Static per-row bookkeeping arrays for one group (padded length)."""
    idx = g.pad_index()
    win = (np.arange(g.rows) // g.t)[idx].astype(np.int32)
    t_id = (np.arange(g.rows) % g.t)[idx].astype(np.int32)
    valid = (np.arange(g.rows_pad) < g.rows).astype(np.float32)
    return {
        "win": win,
        "t": t_id,
        "slot": (win + slot_offset).astype(np.int32),
        "valid": valid,
        "mask_prev": ((t_id > 0).astype(np.float32) * valid),
        "mask_next": ((t_id < g.t - 1).astype(np.float32) * valid),
    }


# ---------------------------------------------------------------------------
# collective building blocks (on concatenated local row tensors)


def _neighbor_shift(x: torch.Tensor, comm, meta: FPMeta, direction: int) -> torch.Tensor:
    """Previous (direction=-1) or next (+1) row aligned with the local
    concat-of-groups rows; window-edge rows get a wrapped row, which the
    caller masks."""
    starts = meta.block_starts()
    n_groups = len(meta.groups)
    if direction == -1:
        recv = comm.ppermute(x[[starts[i + 1] - 1 for i in range(n_groups)]], shift=+1)
        parts = []
        for i in range(n_groups):
            parts += [recv[i:i + 1], x[starts[i]:starts[i + 1] - 1]]
        return torch.cat(parts, dim=0)
    recv = comm.ppermute(x[[starts[i] for i in range(n_groups)]], shift=-1)
    parts = []
    for i in range(n_groups):
        parts += [x[starts[i] + 1:starts[i + 1]], recv[i:i + 1]]
    return torch.cat(parts, dim=0)


def _group_onehot(c: int, num_groups: int, device) -> torch.Tensor:
    return (torch.arange(c, device=device)[:, None] // (c // num_groups)
            == torch.arange(num_groups, device=device)[None, :]).float()


def _group_scale_shift(norm, s1: torch.Tensor, s2: torch.Tensor, count: int):
    """GroupNorm's float32 (N, C) scale and shift from per-channel sums
    (N, C) of x and x^2 over ``count`` elements per (entry, group), in the
    JAX package's one-pass form."""
    c = s1.shape[-1]
    onehot = _group_onehot(c, norm.num_groups, s1.device)
    mean_g = (s1 @ onehot) / count
    var_g = torch.clamp((s2 @ onehot) / count - mean_g * mean_g, min=0.0)
    inv_g = torch.rsqrt(var_g + norm.eps)
    scale = (inv_g @ onehot.t()) * norm.weight.float()[None, :]
    shift = norm.bias.float()[None, :] - (mean_g @ onehot.t()) * scale
    return scale, shift


def _fp_group_norm_video(norm, v: torch.Tensor, comm, slot_onehot: torch.Tensor,
                         slot_ids: torch.Tensor, count: int) -> torch.Tensor:
    """5-D GroupNorm (stats over T, H, W per batch entry) on local row
    shards: v (L, H, W, C); slot_onehot (L, B_total) float32 with pad rows
    zeroed; ``count`` = T*H*W*(C/G) true elements per (entry, group)."""
    vf = v.float()
    stats = torch.cat([vf.sum(dim=(1, 2)), vf.square().sum(dim=(1, 2))], dim=-1)
    stats = comm.psum(slot_onehot.t() @ stats)  # (B_total, 2C): one all-reduce
    scale, shift = _group_scale_shift(norm, *stats.chunk(2, dim=-1), count)
    y = vf * scale[slot_ids][:, None, None, :] + shift[slot_ids][:, None, None, :]
    return y.to(v.dtype)


def _fp_conv_temporal(conv, v: torch.Tensor, comm, meta: FPMeta, mask_prev: torch.Tensor,
                      mask_next: torch.Tensor) -> torch.Tensor:
    """The 3-tap temporal conv (``models.common.TemporalConv``) on row
    shards by halo exchange; its zero padding at window edges becomes the
    row masks."""
    w = conv.weight[:, :, :, 0, 0].to(v.dtype)  # (O, I, 3)
    pv = _neighbor_shift(v, comm, meta, -1) * mask_prev[:, None, None, None].to(v.dtype)
    nx = _neighbor_shift(v, comm, meta, +1) * mask_next[:, None, None, None].to(v.dtype)
    y = pv @ w[:, :, 0].t() + v @ w[:, :, 1].t() + nx @ w[:, :, 2].t()
    return y + conv.bias.to(v.dtype)


def _fp_gn_pixel_scale_shift(norm, y: torch.Tensor, comm, count: int):
    """The 5-D GroupNorm's float32 (B, C) scale and shift after the pixel
    pivot: y (B, T, S_local, C), stats over (T, S) with the pixel axis
    sharded, partial sums all-reduced. Zero pixel padding adds nothing;
    ``count`` is the true element count."""
    yf = y.float()
    stats = torch.cat([yf.sum(dim=(1, 2)), yf.square().sum(dim=(1, 2))], dim=-1)
    return _group_scale_shift(norm, *comm.psum(stats).chunk(2, dim=-1), count)


# ---------------------------------------------------------------------------
# the local (per-rank) UNet program


def _local_ops(unet: UNet3D, meta: FPMeta, comm, rows: Dict[str, Any], ids: List[dict],
               reps: Dict[str, Any], *, ip_adapter_scale: float, ip_adapter_face_scale: float,
               use_temporal: bool, refer_read: bool) -> UNetOps:
    cfg = unet.cfg
    starts, bstarts = meta.block_starts(), meta.batch_starts()
    n, b_total = meta.n, meta.batch_starts()[-1]
    cond_index = meta.cond_index
    n_vc = len(cond_index) if cond_index else 0
    t = meta.groups[0].t
    device = rows["x"].device
    slot_ids = rows["slot"]
    slot_onehot = F.one_hot(slot_ids, b_total).float() * rows["valid"][:, None]
    femb = reps.get("femb")
    refer_tokens = reps.get("refer_self_attn")  # list of (B_total, S, C) or None entries
    sp_grids = reps.get("sp_grids")  # {(h, w): (hw_pad, D)}
    bias = temporal_attn_bias(cfg.temporal_self_attn_mask, t, cfg.temporal_attn_n_near,
                              device) if use_temporal else None

    def temporal_conv(mod, x):
        v = x
        for stage in (mod.conv1, mod.conv2, mod.conv3, mod.conv4):
            norm = stage[0]
            count = t * v.shape[1] * v.shape[2] * (v.shape[-1] // norm.num_groups)
            v = F.silu(_fp_group_norm_video(norm, v, comm, slot_onehot, slot_ids, count))
            v = _fp_conv_temporal(stage[-1], v, comm, meta, rows["mask_prev"],
                                  rows["mask_next"])
        v = v * rows["cond_mask"][:, None, None, None].to(v.dtype)
        return x + mod.temporal_weight.abs().to(v.dtype) * v

    def temporal_attn(mod, x):
        h, w, c = x.shape[1:]
        hw = h * w
        px_pad = (-hw) % n
        px_l = (hw + px_pad) // n
        ys = []
        for gi, g in enumerate(meta.groups):
            xg = x[starts[gi]:starts[gi + 1]].reshape(g.local, hw, c)
            if px_pad:
                xg = F.pad(xg, (0, 0, 0, px_pad))
            yg = comm.all_to_all(xg, split_axis=1, concat_axis=0)
            ys.append(yg[:g.rows].reshape(g.n_batch, t, px_l, c))
        y = torch.cat(ys, dim=0)  # (B_total, T, px_l, C)
        count = t * hw * (c // mod.norm.num_groups)
        scale, shift = _fp_gn_pixel_scale_shift(mod.norm, y, comm, count)
        scale, shift = (s[:, None].expand(b_total, t, c) for s in (scale, shift))
        sp = None
        if sp_grids is not None and (h, w) in sp_grids:
            i0 = comm.axis_index() * px_l
            sp = sp_grids[(h, w)][i0:i0 + px_l]
        y = mod.core(pivot_rows(y, scale, shift), femb, sp, bias)
        y = unpivot_rows(y)  # (B_total, T, px_l, C)
        outs = []
        for gi, g in enumerate(meta.groups):
            yg = y[bstarts[gi]:bstarts[gi + 1]].reshape(g.rows, px_l, c)
            if g.pad:
                yg = torch.cat([yg, yg.new_zeros(g.pad, px_l, c)], dim=0)
            yg = comm.all_to_all(yg, split_axis=0, concat_axis=1)
            outs.append(yg[:, :hw].reshape(g.local, h, w, c))
        yv = torch.cat(outs, dim=0) * rows["cond_mask"][:, None, None, None].to(x.dtype)
        return x + mod.temporal_weight.abs().to(yv.dtype) * yv

    # slot k = window * n_vc + position in cond_index: each use_ref group's
    # one-hot selector of its rows' vision-condition frames (host arrays)
    selectors = {}
    for gi, g in enumerate(meta.groups):
        if g.use_ref and n_vc and g.t > 1:
            gid = ids[gi]
            memb = np.isin(gid["t"], cond_index).astype(np.float32) * gid["valid"]
            pos = np.zeros_like(gid["t"])
            for j, ci in enumerate(cond_index):
                pos = np.where(gid["t"] == ci, j, pos)
            sel = np.eye(g.n_batch * n_vc, dtype=np.float32)[gid["win"] * n_vc + pos]
            selectors[gi] = torch.from_numpy(sel * memb[:, None]).to(device)

    def reference_attention(attn, norm_h, read_tokens):
        hw, c = norm_h.shape[1], norm_h.shape[2]
        outs = []
        for gi, g in enumerate(meta.groups):
            part = norm_h[starts[gi]:starts[gi + 1]]
            if not g.use_ref:
                outs.append(attn(part))
                continue
            kv = [part]
            if gi in selectors:
                vis = comm.psum(torch.einsum("lk,lsc->ksc",
                                             selectors[gi].to(part.dtype), part))
                win = torch.as_tensor(ids[gi]["win"], dtype=torch.long, device=device)
                kv.append(vis.reshape(g.n_batch, n_vc * hw, c)[win])
            if read_tokens is not None:
                slot = torch.as_tensor(ids[gi]["slot"], dtype=torch.long, device=device)
                kv.append(read_tokens[slot].to(part.dtype))
            if len(kv) == 1:
                outs.append(attn(part))
                continue
            outs.append(attn(part, context=torch.cat(kv, dim=1)))
        return torch.cat(outs, dim=0)

    site = itertools.count()  # the spatial sites in call order

    def spatial(mod, x):
        i = next(site)
        read = refer_tokens[i] if refer_read and refer_tokens is not None else None
        return mod(x, rows["text"], num_frames=1, cond_index=None, do_cfg=False,
                   reference_attn=cfg.reference_attn, vision_clip_tokens=rows["clip"],
                   ip_adapter_scale=ip_adapter_scale, face_tokens=rows["face"],
                   ip_adapter_face_scale=ip_adapter_face_scale,
                   ref_attn_fn=lambda attn, norm_h: reference_attention(attn, norm_h, read))

    def refer_fuse(mod, x, emb):
        # emb (B_total, T_ref, h, w, C) replicated -> per-row tokens by slot
        c = x.shape[-1]
        tokens = x.reshape(x.shape[0], -1, c)
        ref = emb.reshape(b_total, -1, c)[slot_ids].to(tokens.dtype)
        out = Attention.forward(mod, tokens, context=torch.cat([ref, tokens], dim=1))
        return out.reshape(x.shape) + x

    return UNetOps(spatial=spatial, temporal_conv=temporal_conv, temporal_attn=temporal_attn,
                   refer_fuse=refer_fuse, adain=lambda x: x, use_temporal=use_temporal)


# ---------------------------------------------------------------------------
# public entry


def unet3d_apply_fp(
    unet: UNet3D,
    sample: torch.Tensor,
    timestep,
    text_emb: torch.Tensor,
    *,
    axis: str = "fp",
    comm=None,
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
    controlnet: Optional[Dict[str, Any]] = None,
    grad_checkpoint: bool = False,
) -> torch.Tensor:
    """``unet3d_apply`` with the frame rows sharded over the ranks of mesh
    axis ``axis`` of the ambient mesh (``parallel.mesh.set_mesh``), or over
    ``comm`` where given; same arguments and result, the full (B, T, H, W,
    C) on every rank.

    ``comm=StubComm(n)`` runs one rank's n-way program on this device (the
    JAX package's ``stub_devices``, the measuring mode): the output is one
    shard's rows tiled to the full shape, fake at the collective points,
    and faithful in its local work. ``controlnet``: run the ControlNet trunk(s) on the local
    rows inside the program; a dict of ``nets``, ``scales``, ``images``
    (one (B*T, 8H, 8W, 3) row tensor per net, window-gathered) and the
    scalar ``timestep``."""
    cfg = unet.cfg
    if cfg.adain_fix:
        raise NotImplementedError("frame-parallel: adain_fix not supported")
    if refer_self_attn_mode == "write":
        raise NotImplementedError("frame-parallel: ReferenceNet write mode runs unsharded")
    if condition_latents is not None:
        if gen_index is None or cond_index is None:
            raise ValueError("condition_latents need gen_index and cond_index")
        sample = splice_with_index(condition_latents, cond_index, sample, gen_index)
    b, num_frames, h0, w0, cin = sample.shape
    use_temporal = not skip_temporal
    if comm is None:
        comm = RealComm(axis_group(axis))
    n = comm.n
    rank = comm.axis_index()

    temb, femb, text_ctx, clip_ctx, face_ctx, cond_mask = prepare_unet_inputs(
        unet, sample, timestep, text_emb, motion_speed=motion_speed,
        use_temporal=use_temporal, cond_index=cond_index, vision_clip_emb=vision_clip_emb,
        ip_adapter_face_emb=ip_adapter_face_emb)

    ci = tuple(int(i) for i in cond_index) if cond_index is not None else None
    base_use_ref = (ci is not None and num_frames > 1) or (
        refer_self_attn_mode == "read" and refer_self_attn_embs is not None)
    if do_cfg:
        half = b // 2
        metas = (GroupMeta(half, num_frames, n, use_ref=False),
                 GroupMeta(half, num_frames, n, use_ref=base_use_ref))
        group_b_starts = (0, half)
    else:
        metas = (GroupMeta(b, num_frames, n, use_ref=base_use_ref),)
        group_b_starts = (0,)
    meta = FPMeta(n=n, groups=metas, cond_index=ci)

    device = sample.device
    rows_all = sample.reshape(b * num_frames, h0, w0, cin)
    if cond_mask is None:
        cond_mask = torch.ones(num_frames, dtype=rows_all.dtype, device=device)
    row_inputs = dict(x=rows_all, temb=temb, text=text_ctx, clip=clip_ctx, face=face_ctx,
                      pose=pose_guider_emb, cn_mid=controlnet_mid_residual)
    if controlnet is not None:
        for i, img in enumerate(controlnet["images"]):
            row_inputs[f"cn_img{i}"] = img
    per_group, ids = [], []
    slot_off = 0
    for g, bs in zip(metas, group_b_starts):
        gid = {k: v[rank * g.local:(rank + 1) * g.local]
               for k, v in _row_ids(g, slot_off).items()}
        gd = {k: None if v is None else _shard_rows(v, g, bs, rank)
              for k, v in row_inputs.items()}
        gd["cn_down"] = None if controlnet_down_residuals is None else [
            _shard_rows(r, g, bs, rank) for r in controlnet_down_residuals]
        gd["cond_mask"] = cond_mask[torch.as_tensor(gid["t"], dtype=torch.long, device=device)]
        for k in ("slot", "valid", "mask_prev", "mask_next"):
            v = torch.from_numpy(gid[k]).to(device)
            gd[k] = v.long() if k == "slot" else v
        per_group.append(gd)
        ids.append(gid)
        slot_off += g.n_batch

    def cat(key):
        vals = [gd[key] for gd in per_group]
        return None if any(v is None for v in vals) else torch.cat(vals, dim=0)

    rows = {k: cat(k) for k in per_group[0] if k != "cn_down"}
    cn_down = None
    if per_group[0]["cn_down"] is not None:
        cn_down = [torch.cat([gd["cn_down"][i] for gd in per_group], dim=0)
                   for i in range(len(per_group[0]["cn_down"]))]
    cn_mid = rows["cn_mid"]
    if controlnet is not None:
        # the ControlNet trunk is frame-local: each rank computes its own
        # rows' residuals, from exactly the spliced rows the UNet gets
        for i, (net, scale) in enumerate(zip(controlnet["nets"], controlnet["scales"])):
            d_i, m_i = controlnet_apply(net, rows["x"], controlnet["timestep"], rows["text"],
                                        rows[f"cn_img{i}"], conditioning_scale=scale)
            if cn_down is None:
                cn_down, cn_mid = list(d_i), m_i
            else:
                cn_down = [a + d for a, d in zip(cn_down, d_i)]
                cn_mid = cn_mid + m_i

    reps: Dict[str, Any] = {"femb": femb}
    if refer_self_attn_mode == "read" and refer_self_attn_embs is not None:
        reps["refer_self_attn"] = list(refer_self_attn_embs)
    if cfg.need_spatial_position_emb:
        reps["sp_grids"] = _spatial_grids(unet, h0, w0, n, sample.dtype, device)
    ops = _local_ops(unet, meta, comm, rows, ids, reps, ip_adapter_scale=ip_adapter_scale,
                     ip_adapter_face_scale=ip_adapter_face_scale, use_temporal=use_temporal,
                     refer_read=refer_self_attn_mode == "read")
    y = unet3d_core(unet, rows["x"], rows["temb"], ops,
                    down_block_refer_embs=down_block_refer_embs,
                    mid_block_refer_emb=mid_block_refer_emb,
                    controlnet_down_residuals=cn_down, controlnet_mid_residual=cn_mid,
                    pose_guider_emb=rows["pose"], grad_checkpoint=grad_checkpoint)

    # every rank's local rows, gathered in one call: rank-major blocks of
    # the groups' local rows, reassembled in the original batch order
    full = comm.all_gather(y).reshape(n, meta.local_total, h0, w0, -1)
    starts = meta.block_starts()
    parts = []
    for gi, g in enumerate(metas):
        out = full[:, starts[gi]:starts[gi + 1]].reshape(g.rows_pad, h0, w0, -1)
        parts.append(out[:g.rows].reshape(g.n_batch, num_frames, h0, w0, -1))
    return torch.cat(parts, dim=0)


def fp_collective_model(
    cfg: UNet3DConfig,
    *,
    t: int,
    h0: int,
    w0: int,
    n: int,
    n_windows: int,
    do_cfg: bool = True,
    n_vc: int = 1,
    itemsize: int = 2,
) -> Dict[str, float]:
    """Arithmetic model of ONE denoise step of the frame-parallel program:
    walks the UNet structure and sums each rank's collective payload bytes
    and collective calls, so the communication term of a multi-device
    projection is derived, not measured.

    Patterns counted (see the module docstring):
      * temporal conv: per site, 4 sublayers x 2 directions of halo
        exchanges of one boundary row per CFG group, plus 4 GroupNorm stats
        all-reduces
      * temporal attention: per site, 2 all_to_alls per CFG group moving
        (n-1)/n of the local rows, plus 1 stats all-reduce
      * ReferenceOnly spatial attention: per site, 1 all-reduce of the
        (n_windows, n_vc*HW, C) vision-token block (ring: 2(n-1)/n)
      * the all-gather of the output rows for the replicated overlap
        scatter-add and scheduler step

    ``h0/w0`` are LATENT-resolution dims.
    """
    reps = 2 if do_cfg else 1
    rows_g = n_windows * t
    local_g = -(-rows_g // n)
    l_tot = reps * local_g
    levels = len(cfg.block_out_channels)
    res = []
    h, w = h0, w0
    for _ in range(levels):
        res.append((h, w))
        h, w = -(-h // 2), -(-w // 2)

    sites: List[Tuple[int, str]] = []
    for i, btype in enumerate(cfg.down_block_types):
        for _ in range(cfg.layers_per_block):
            if cfg.temporal_conv:
                sites.append((i, "tconv"))
            if "CrossAttn" in btype:
                if cfg.temporal_transformer:
                    sites.append((i, "tattn"))
                sites.append((i, "spatial"))
    if cfg.temporal_conv:
        sites += [(levels - 1, "tconv")] * 2
    if cfg.temporal_transformer:
        sites.append((levels - 1, "tattn"))
    sites.append((levels - 1, "spatial"))
    for j, btype in enumerate(cfg.up_block_types):
        lev = levels - 1 - j
        for _ in range(cfg.layers_per_block + 1):
            if cfg.temporal_conv:
                sites.append((lev, "tconv"))
            if "CrossAttn" in btype:
                if cfg.temporal_transformer:
                    sites.append((lev, "tattn"))
                sites.append((lev, "spatial"))
    if cfg.need_transformer_in and cfg.temporal_transformer:
        sites.append((0, "tattn"))

    halo = a2a = vis = gn = 0.0
    # calls by collective kind: halos run per sublayer x direction (the
    # groups' rows move in one call), GN-stats all-reduces once per site
    # over stats stacked across CFG groups, the pixel all_to_alls per group
    counts = {"collective_permute": 0, "all_reduce": 0, "all_to_all": 0}
    ring = 2.0 * (n - 1) / n  # all-reduce bytes factor
    ag = (n - 1) / n  # all-gather / all_to_all bytes factor
    for lev, kind in sites:
        hh, ww = res[lev]
        c = cfg.block_out_channels[lev]
        row_b = hh * ww * c * itemsize
        if kind == "tconv":
            halo += 4 * 2 * reps * row_b  # 1 boundary row/group/dir/sublayer
            gn += 4 * ring * (reps * n_windows) * 2 * c * 4  # f32 moments
            counts["collective_permute"] += 4 * 2
            counts["all_reduce"] += 4
        elif kind == "tattn":
            hw_pad = -(-hh * ww // n) * n
            a2a += 2 * ag * l_tot * hw_pad * c * itemsize
            gn += ring * (reps * n_windows) * 2 * c * 4
            counts["all_to_all"] += 2 * reps
            counts["all_reduce"] += 1
        elif kind == "spatial" and n_vc > 0 and t > 1:
            vis += ring * n_windows * n_vc * hh * ww * c * itemsize
            counts["all_reduce"] += 1
    out_gather = ag * reps * rows_g * h0 * w0 * cfg.out_channels * itemsize
    counts["all_gather"] = 1
    n_coll = sum(counts.values())
    total = halo + a2a + vis + gn + out_gather
    return {
        "bytes_per_step": total,
        "halo_bytes": halo,
        "a2a_bytes": a2a,
        "vis_psum_bytes": vis,
        "gn_psum_bytes": gn,
        "out_gather_bytes": out_gather,
        "collectives_per_step": n_coll,
        "counts_by_kind": counts,
        "local_rows": l_tot,
    }


def _spatial_grids(unet: UNet3D, h0: int, w0: int, n: int, dtype, device):
    """Per-resolution projected sin-cos grids, zero-padded to the sharded
    pixel count."""
    cfg = unet.cfg
    grids = {}
    h, w = h0, w0
    for _ in range(len(cfg.block_out_channels)):
        sp = unet.spatial_position_embedding(unet.spatial_grid(h, w, device).to(dtype))
        pad = (-(h * w)) % n
        grids[(h, w)] = F.pad(sp, (0, 0, 0, pad)) if pad else sp
        h, w = -(-h // 2), -(-w // 2)
    return grids
