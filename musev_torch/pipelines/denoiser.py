"""The VCPD denoise engine (counterpart of ``musev_tpu/pipelines/denoiser.py``).

Each step runs all context windows and both CFG halves as ONE batched UNet
call, then averages the window overlaps with one scatter-add divided by the
coverage counts (reference pipeline_controlnet.py:2076-2079), combines the
CFG halves and takes the scheduler step. The JAX package scans a compiled
step; here the step loop is plain Python. Latents and scheduler math stay in
float32; only the UNet input is cast to the UNet's dtype.

With a ControlNet (a module, or a list of modules whose residuals add up: the
MultiControlNet) each step gathers every window's control frames, [the
condition frames' maps; the window's maps], and runs the ControlNet over the
spliced (condition + window) latents of both CFG halves with per-frame text,
once per UNet call (reference pipeline_controlnet.py:1947-2038). A PoseGuider
embeds the same gathered frames.

Serial denoise (reference pipeline_controlnet.py:1846-2136): a shot may
record, per step, the tail ``video_overlap`` frames of its latents and noise
predictions, and the next shot blends them into its head
(``fuse_part_tensor``); ``record_step_latents`` keeps every step's latents.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..models.controlnet import (
    ControlNet,
    ControlNetConfig,
    PoseGuider,
    controlnet_apply,
    pose_guider_apply,
)
from ..models.unet3d import UNet3D, UNet3DConfig, unet3d_apply
from ..ops.context import WindowPlan
from ..ops.index_ops import fuse_part_tensor, take_frames
from ..parallel.context import sharding_ctx
from ..parallel.frame_parallel import StubComm, unet3d_apply_fp
from ..parallel.mesh import batch_sharding, replicated
from ..schedulers import Scheduler
from ..utils.image_util import rescale_noise_cfg


@dataclasses.dataclass(frozen=True, eq=False)
class DenoiseSpec:
    """Configuration of one VCPD denoise run (the fields this path uses)."""

    unet_cfg: UNet3DConfig
    scheduler: Scheduler
    plan: WindowPlan  # or a StackedWindowPlan (per-step 'uniform' schedule)
    guidance: np.ndarray  # (num_steps,) per-step CFG scale
    n_vision_cond: int = 0
    do_cfg: bool = True
    # the stochastic samplers' noise (the reference's noise_type contract)
    w_ind_noise: float = 0.5
    noise_type: str = "video_fusion"
    motion_speed: float = 8.0
    ip_adapter_scale: float = 1.0
    ip_adapter_face_scale: float = 1.0
    # CFG rescale (arXiv:2305.08891 §3.4) of the combined noise; 0 is off
    guidance_rescale: float = 0.0
    skip_temporal: bool = False
    # serial-denoise carry: the tail video_overlap frames of every step's
    # latents and noise are recorded for the next shot
    video_overlap: int = 0
    record_mid_video: bool = False
    # every step's latents (the reference's need_middle_latents, :2138-2139)
    record_step_latents: bool = False
    # img2img strength: only steps [start_step, num_steps) run (reference
    # get_timesteps, pipeline_controlnet.py:1627-1641)
    start_step: int = 0
    # set to apply the ControlNet / PoseGuider passed to predict_noise; a
    # tuple of configs and of scales for a MultiControlNet
    controlnet_cfg: Optional[Union[ControlNetConfig, Tuple[ControlNetConfig, ...]]] = None
    controlnet_scale: Union[float, Tuple[float, ...]] = 1.0
    pose_guider_cfg: Optional[ControlNetConfig] = None
    # mesh axes of the ambient mesh (parallel.mesh.set_mesh): dp shards the
    # window x CFG batch, each rank computing its share of the rows; sp
    # sends long self-attention to ring attention; tp only names the axis
    # the UNet was split over and marks the exclusion below: the split is
    # carried by the modules parallel.sharding.shard_params_tp builds
    dp_axis: Optional[str] = None
    tp_axis: Optional[str] = None
    sp_axis: Optional[str] = None
    # frame parallelism (parallel.frame_parallel): every (window, cfg,
    # frame) row sharded over this axis; excludes dp, tp and sp
    fp_axis: Optional[str] = None
    # one rank's frame-parallel program on this device with StubComm (the
    # measuring mode): outputs fake at the collective points
    fp_stub_devices: Optional[int] = None

    def __post_init__(self):
        if (self.fp_axis is not None or self.fp_stub_devices is not None) and (
                self.dp_axis or self.tp_axis or self.sp_axis):
            raise ValueError("frame parallelism (fp_axis, fp_stub_devices) excludes dp_axis, "
                             "tp_axis and sp_axis")


def _as_list(x) -> list:
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _map_rows(fn, v):
    """``fn`` over a row tensor, or over each entry of a list of them (None
    kept)."""
    if isinstance(v, list):
        return [None if e is None else fn(e) for e in v]
    return None if v is None else fn(v)


def predict_noise(
    unet: UNet3D,
    spec: DenoiseSpec,
    latents: torch.Tensor,
    step_index: int,
    text_uc: Optional[torch.Tensor],
    text_c: torch.Tensor,
    condition_latents: Optional[torch.Tensor] = None,
    vision_clip_emb: Optional[torch.Tensor] = None,
    ip_adapter_face_emb: Optional[torch.Tensor] = None,
    refer_embs: Optional[Sequence[torch.Tensor]] = None,
    mid_refer_emb: Optional[torch.Tensor] = None,
    refer_self_attn_embs: Optional[Sequence[Optional[torch.Tensor]]] = None,
    controlnet: Union[ControlNet, Sequence[ControlNet], None] = None,
    control_images: Union[torch.Tensor, Sequence[torch.Tensor], None] = None,
    pose_guider: Optional[PoseGuider] = None,
) -> torch.Tensor:
    """One VCPD noise prediction over all windows; latents (B, T, h, w, C).

    ``vision_clip_emb`` (2B, S_ip, D) and ``ip_adapter_face_emb`` (2B, S_f,
    D_f) hold the IP-Adapter and FaceID tokens as [uncond; cond];
    ``refer_embs`` / ``mid_refer_emb`` (B, N, h, w, c) the ReferenceNet
    features, shared by both CFG halves (pipeline_controlnet.py:845), and
    ``refer_self_attn_embs`` its self-attention embeddings (B, S, c) per
    spatial site, read as extra ReferenceOnly keys (None entries are
    skipped). ``control_images`` (B, n_vc + T, 8h, 8w, 3) in [0, 1], the
    condition frames' maps at the head, or one such tensor per ControlNet;
    the PoseGuider takes the first. Returns the CFG-combined noise
    (B, T, h, w, C) in float32, the same on every rank of a mesh.

    Under ``spec.fp_axis`` (or ``fp_stub_devices``) the UNet call is the
    frame-parallel program, with the ControlNet inside it on each rank's
    rows. Under ``spec.dp_axis`` each rank runs the UNet (and ControlNet and
    PoseGuider) on its contiguous share of each CFG half's window rows, each
    half padded to a multiple of the axis size, and the outputs are
    gathered."""
    with sharding_ctx(dp=spec.dp_axis, tp=spec.tp_axis, sp=spec.sp_axis):
        return _predict_noise(unet, spec, latents, step_index, text_uc, text_c,
                              condition_latents, vision_clip_emb, ip_adapter_face_emb, refer_embs,
                              mid_refer_emb, refer_self_attn_embs, controlnet, control_images,
                              pose_guider)


def _predict_noise(unet, spec, latents, step_index, text_uc, text_c, condition_latents,
                   vision_clip_emb, ip_adapter_face_emb, refer_embs, mid_refer_emb,
                   refer_self_attn_embs, controlnet, control_images, pose_guider):
    b, t, h, w, c = latents.shape
    plan = spec.plan
    n_win, wlen = plan.n_windows, plan.window_size
    windows = plan.windows[step_index] if plan.per_step else plan.windows
    counts = plan.counts[step_index] if plan.per_step else plan.counts
    flat_idx = windows.reshape(-1).tolist()
    dtype = next(unet.parameters()).dtype

    scaled = spec.scheduler.scale_model_input(latents, step_index)
    win = take_frames(scaled, flat_idx).reshape(b * n_win, wlen, h, w, c)
    reps = 2 if spec.do_cfg else 1
    model_in = torch.cat([win] * reps, dim=0).to(dtype)

    def tile_rows(e: torch.Tensor) -> torch.Tensor:
        """Align a conditioning tensor to the window-folded CFG batch: (B, ...)
        repeats to both halves; (2B, ...) under CFG keeps its two halves."""
        if spec.do_cfg and e.shape[0] == 2 * b:
            e = e.reshape(2, b, *e.shape[1:]).repeat_interleave(n_win, dim=1)
            return e.reshape(2 * b * n_win, *e.shape[2:]).to(dtype)
        return torch.cat([e.repeat_interleave(n_win, 0)] * reps, dim=0).to(dtype)

    if spec.do_cfg:
        if text_uc is None:
            raise ValueError("do_cfg needs text_uc")
        text = torch.cat([text_uc.repeat_interleave(n_win, 0),
                          text_c.repeat_interleave(n_win, 0)], dim=0)
    else:
        text = text_c.repeat_interleave(n_win, 0)

    cond = gen_index = cond_index = None
    n_vc = spec.n_vision_cond
    if condition_latents is not None and n_vc > 0:
        cond = tile_rows(condition_latents)
        cond_index = tuple(range(n_vc))
        gen_index = tuple(range(n_vc, n_vc + wlen))

    use_cn = controlnet is not None and spec.controlnet_cfg is not None
    use_pg = pose_guider is not None and spec.pose_guider_cfg is not None
    ctrl = []  # (rows, n_vc + wlen, 8h, 8w, 3) per control tensor
    if use_cn or use_pg:
        if control_images is None:
            raise ValueError("the ControlNet and the PoseGuider need control_images")
        # per-window control frames: [the condition frames' maps; the window's]
        idx = windows + n_vc
        if n_vc > 0:
            idx = np.concatenate([np.broadcast_to(np.arange(n_vc), (n_win, n_vc)), idx], 1)
        idx = torch.as_tensor(idx.reshape(-1), dtype=torch.long)
        for imgs in _as_list(control_images):
            g = imgs.index_select(1, idx.to(imgs.device))
            g = g.reshape(b * n_win, n_vc + wlen, *imgs.shape[2:])
            ctrl.append(torch.cat([g] * reps, dim=0).to(dtype))

    t_step = float(spec.scheduler.timesteps[step_index])
    unet_kw = dict(
        down_block_refer_embs=None if refer_embs is None else [tile_rows(e) for e in refer_embs],
        mid_block_refer_emb=None if mid_refer_emb is None else tile_rows(mid_refer_emb),
        refer_self_attn_embs=None if refer_self_attn_embs is None else [
            None if e is None else tile_rows(e) for e in refer_self_attn_embs],
        vision_clip_emb=None if vision_clip_emb is None else tile_rows(vision_clip_emb),
        ip_adapter_face_emb=None if ip_adapter_face_emb is None else tile_rows(
            ip_adapter_face_emb),
    )
    rows = model_in.shape[0]
    fp = spec.fp_axis is not None or spec.fp_stub_devices is not None
    groups = 2 if spec.do_cfg else 1
    if spec.dp_axis is not None:
        # each CFG half sharded on its own: every rank holds [uncond_i;
        # cond_i], so the UNet's B // 2 split holds on the local rows
        local = functools.partial(batch_sharding, axis=spec.dp_axis, groups=groups)
        model_in, text = local(model_in), local(text)
        cond = None if cond is None else local(cond)
        ctrl = [local(g) for g in ctrl]
        unet_kw = {k: _map_rows(local, v) for k, v in unet_kw.items()}

    cn_down = cn_mid = pose_emb = None
    if use_pg:
        pose_emb = pose_guider_apply(pose_guider, ctrl[0].reshape(-1, *ctrl[0].shape[2:]))
    cn_frames = [g.reshape(-1, *g.shape[2:]) for g in ctrl] if use_cn else []
    if use_cn:
        nets = _as_list(controlnet)
        if len(cn_frames) == 1:
            cn_frames = cn_frames * len(nets)
        scales = spec.controlnet_scale
        scales = list(scales) if isinstance(scales, tuple) else [scales] * len(nets)
    if use_cn and not fp:
        # the ControlNet takes the spliced (condition + window) latents
        cn_lat = model_in if cond is None else torch.cat([cond, model_in], dim=1)
        nf = cn_lat.shape[1]
        frames = cn_lat.reshape(-1, *cn_lat.shape[2:])
        text_frames = text.repeat_interleave(nf, 0).to(dtype)
        for net, ci, cs in zip(nets, cn_frames, scales):
            d_i, m_i = controlnet_apply(net, frames, t_step, text_frames, ci,
                                        conditioning_scale=cs)
            if cn_down is None:
                cn_down, cn_mid = d_i, m_i
            else:
                cn_down = [a + d for a, d in zip(cn_down, d_i)]
                cn_mid = cn_mid + m_i

    unet_fn = unet3d_apply
    if fp:
        unet_fn = functools.partial(
            unet3d_apply_fp, axis=spec.fp_axis or "fp",
            comm=None if spec.fp_stub_devices is None else StubComm(spec.fp_stub_devices))
        if use_cn:  # each rank runs the (frame-local) trunk on its own rows
            unet_kw["controlnet"] = dict(nets=nets, scales=[float(x) for x in scales],
                                         images=cn_frames, timestep=t_step)
    out = unet_fn(
        unet, model_in, t_step, text.to(dtype),
        condition_latents=cond, gen_index=gen_index, cond_index=cond_index,
        do_cfg=spec.do_cfg, motion_speed=spec.motion_speed,
        skip_temporal=spec.skip_temporal,
        refer_self_attn_mode=None if refer_self_attn_embs is None else "read",
        ip_adapter_scale=spec.ip_adapter_scale,
        ip_adapter_face_scale=spec.ip_adapter_face_scale,
        controlnet_down_residuals=cn_down, controlnet_mid_residual=cn_mid,
        pose_guider_emb=pose_emb, **unet_kw,
    )
    if spec.dp_axis is not None:
        out = replicated(out, rows, axis=spec.dp_axis, groups=groups)
    if cond is not None:
        out = take_frames(out, gen_index)

    # overlap average: scatter-add the windows, divide by coverage counts
    out = out.float().reshape(reps, b, n_win * wlen, h, w, c)
    idx = torch.as_tensor(flat_idx, dtype=torch.long, device=out.device)
    buf = out.new_zeros((reps, b, t, h, w, c)).index_add_(2, idx, out)
    cnt = torch.as_tensor(counts, dtype=torch.float32, device=out.device)
    noise_pred = buf / cnt[None, None, :, None, None, None]
    if not spec.do_cfg:
        return noise_pred[0]
    g = float(spec.guidance[step_index])
    combined = noise_pred[0] + g * (noise_pred[1] - noise_pred[0])
    if spec.guidance_rescale > 0.0:
        combined = rescale_noise_cfg(combined, noise_pred[1], spec.guidance_rescale)
    return combined


def denoise_loop(
    unet: UNet3D,
    spec: DenoiseSpec,
    latents: torch.Tensor,
    text_uc: Optional[torch.Tensor],
    text_c: torch.Tensor,
    condition_latents: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    last_mid_latents: Optional[torch.Tensor] = None,
    last_mid_noises: Optional[torch.Tensor] = None,
    **conditioning,
):
    """Run the denoise steps from ``spec.start_step``; returns the final
    float32 latents. A stochastic sampler draws each step's noise from
    ``generator`` (``spec.noise_type``, ``spec.w_ind_noise``); a multistep
    one threads its state from ``init_state`` through the steps, as the JAX
    package's scan carry does. ``conditioning``: ``predict_noise``'s
    ReferenceNet, IP-Adapter, FaceID, ControlNet and PoseGuider inputs.

    Serial denoise: ``last_mid_latents`` / ``last_mid_noises`` (S, B, ov, h,
    w, C), the previous shot's recordings, blend into this shot's head: the
    latents' entry 0 before the first step, entry i + 1 into the noise at
    steps i <= N // 2 (weight 0.01, from frame 1) and into the stepped
    latents at i <= 1 (weight 0.1, from frame 0), i the absolute step
    index. Where S is short (a shot that started at ``start_step`` > 0
    recorded N - start_step + 1 entries), entry i + 1 past its end reads the
    last one, as the JAX package's dynamic index clamps
    (musev_tpu/pipelines/denoiser.py:445-466; ROADMAP queue 3).

    With ``spec.record_mid_video`` and ``video_overlap`` > 0 or
    ``spec.record_step_latents`` it returns a tuple, as the JAX package
    does: ``(final, (mid_latents, mid_noises))``, ``(final, step_latents)``
    or ``(final, (mid_latents, mid_noises), step_latents)``. mid_latents
    (S, B, ov, h, w, C) holds the initial tail then each step's, mid_noises
    a zero slot then each step's, S = steps run + 1; step_latents (steps
    run, B, T, h, w, C)."""
    lat = latents.float()
    sched = spec.scheduler
    num_steps, ov = sched.num_inference_steps, spec.video_overlap
    carry = ov > 0 and last_mid_latents is not None

    def entry(rec: torch.Tensor, i: int) -> torch.Tensor:
        return rec[min(i, rec.shape[0] - 1)]

    if carry:
        lat = fuse_part_tensor(last_mid_latents[0], lat, ov, weight=0.1, skip_step=0)
    multistep = getattr(sched, "is_multistep", False)
    state = sched.init_state(lat.shape, device=lat.device) if multistep else None
    noise_kw = dict(generator=generator, w_ind_noise=spec.w_ind_noise,
                    noise_type=spec.noise_type)
    record = spec.record_mid_video and ov > 0
    mid_lat = [lat[:, -ov:]] if record else []
    mid_noise, steps = [], []
    for i in range(spec.start_step, num_steps):
        noise_pred = predict_noise(unet, spec, lat, i, text_uc, text_c, condition_latents,
                                   **conditioning)
        if ov > 0 and last_mid_noises is not None and i <= num_steps // 2:
            noise_pred = fuse_part_tensor(entry(last_mid_noises, i + 1), noise_pred, ov,
                                          weight=0.01, skip_step=1)
        if multistep:
            lat, _, state = sched.step(noise_pred, i, lat, state, **noise_kw)
        else:
            lat, _ = sched.step(noise_pred, i, lat, **noise_kw)
        if carry and i <= 1:
            lat = fuse_part_tensor(entry(last_mid_latents, i + 1), lat, ov, weight=0.1,
                                   skip_step=0)
        if record:
            mid_lat.append(lat[:, -ov:])
            mid_noise.append(noise_pred[:, -ov:])
        if spec.record_step_latents:
            steps.append(lat)
    extras = []
    if record:
        extras.append((torch.stack(mid_lat),
                       torch.stack([torch.zeros_like(mid_noise[0])] + mid_noise)))
    if spec.record_step_latents:
        extras.append(torch.stack(steps))
    return (lat, *extras) if extras else lat


def splice_condition_frames(
    latents: torch.Tensor, condition_latents: Optional[torch.Tensor], n_vc: int
) -> torch.Tensor:
    """Re-splice the clean condition frames at the head (reference :2149-2156)."""
    if condition_latents is None or n_vc == 0:
        return latents
    return torch.cat([condition_latents.to(latents.dtype), latents], dim=1)
