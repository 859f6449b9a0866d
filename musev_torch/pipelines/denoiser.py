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
"""

from __future__ import annotations

import dataclasses
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
from ..ops.index_ops import take_frames
from ..schedulers.euler_discrete import EulerDiscreteScheduler


@dataclasses.dataclass(frozen=True, eq=False)
class DenoiseSpec:
    """Configuration of one VCPD denoise run (the fields this path uses)."""

    unet_cfg: UNet3DConfig
    scheduler: EulerDiscreteScheduler
    plan: WindowPlan  # or a StackedWindowPlan (per-step 'uniform' schedule)
    guidance: np.ndarray  # (num_steps,) per-step CFG scale
    n_vision_cond: int = 0
    do_cfg: bool = True
    motion_speed: float = 8.0
    ip_adapter_scale: float = 1.0
    skip_temporal: bool = False
    # img2img strength: only steps [start_step, num_steps) run (reference
    # get_timesteps, pipeline_controlnet.py:1627-1641)
    start_step: int = 0
    # set to apply the ControlNet / PoseGuider passed to predict_noise; a
    # tuple of configs and of scales for a MultiControlNet
    controlnet_cfg: Optional[Union[ControlNetConfig, Tuple[ControlNetConfig, ...]]] = None
    controlnet_scale: Union[float, Tuple[float, ...]] = 1.0
    pose_guider_cfg: Optional[ControlNetConfig] = None


def _as_list(x) -> list:
    return list(x) if isinstance(x, (list, tuple)) else [x]


def predict_noise(
    unet: UNet3D,
    spec: DenoiseSpec,
    latents: torch.Tensor,
    step_index: int,
    text_uc: Optional[torch.Tensor],
    text_c: torch.Tensor,
    condition_latents: Optional[torch.Tensor] = None,
    vision_clip_emb: Optional[torch.Tensor] = None,
    refer_embs: Optional[Sequence[torch.Tensor]] = None,
    mid_refer_emb: Optional[torch.Tensor] = None,
    controlnet: Union[ControlNet, Sequence[ControlNet], None] = None,
    control_images: Union[torch.Tensor, Sequence[torch.Tensor], None] = None,
    pose_guider: Optional[PoseGuider] = None,
) -> torch.Tensor:
    """One VCPD noise prediction over all windows; latents (B, T, h, w, C).

    ``vision_clip_emb`` (2B, S_ip, D) holds the IP-Adapter tokens as
    [uncond; cond]; ``refer_embs`` / ``mid_refer_emb`` (B, N, h, w, c) the
    ReferenceNet features, shared by both CFG halves (pipeline_controlnet.py
    :845). ``control_images`` (B, n_vc + T, 8h, 8w, 3) in [0, 1], the
    condition frames' maps at the head, or one such tensor per ControlNet;
    the PoseGuider takes the first. Returns the CFG-combined noise
    (B, T, h, w, C) in float32."""
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
    cn_down = cn_mid = pose_emb = None
    if use_cn or use_pg:
        if control_images is None:
            raise ValueError("the ControlNet and the PoseGuider need control_images")
        # per-window control frames: [the condition frames' maps; the window's]
        idx = windows + n_vc
        if n_vc > 0:
            idx = np.concatenate([np.broadcast_to(np.arange(n_vc), (n_win, n_vc)), idx], 1)
        idx = torch.as_tensor(idx.reshape(-1), dtype=torch.long)

        def gather_ctrl(imgs: torch.Tensor) -> torch.Tensor:
            g = imgs.index_select(1, idx.to(imgs.device))
            g = g.reshape(b * n_win, n_vc + wlen, *imgs.shape[2:])
            return torch.cat([g] * reps, dim=0).reshape(-1, *imgs.shape[2:]).to(dtype)

    if use_pg:
        pose_emb = pose_guider_apply(pose_guider, gather_ctrl(_as_list(control_images)[0]))
    if use_cn:
        nets = _as_list(controlnet)
        images = [gather_ctrl(ci) for ci in _as_list(control_images)]
        if len(images) == 1:
            images = images * len(nets)
        scales = spec.controlnet_scale
        scales = list(scales) if isinstance(scales, tuple) else [scales] * len(nets)
        # the ControlNet takes the spliced (condition + window) latents
        cn_lat = model_in if cond is None else torch.cat([cond, model_in], dim=1)
        nf = cn_lat.shape[1]
        frames = cn_lat.reshape(-1, *cn_lat.shape[2:])
        text_frames = text.repeat_interleave(nf, 0).to(dtype)
        t_step = float(spec.scheduler.timesteps[step_index])
        for net, ci, cs in zip(nets, images, scales):
            d_i, m_i = controlnet_apply(net, frames, t_step, text_frames, ci,
                                        conditioning_scale=cs)
            if cn_down is None:
                cn_down, cn_mid = d_i, m_i
            else:
                cn_down = [a + d for a, d in zip(cn_down, d_i)]
                cn_mid = cn_mid + m_i

    out = unet3d_apply(
        unet, model_in, float(spec.scheduler.timesteps[step_index]), text.to(dtype),
        condition_latents=cond, gen_index=gen_index, cond_index=cond_index,
        do_cfg=spec.do_cfg, motion_speed=spec.motion_speed,
        skip_temporal=spec.skip_temporal,
        down_block_refer_embs=None if refer_embs is None else [tile_rows(e) for e in refer_embs],
        mid_block_refer_emb=None if mid_refer_emb is None else tile_rows(mid_refer_emb),
        vision_clip_emb=None if vision_clip_emb is None else tile_rows(vision_clip_emb),
        ip_adapter_scale=spec.ip_adapter_scale,
        controlnet_down_residuals=cn_down, controlnet_mid_residual=cn_mid,
        pose_guider_emb=pose_emb,
    )
    if cond is not None:
        out = take_frames(out, gen_index)

    # overlap average: scatter-add the windows, divide by coverage counts
    out = out.float().reshape(reps, b, n_win * wlen, h, w, c)
    idx = torch.as_tensor(flat_idx, dtype=torch.long, device=out.device)
    buf = out.new_zeros((reps, b, t, h, w, c)).index_add_(2, idx, out)
    cnt = torch.as_tensor(counts, dtype=torch.float32, device=out.device)
    noise_pred = buf / cnt[None, None, :, None, None, None]
    if spec.do_cfg:
        g = float(spec.guidance[step_index])
        return noise_pred[0] + g * (noise_pred[1] - noise_pred[0])
    return noise_pred[0]


def denoise_loop(
    unet: UNet3D,
    spec: DenoiseSpec,
    latents: torch.Tensor,
    text_uc: Optional[torch.Tensor],
    text_c: torch.Tensor,
    condition_latents: Optional[torch.Tensor] = None,
    **conditioning,
) -> torch.Tensor:
    """Run the denoise steps from ``spec.start_step``; returns the final
    float32 latents. ``conditioning``: ``predict_noise``'s ReferenceNet,
    IP-Adapter, ControlNet and PoseGuider inputs."""
    lat = latents.float()
    for i in range(spec.start_step, spec.scheduler.num_inference_steps):
        noise_pred = predict_noise(unet, spec, lat, i, text_uc, text_c, condition_latents,
                                   **conditioning)
        lat, _ = spec.scheduler.step(noise_pred, i, lat)
    return lat


def splice_condition_frames(
    latents: torch.Tensor, condition_latents: Optional[torch.Tensor], n_vc: int
) -> torch.Tensor:
    """Re-splice the clean condition frames at the head (reference :2149-2156)."""
    if condition_latents is None or n_vc == 0:
        return latents
    return torch.cat([condition_latents.to(latents.dtype), latents], dim=1)
