"""End-to-end MuseV text-to-video (counterpart of ``musev_tpu/pipelines/pipeline.py``).

Phase 1 obtains the vision-condition frame: VAE-encode a given image, or
generate one text-to-image (the UNet at T = 1 with temporal layers skipped).
Phase 2 denoises ``video_length`` frames per shot with the batched VCPD
engine, conditioned on the previous shot's tail. A segmented VAE decode
closes the run. The pipeline runs on the device its models live on.

Ported: ``text2video`` with the vision-condition, T2I first frame, weighted
prompt and context-window paths, and the ``musev_referencenet`` preset's
image-to-video conditioning: ReferenceNet features fused into the UNet and
IP-Adapter image tokens (ImageProjModel) in a second cross-attention, both
taken from the condition image by default. ``video2video`` (Pose2Video and
Video2Video) runs a shot loop over the windows of a source video, each
window's control maps driving the ControlNet and PoseGuider of the
``musev_referencenet_pose`` preset, with the img2img ``video_strength``
start. Every sampler family of the JAX package runs (the pipeline's
``scheduler_name``), its noise drawn from the run's seeded CPU generator;
the adapters fuse into the models in place: LoRA (``load_lora``,
``unload_lora``), textual-inversion embeddings (``load_textual_inversion``)
and LCM (``enable_lcm``, with an LCM-LoRA). Not ported yet (raise
NotImplementedError): FaceID inputs and text2video's control images,
image-prompt-only text, condition-image redraw, serial-denoise carries,
per-step latents, histogram matching and CFG rescale.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..io.video import PrefetchingWindows
from ..models import sd_weights
from ..models.clip_text import CLIPTextModel, clip_text_encode
from ..models.clip_vision import CLIPVisionModel, clip_vision_encode, preprocess_clip_image
from ..models.controlnet import ControlNet, PoseGuider
from ..models.ip_adapter import ImageProjModel
from ..models.lora import fuse_lora
from ..models.referencenet import ReferenceNet2D, referencenet_apply
from ..models.unet3d import UNet3D
from ..models.vae import AutoencoderKL, vae_decode_video, vae_encode_video
from ..ops.context import make_stacked_window_plan, make_window_plan
from ..ops.guidance import guidance_schedule
from ..ops.noise import make_noise
from ..schedulers import ScheduleConfig, create_scheduler
from ..utils.text_emb import encode_weighted_prompt
from ..utils.textual_inversion import (
    InversionTokenizer,
    add_textual_inversion,
    load_inversion_state_dict,
)
from ..utils.tokenizer import Tokenizer
from .denoiser import DenoiseSpec, denoise_loop, splice_condition_frames


@dataclasses.dataclass
class MusevModels:
    unet: UNet3D
    vae: AutoencoderKL
    text_encoder: CLIPTextModel
    tokenizer: Tokenizer
    # the musev_referencenet preset's conditioning branches
    referencenet: Optional[ReferenceNet2D] = None
    clip_vision: Optional[CLIPVisionModel] = None
    ip_proj: Optional[ImageProjModel] = None
    # the musev_referencenet_pose preset's control branches
    controlnet: Optional[ControlNet] = None
    pose_guider: Optional[PoseGuider] = None

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.unet.parameters()).dtype


@dataclasses.dataclass
class VideoResult:
    """videos in [0, 1], (B, T, H, W, 3); latents (B, T, h, w, 4)."""

    videos: np.ndarray
    latents: np.ndarray


# text2video options whose branches are not ported yet, with their no-op values
_NOT_PORTED = {
    "face_emb": None,
    "control_images": None,
    "redraw_condition_image": False,
    "record_mid_video": False,
    "need_middle_latents": False,
    "need_hist_match": False,
    "prompt_only_use_image_prompt": False,
    "guidance_rescale": 0.0,
    "ip_adapter_face_scale": 1.0,
    "controlnet_conditioning_scale": 1.0,
    "video_overlap": 1,
    "redraw_strength": 0.75,
}
# options the JAX pipelines read only inside another option's branch
# (musev_tpu/pipelines/pipeline.py:599-603, :848-852, :878-889, :909-917):
# any value is a no-op while that option keeps its no-op value
_READ_ONLY_UNDER = {
    "ip_adapter_face_scale": "face_emb",
    "controlnet_conditioning_scale": "control_images",
    "video_overlap": "record_mid_video",
    "redraw_strength": "redraw_condition_image",
}
# the same for video2video
_NOT_PORTED_V2V = {
    "record_mid_video": False,
    "video_overlap": 1,
    "need_middle_latents": False,
    "need_hist_match": False,
    "guidance_rescale": 0.0,
}


def _is_noop(value, default) -> bool:
    return value is default or (default is not None and value == default)


def _reject_unported(fn: str, unported: dict, table: dict) -> None:
    """Raise for an unknown option or a not-ported one away from its no-op
    value, unless the option is read only under another that is off."""
    for name, value in unported.items():
        if name not in table:
            raise TypeError(f"{fn}() got an unexpected keyword argument {name!r}")
        gate = _READ_ONLY_UNDER.get(name)
        if gate in table and _is_noop(unported.get(gate, table[gate]), table[gate]):
            continue
        if not _is_noop(value, table[name]):
            raise NotImplementedError(f"{fn}({name}=...) is not ported to musev_torch yet")


def _prompt_batch(prompt, negative_prompt) -> Tuple[List[str], List[str]]:
    """Prompt and negative prompt as lists of one length."""
    if isinstance(prompt, str):
        prompt = [prompt]
    if isinstance(negative_prompt, str):
        negative_prompt = [negative_prompt] * len(prompt)
    elif len(negative_prompt) == 1:
        negative_prompt = list(negative_prompt) * len(prompt)
    if len(negative_prompt) != len(prompt):
        raise ValueError(
            f"negative_prompt batch {len(negative_prompt)} != prompt batch {len(prompt)}"
        )
    return list(prompt), list(negative_prompt)


def _source_windows(video_frames, time_size: int, b: int) -> Tuple[Iterator, Tuple[int, int]]:
    """Windows of ``time_size`` frames of a (T, H, W, 3) source shared by the
    batch, a (B, T, H, W, 3) batched source, or an iterator of windows (a
    streaming reader); returns them with the frames' (H, W)."""
    if isinstance(video_frames, np.ndarray) or hasattr(video_frames, "shape"):
        frames = np.asarray(video_frames)
        if frames.ndim == 5 and frames.shape[0] != b:
            raise ValueError(f"batched video_frames B={frames.shape[0]} != prompt batch {b}")
        axis = frames.ndim - 4  # the time axis
        windows = (frames[:, lo:lo + time_size] if axis else frames[lo:lo + time_size]
                   for lo in range(0, frames.shape[axis], time_size))
        return windows, frames.shape[axis + 1:axis + 3]
    it = iter(video_frames)
    try:
        first = next(it)
    except StopIteration:
        raise ValueError("video_frames yielded no frames") from None

    def chain():
        yield first
        yield from it

    return chain(), first.shape[1:3]


class MusevPipeline:
    def __init__(self, models: MusevModels, scheduler_config: ScheduleConfig = ScheduleConfig(),
                 scheduler_name: str = "euler", scheduler_kwargs: Optional[dict] = None):
        """``scheduler_kwargs`` go to the sampler family's ``create`` (e.g.
        Euler's ``s_churn``, DDIM's ``eta``)."""
        self.m = models
        self.scheduler_config = scheduler_config
        self.scheduler_name = scheduler_name
        self.scheduler_kwargs = dict(scheduler_kwargs or {})
        self._loras: List[tuple] = []  # (state_dict, scale): the fuse log

    # -- adapters (LoRA / textual inversion / LCM) --------------------------

    def load_lora(self, lora, scale: float = 1.0) -> int:
        """Fuse a kohya / peft / attn-procs LoRA (a path or a state dict) into
        the UNet and text encoder by weight delta, logged for ``unload_lora``
        (predictor.py:311-327, model_util.py:108-263). Returns the modules fused."""
        if isinstance(lora, str):
            lora = sd_weights.load_checkpoint(lora)
        n, _ = fuse_lora(self.m.unet, lora, scale=scale, text_encoder=self.m.text_encoder)
        self._loras.append((lora, scale))
        return n

    def unload_lora(self) -> None:
        """Subtract every LoRA this pipeline fused, last first (reference
        unload_lora, model_util.py:468). In bf16 the weights come back
        within a rounding of each add and subtract, not bit for bit."""
        for lora, scale in reversed(self._loras):
            fuse_lora(self.m.unet, lora, scale=-scale, text_encoder=self.m.text_encoder)
        self._loras.clear()

    def load_textual_inversion(self, source, trigger: Optional[str] = None) -> None:
        """Append a learned embedding (a path, or an (n, hidden) array with
        ``trigger``) to the token table and bind its trigger word, by
        default the file's stem (predictor.py:248-254)."""
        if isinstance(source, str):
            if trigger is None:
                trigger = os.path.splitext(os.path.basename(source))[0]
            emb = load_inversion_state_dict(sd_weights.load_checkpoint(source))
        else:
            emb = torch.as_tensor(source)
        if trigger is None:
            raise ValueError("trigger required when passing a raw embedding")
        if not isinstance(self.m.tokenizer, InversionTokenizer):
            self.m.tokenizer = InversionTokenizer(self.m.tokenizer)
        add_textual_inversion(self.m.text_encoder, self.m.tokenizer, trigger, emb)

    def enable_lcm(self, lcm_lora=None, scale: float = 1.0) -> None:
        """Switch to the LCM sampler, fusing an LCM-LoRA first when given
        (predictor.py:296-306)."""
        if lcm_lora is not None:
            self.load_lora(lcm_lora, scale=scale)
        self.scheduler_name = "lcm"

    # -- encoders ----------------------------------------------------------

    def _encode_ids(self, ids: np.ndarray) -> torch.Tensor:
        return clip_text_encode(
            self.m.text_encoder, torch.as_tensor(ids, device=self.m.device)
        )

    def encode_prompt_pair(
        self, prompts: Sequence[str], negative_prompts: Sequence[str]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Encode cond + uncond in one call so both pad to one length
        (text_emb_util.py:218-351). Returns (text_c, text_uc)."""
        both = list(prompts) + list(negative_prompts)
        emb = encode_weighted_prompt(self.m.tokenizer, self._encode_ids, both)
        b = len(prompts)
        return emb[:b], emb[b:]

    def encode_images(self, images: np.ndarray) -> torch.Tensor:
        """(B, T, H, W, 3) in [0, 255] -> latents (B, T, h, w, 4)."""
        x = torch.as_tensor(np.asarray(images, np.float32), device=self.m.device) / 127.5 - 1.0
        return vae_encode_video(self.m.vae, x.to(self.m.dtype))

    def decode_latents(self, latents: torch.Tensor, segment: int = 16) -> np.ndarray:
        vid = vae_decode_video(self.m.vae, latents.to(self.m.dtype), segment)
        return ((vid.float().clamp(-1, 1) + 1.0) / 2.0).cpu().numpy()

    # -- generation --------------------------------------------------------

    def _make_spec(self, num_steps: int, time_size: int, context_frames: int,
                   context_overlap: int, context_schedule: str, guidance_start: float,
                   guidance_end: Optional[float], guidance_method: str,
                   n_vision_cond: int, w_ind_noise: float, noise_type: str,
                   motion_speed: float, ip_adapter_scale: float = 1.0) -> DenoiseSpec:
        ctx = min(context_frames, time_size)
        if context_schedule == "uniform":
            plan = make_stacked_window_plan(num_steps, time_size, ctx,
                                            context_overlap=context_overlap,
                                            schedule=context_schedule)
        else:
            plan = make_window_plan(time_size, ctx, context_overlap=context_overlap,
                                    schedule=context_schedule)
        return DenoiseSpec(
            unet_cfg=self.m.unet.cfg,
            scheduler=create_scheduler(self.scheduler_name, num_steps,
                                       config=self.scheduler_config, **self.scheduler_kwargs),
            plan=plan,
            guidance=guidance_schedule(guidance_start, num_steps, stop=guidance_end,
                                       method=guidance_method),
            n_vision_cond=n_vision_cond,
            do_cfg=True,
            w_ind_noise=w_ind_noise,
            noise_type=noise_type,
            motion_speed=motion_speed,
            ip_adapter_scale=ip_adapter_scale,
        )

    def generate_condition_latents(
        self, text_c: torch.Tensor, text_uc: torch.Tensor, height: int, width: int,
        generator: torch.Generator, num_inference_steps: int = 30,
        guidance_scale: float = 7.5, noise_type: str = "video_fusion",
        w_ind_noise: float = 0.5,
    ) -> torch.Tensor:
        """Text-to-image first frame: T = 1 with temporal layers skipped
        (predictor.py:496-535). Returns float32 (B, 1, h, w, C)."""
        scale = self.m.vae.cfg.downscale
        spec = dataclasses.replace(
            self._make_spec(num_inference_steps, 1, 1, 0, "uniform_v2", guidance_scale,
                            None, "linear", 0, w_ind_noise, noise_type, 8.0),
            skip_temporal=True,
        )
        shape = (text_c.shape[0], 1, height // scale, width // scale,
                 self.m.unet.cfg.in_channels)
        latents = make_noise(generator, shape, noise_type=noise_type, w_ind_noise=w_ind_noise,
                             device=self.m.device) * spec.scheduler.init_noise_sigma
        return denoise_loop(self.m.unet, spec, latents, text_uc, text_c, generator=generator)

    def _condition_latents(
        self, condition_images: Optional[np.ndarray], n_vc: int, text_c: torch.Tensor,
        text_uc: torch.Tensor, height: int, width: int, generator: torch.Generator, **t2i,
    ) -> Optional[torch.Tensor]:
        """Phase 1: float32 (B, n_vc, h, w, C) latents of the given condition
        images, or of a T2I first frame; None without condition frames."""
        if n_vc == 0:
            return None
        if condition_images is not None:
            return self.encode_images(condition_images).float()
        if n_vc == 1:
            return self.generate_condition_latents(text_c, text_uc, height, width, generator,
                                                   **t2i)
        raise ValueError("n_vision_condition > 1 requires explicit condition_images")

    def _ip_tokens(self, images_bn: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, N, H, W, 3) images -> (cond, uncond) IP-Adapter tokens, each
        (B, N * K, D): CLIP vision's projected pooled embedding through the
        ImageProjModel; uncond projects zeros (pipeline_controlnet.py:736-774)."""
        b, n = images_bn.shape[:2]
        imgs = torch.as_tensor(np.asarray(images_bn, np.float32), device=self.m.device)
        pixels = preprocess_clip_image(imgs.reshape(b * n, *imgs.shape[2:]),
                                       self.m.clip_vision.cfg.image_size)
        _, pooled = clip_vision_encode(self.m.clip_vision, pixels)
        cond = self.m.ip_proj(pooled)
        uncond = self.m.ip_proj(torch.zeros_like(pooled))
        k = cond.shape[1]
        return cond.reshape(b, n * k, -1), uncond.reshape(b, n * k, -1)

    def _prepare_reference_conditioning(
        self, refer_image: Optional[np.ndarray], ip_adapter_image: Optional[np.ndarray],
        text_c: torch.Tensor,
    ) -> dict:
        """ReferenceNet block embeddings and IP-Adapter tokens
        (get_referencenet_emb :867-964, get_ip_adapter_image_emb :686-780 of
        the reference pipeline). The ReferenceNet runs once, at timestep 0,
        with the IP cond tokens as its cross-attention context (the cond text
        without IP-Adapter); its embeddings are shared by both CFG halves.
        The IP tokens are stacked [uncond; cond]. Several reference images
        ((B, N, H, W, 3) or a list) enter the ReferenceNet as N frames and
        stack their IP tokens along the token axis."""
        m = self.m

        def to_multi(images) -> np.ndarray:
            if isinstance(images, (list, tuple)):
                images = np.stack([np.asarray(i) for i in images], axis=1)
            images = np.asarray(images)
            return images[:, None] if images.ndim == 4 else images

        out: dict = {}
        use_ip = (ip_adapter_image is not None and m.clip_vision is not None
                  and m.ip_proj is not None)
        if use_ip:
            cond_tok, uncond_tok = self._ip_tokens(to_multi(ip_adapter_image))
        if refer_image is not None and m.referencenet is not None:
            refer_bn = to_multi(refer_image)
            b, n_ref = refer_bn.shape[:2]
            lat = self.encode_images(refer_bn)  # (B, N, h, w, 4)
            ctx = (cond_tok if use_ip else text_c).to(m.dtype).repeat_interleave(n_ref, 0)
            down, mid = referencenet_apply(
                m.referencenet, lat.reshape(b * n_ref, *lat.shape[2:]).to(m.dtype), 0.0, ctx,
            )
            out["refer_embs"] = [e.reshape(b, n_ref, *e.shape[2:]) for e in down]
            out["mid_refer_emb"] = mid.reshape(b, n_ref, *mid.shape[2:])
        if use_ip and m.unet.cfg.ip_adapter_cross_attn:
            out["vision_clip_emb"] = torch.cat([uncond_tok, cond_tok]).to(m.dtype)
        return out

    @torch.inference_mode()
    def text2video(
        self,
        prompt: Union[str, Sequence[str]],
        negative_prompt: Union[str, Sequence[str]] = "",
        *,
        height: int = 256,
        width: int = 256,
        video_length: int = 12,
        n_batch: int = 1,
        n_vision_condition: int = 1,
        condition_images: Optional[np.ndarray] = None,  # (B, 1, H, W, 3) [0, 255]
        fix_condition_images: bool = False,
        video_num_inference_steps: int = 10,
        num_inference_steps: int = 30,
        video_guidance_scale: float = 3.5,
        video_guidance_scale_end: Optional[float] = None,
        video_guidance_scale_method: str = "linear",
        guidance_scale: float = 7.5,
        context_schedule: str = "uniform_v2",
        context_frames: int = 12,
        context_overlap: int = 4,
        noise_type: str = "video_fusion",
        w_ind_noise: float = 0.5,
        img_weight: float = 1e-3,
        motion_speed: float = 8.0,
        seed: int = 0,
        decode_segment: int = 16,
        refer_image: Optional[np.ndarray] = None,  # (B, H, W, 3) [0, 255]
        ip_adapter_image: Optional[np.ndarray] = None,  # (B, H, W, 3) [0, 255]
        ip_adapter_scale: float = 1.0,
        **unported,
    ) -> VideoResult:
        """Text- or image-to-video generation (run_pipe_text2video, predictor.py:356-750).

        With the ReferenceNet / IP-Adapter models present, ``refer_image``
        defaults to the condition image and ``ip_adapter_image`` to
        ``refer_image`` (predictor.py:588-636)."""
        _reject_unported("text2video", unported, _NOT_PORTED)
        prompt, negative_prompt = _prompt_batch(prompt, negative_prompt)
        b = len(prompt)
        gen = torch.Generator().manual_seed(seed)
        text_c, text_uc = self.encode_prompt_pair(prompt, negative_prompt)
        scale = self.m.vae.cfg.downscale
        shape = (b, video_length, height // scale, width // scale,
                 self.m.unet.cfg.in_channels)

        condition_latents = self._condition_latents(
            condition_images, n_vision_condition, text_c, text_uc, height, width, gen,
            num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
            noise_type=noise_type, w_ind_noise=w_ind_noise,
        )

        spec = self._make_spec(
            video_num_inference_steps, video_length, context_frames, context_overlap,
            context_schedule, video_guidance_scale, video_guidance_scale_end,
            video_guidance_scale_method, n_vision_condition, w_ind_noise, noise_type,
            motion_speed, ip_adapter_scale=ip_adapter_scale,
        )
        if refer_image is None and condition_images is not None:
            refer_image = np.asarray(condition_images)[:, 0]
        if ip_adapter_image is None and refer_image is not None:
            ip_adapter_image = refer_image
        refer_cond = self._prepare_reference_conditioning(refer_image, ip_adapter_image, text_c)
        all_latents: List[torch.Tensor] = []
        for i_batch in range(n_batch):
            noise = make_noise(gen, shape, noise_type=noise_type, w_ind_noise=w_ind_noise,
                               device=self.m.device)
            if condition_latents is not None:
                # img-based video noise (pipeline prepare_latents :324-346)
                cond_mean = condition_latents.mean(dim=1, keepdim=True)
                noise = img_weight**0.5 * cond_mean + (1.0 - img_weight) ** 0.5 * noise
            latents = noise * spec.scheduler.init_noise_sigma
            out = denoise_loop(self.m.unet, spec, latents, text_uc, text_c,
                               condition_latents=condition_latents, generator=gen, **refer_cond)
            full = splice_condition_frames(out, condition_latents, n_vision_condition)
            all_latents.append(full if i_batch == 0 else full[:, n_vision_condition:])
            if n_vision_condition > 0 and not fix_condition_images:
                condition_latents = full[:, -n_vision_condition:]

        latents_cat = torch.cat(all_latents, dim=1)
        videos = self.decode_latents(latents_cat, segment=decode_segment)
        return VideoResult(videos=videos, latents=latents_cat.cpu().numpy())

    @torch.inference_mode()
    def video2video(
        self,
        prompt: Union[str, Sequence[str]],
        video_frames,  # (T, H, W, 3) or (B, T, H, W, 3) [0, 255], or an iterator of windows
        negative_prompt: Union[str, Sequence[str]] = "",
        *,
        video_is_middle: bool = False,
        controlnet_processor=None,
        need_video2video: bool = False,
        video_strength: float = 0.8,
        condition_images: Optional[np.ndarray] = None,  # (B, n_vc, H, W, 3) [0, 255]
        time_size: int = 12,
        n_vision_condition: int = 1,
        height: Optional[int] = None,
        width: Optional[int] = None,
        video_num_inference_steps: int = 10,
        num_inference_steps: int = 30,
        video_guidance_scale: float = 3.5,
        guidance_scale: float = 7.5,
        context_schedule: str = "uniform_v2",
        context_frames: int = 12,
        context_overlap: int = 4,
        noise_type: str = "video_fusion",
        w_ind_noise: float = 0.5,
        motion_speed: float = 8.0,
        controlnet_conditioning_scale: float = 1.0,
        refer_image: Optional[np.ndarray] = None,  # (B, H, W, 3) [0, 255]
        ip_adapter_image: Optional[np.ndarray] = None,  # (B, H, W, 3) [0, 255]
        ip_adapter_scale: float = 1.0,
        seed: int = 0,
        decode_segment: int = 16,
        **unported,
    ) -> VideoResult:
        """Pose2Video / Video2Video: a shot loop over the source video's windows
        of ``time_size`` frames (run_pipe_video2video, predictor.py:760-1290).

        ``video_is_middle=True`` means the source frames are already the
        control maps (pose images); otherwise ``controlnet_processor`` (frames
        -> maps) runs on each window in the prefetch thread. Each shot is
        conditioned on the previous shot's last ``n_vision_condition`` frames
        and their maps; the first on ``condition_images`` or a T2I frame.
        ``need_video2video`` starts each shot from the noised source latents
        and runs only the last ``video_strength`` of the steps. A trailing
        partial window runs with its own (shorter) plan."""
        _reject_unported("video2video", unported, _NOT_PORTED_V2V)
        prompt, negative_prompt = _prompt_batch(prompt, negative_prompt)
        b = len(prompt)
        gen = torch.Generator().manual_seed(seed)
        text_c, text_uc = self.encode_prompt_pair(prompt, negative_prompt)
        windows, first_hw = _source_windows(video_frames, time_size, b)
        height = height or first_hw[0]
        width = width or first_hw[1]
        scale = self.m.vae.cfg.downscale
        lat_shape = (height // scale, width // scale, self.m.unet.cfg.in_channels)
        n_vc = n_vision_condition

        def build_spec(t_window: int) -> DenoiseSpec:
            extra: dict = {}
            if self.m.controlnet is not None:
                extra.update(controlnet_cfg=self.m.controlnet.cfg,
                             controlnet_scale=controlnet_conditioning_scale)
            if self.m.pose_guider is not None:
                extra["pose_guider_cfg"] = self.m.pose_guider.cfg
            if need_video2video:  # the reference's get_timesteps (:1627-1641)
                extra["start_step"] = min(
                    int(video_num_inference_steps * (1.0 - video_strength)),
                    video_num_inference_steps - 1,
                )
            spec = self._make_spec(
                video_num_inference_steps, t_window, context_frames, context_overlap,
                context_schedule, video_guidance_scale, None, "linear", n_vc, w_ind_noise,
                noise_type, motion_speed, ip_adapter_scale=ip_adapter_scale,
            )
            return dataclasses.replace(spec, **extra)

        def prepare(window) -> Tuple[np.ndarray, np.ndarray]:
            window = np.asarray(window)
            if window.ndim == 4:  # (T, H, W, 3) shared by the batch
                window = np.broadcast_to(window[None], (b, *window.shape))
            if video_is_middle or controlnet_processor is None:
                return window, window
            return window, np.stack([controlnet_processor(f) for f in window])

        spec = build_spec(time_size)
        refer_cond = self._prepare_reference_conditioning(refer_image, ip_adapter_image, text_c)
        use_ctrl = spec.controlnet_cfg is not None or spec.pose_guider_cfg is not None
        condition_latents = last_control = None
        all_latents: List[torch.Tensor] = []
        for i_window, (window, control) in enumerate(PrefetchingWindows(windows,
                                                                         map_fn=prepare)):
            t_w = window.shape[1]
            if t_w == 0:
                continue
            spec_w = spec if t_w == time_size else build_spec(t_w)
            if i_window == 0:
                condition_latents = self._condition_latents(
                    condition_images, n_vc, text_c, text_uc, height, width, gen,
                    num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
                    noise_type=noise_type, w_ind_noise=w_ind_noise,
                )
                if condition_latents is not None and condition_latents.shape[1] != n_vc:
                    raise ValueError(f"{condition_latents.shape[1]} condition images != "
                                     f"n_vision_condition {n_vc}")
                last_control = control[:, :n_vc]
            noise = make_noise(gen, (b, t_w, *lat_shape), noise_type=noise_type,
                               w_ind_noise=w_ind_noise, device=self.m.device)
            if need_video2video:
                latents = spec_w.scheduler.add_noise(self.encode_images(window).float(), noise,
                                                     spec_w.start_step)
            else:
                if condition_latents is not None:
                    cond_mean = condition_latents.mean(dim=1, keepdim=True)
                    noise = 1e-3**0.5 * cond_mean + (1.0 - 1e-3) ** 0.5 * noise
                latents = noise * spec_w.scheduler.init_noise_sigma
            ctrl = None
            if use_ctrl:  # [the condition frames' maps; the window's], in [0, 1]
                maps = np.concatenate([last_control, control], axis=1) if n_vc else control
                ctrl = torch.as_tensor(maps, dtype=torch.float32, device=self.m.device) / 255.0
            out = denoise_loop(self.m.unet, spec_w, latents, text_uc, text_c,
                               condition_latents=condition_latents, generator=gen,
                               controlnet=self.m.controlnet, control_images=ctrl,
                               pose_guider=self.m.pose_guider, **refer_cond)
            full = splice_condition_frames(out, condition_latents, n_vc)
            all_latents.append(full if i_window == 0 else full[:, n_vc:])
            if n_vc > 0:
                condition_latents = full[:, -n_vc:]
                last_control = control[:, -n_vc:]

        if not all_latents:
            raise ValueError("video_frames yielded no frames")
        latents_cat = torch.cat(all_latents, dim=1)
        videos = self.decode_latents(latents_cat, segment=decode_segment)
        return VideoResult(videos=videos, latents=latents_cat.cpu().numpy())
