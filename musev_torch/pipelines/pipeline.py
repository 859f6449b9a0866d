"""End-to-end MuseV text-to-video (counterpart of ``musev_tpu/pipelines/pipeline.py``).

Phase 1 obtains the vision-condition frame: VAE-encode a given image, or
generate one text-to-image (the UNet at T = 1 with temporal layers skipped).
Phase 2 denoises ``video_length`` frames per shot with the batched VCPD
engine, conditioned on the previous shot's tail. A segmented VAE decode
closes the run. The pipeline runs on the device its models live on.

Ported: ``text2video`` with the vision-condition, T2I first frame, weighted
prompt and context-window paths. Not ported yet (raise NotImplementedError):
ReferenceNet / IP-Adapter / FaceID / ControlNet inputs, condition-image
redraw, serial-denoise carries, per-step latents, histogram matching, CFG
rescale, LoRA, textual inversion and LCM.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..models.clip_text import CLIPTextModel, clip_text_encode
from ..models.unet3d import UNet3D
from ..models.vae import AutoencoderKL, vae_decode_video, vae_encode_video
from ..ops.context import make_stacked_window_plan, make_window_plan
from ..ops.guidance import guidance_schedule
from ..ops.noise import make_noise
from ..schedulers import ScheduleConfig, create_scheduler
from ..utils.text_emb import encode_weighted_prompt
from ..utils.tokenizer import Tokenizer
from .denoiser import DenoiseSpec, denoise_loop, splice_condition_frames


@dataclasses.dataclass
class MusevModels:
    unet: UNet3D
    vae: AutoencoderKL
    text_encoder: CLIPTextModel
    tokenizer: Tokenizer

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
    "refer_image": None,
    "ip_adapter_image": None,
    "face_emb": None,
    "control_images": None,
    "redraw_condition_image": False,
    "record_mid_video": False,
    "need_middle_latents": False,
    "need_hist_match": False,
    "prompt_only_use_image_prompt": False,
    "guidance_rescale": 0.0,
}


class MusevPipeline:
    def __init__(self, models: MusevModels, scheduler_config: ScheduleConfig = ScheduleConfig(),
                 scheduler_name: str = "euler"):
        self.m = models
        self.scheduler_config = scheduler_config
        self.scheduler_name = scheduler_name

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
                   n_vision_cond: int, motion_speed: float) -> DenoiseSpec:
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
                                       config=self.scheduler_config),
            plan=plan,
            guidance=guidance_schedule(guidance_start, num_steps, stop=guidance_end,
                                       method=guidance_method),
            n_vision_cond=n_vision_cond,
            do_cfg=True,
            motion_speed=motion_speed,
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
                            None, "linear", 0, 8.0),
            skip_temporal=True,
        )
        shape = (text_c.shape[0], 1, height // scale, width // scale,
                 self.m.unet.cfg.in_channels)
        latents = make_noise(generator, shape, noise_type=noise_type, w_ind_noise=w_ind_noise,
                             device=self.m.device) * spec.scheduler.init_noise_sigma
        return denoise_loop(self.m.unet, spec, latents, text_uc, text_c)

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
        **unported,
    ) -> VideoResult:
        """The text/image-to-video driver (run_pipe_text2video, predictor.py:356-750)."""
        for name, value in unported.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"text2video() got an unexpected keyword argument {name!r}")
            default = _NOT_PORTED[name]
            if not (value is default or (default is not None and value == default)):
                raise NotImplementedError(
                    f"text2video({name}=...) is not ported to musev_torch yet"
                )
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
        b = len(prompt)
        gen = torch.Generator().manual_seed(seed)
        text_c, text_uc = self.encode_prompt_pair(prompt, negative_prompt)
        scale = self.m.vae.cfg.downscale
        shape = (b, video_length, height // scale, width // scale,
                 self.m.unet.cfg.in_channels)

        condition_latents = None
        if n_vision_condition > 0:
            if condition_images is not None:
                condition_latents = self.encode_images(condition_images).float()
            elif n_vision_condition == 1:
                condition_latents = self.generate_condition_latents(
                    text_c, text_uc, height, width, gen,
                    num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
                    noise_type=noise_type, w_ind_noise=w_ind_noise,
                )
            else:
                raise ValueError("n_vision_condition > 1 requires explicit condition_images")

        spec = self._make_spec(
            video_num_inference_steps, video_length, context_frames, context_overlap,
            context_schedule, video_guidance_scale, video_guidance_scale_end,
            video_guidance_scale_method, n_vision_condition, motion_speed,
        )
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
                               condition_latents=condition_latents)
            full = splice_condition_frames(out, condition_latents, n_vision_condition)
            all_latents.append(full if i_batch == 0 else full[:, n_vision_condition:])
            if n_vision_condition > 0 and not fix_condition_images:
                condition_latents = full[:, -n_vision_condition:]

        latents_cat = torch.cat(all_latents, dim=1)
        videos = self.decode_latents(latents_cat, segment=decode_segment)
        return VideoResult(videos=videos, latents=latents_cat.cpu().numpy())
