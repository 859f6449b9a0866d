"""Euler-ancestral, DDIM and DDPM samplers (counterpart of ``musev_tpu/schedulers/ancestral.py``).

References: musev/schedulers/scheduling_euler_ancestral_discrete.py (the
video_fusion hook at :304-313), scheduling_ddpm.py (:231-240),
scheduling_ddim.py (:282-291, and the zero-SNR option of
pipeline_controlnet_predictor.py:270-282). Each step's stochastic draw is
the VideoFusion common + individual noise, so sampler noise is temporally
correlated; it comes from the caller's ``torch.Generator`` (or is given as
``noise=``). Tables are numpy; steps run in float32 and return the
sample's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.noise import step_noise
from .base import ScheduleConfig, spaced_timesteps
from .euler_discrete import SigmaSchedule, sigma_table


def _pred_x0(pt: str, x: torch.Tensor, out: torch.Tensor, a_t: float) -> torch.Tensor:
    """The x0 prediction of the alphas_cumprod-indexed samplers."""
    if pt == "epsilon":
        return (x - (1.0 - a_t) ** 0.5 * out) / a_t**0.5
    if pt == "v_prediction":
        return a_t**0.5 * x - (1.0 - a_t) ** 0.5 * out
    return out


class AlphaSchedule:
    """What the sampler families indexed by integer timesteps into
    ``alphas_cumprod`` share (DDIM, DDPM, LCM): unit initial noise, an
    unscaled model input, and the img2img start."""

    timesteps: np.ndarray
    alphas_cumprod: np.ndarray

    @property
    def init_noise_sigma(self) -> float:
        return 1.0

    def scale_model_input(self, sample: torch.Tensor, step_index: int) -> torch.Tensor:
        return sample

    def add_noise(self, original: torch.Tensor, noise: torch.Tensor,
                  step_index: int) -> torch.Tensor:
        """``sqrt(a) * original + sqrt(1 - a) * noise`` at the step's timestep."""
        a = float(self.alphas_cumprod[int(self.timesteps[step_index])])
        return (a**0.5 * original.float() + (1.0 - a) ** 0.5 * noise.float()).to(original.dtype)


def _int_timesteps(config: ScheduleConfig, num_inference_steps: int) -> np.ndarray:
    return spaced_timesteps(
        config.num_train_timesteps, num_inference_steps,
        config.timestep_spacing, config.steps_offset,
    ).round().astype(np.int64)


@dataclasses.dataclass(frozen=True, eq=False)
class EulerAncestralScheduler(SigmaSchedule):
    config: ScheduleConfig
    num_inference_steps: int
    timesteps: np.ndarray
    sigmas: np.ndarray  # (N+1,), last 0

    @classmethod
    def create(cls, num_inference_steps: int, config: Optional[ScheduleConfig] = None):
        config = config or ScheduleConfig()
        return cls(config, num_inference_steps, *sigma_table(config, num_inference_steps))

    def step(
        self, model_output: torch.Tensor, step_index: int, sample: torch.Tensor,
        generator: Optional[torch.Generator] = None, w_ind_noise: float = 0.5,
        noise_type: str = "video_fusion", noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (prev_sample, pred_x0); draws noise at every step."""
        sigma = float(self.sigmas[step_index])
        sigma_next = float(self.sigmas[step_index + 1])
        x = sample.float()
        out = model_output.float()
        pt = self.config.prediction_type
        if pt == "epsilon":
            pred_x0 = x - sigma * out
        elif pt == "v_prediction":
            pred_x0 = out * (-sigma / (sigma**2 + 1) ** 0.5) + x / (sigma**2 + 1)
        else:
            pred_x0 = out
        var = max(sigma_next**2 * (sigma**2 - sigma_next**2) / max(sigma**2, 1e-12), 0.0)
        sigma_up = var**0.5
        sigma_down = max(sigma_next**2 - sigma_up**2, 0.0) ** 0.5
        derivative = (x - pred_x0) / sigma
        prev = x + derivative * (sigma_down - sigma)
        prev = prev + step_noise(sample, noise, generator, noise_type, w_ind_noise) * sigma_up
        return prev.to(sample.dtype), pred_x0.to(sample.dtype)


@dataclasses.dataclass(frozen=True, eq=False)
class DDIMScheduler(AlphaSchedule):
    config: ScheduleConfig
    num_inference_steps: int
    timesteps: np.ndarray  # int indices into alphas_cumprod, descending
    alphas_cumprod: np.ndarray
    eta: float = 0.0
    clip_sample: bool = False

    @classmethod
    def create(cls, num_inference_steps: int, config: Optional[ScheduleConfig] = None,
               eta: float = 0.0):
        config = config or ScheduleConfig()
        return cls(config, num_inference_steps, _int_timesteps(config, num_inference_steps),
                   config.alphas_cumprod().astype(np.float32), eta)

    def step(
        self, model_output: torch.Tensor, step_index: int, sample: torch.Tensor,
        generator: Optional[torch.Generator] = None, w_ind_noise: float = 0.5,
        noise_type: str = "video_fusion", noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (prev_sample, pred_x0); draws noise only when ``eta > 0``.
        With zero-SNR betas, epsilon prediction divides by zero at t = 999,
        as in the JAX package: pair zero-SNR with v_prediction."""
        t = int(self.timesteps[step_index])
        prev_t = t - self.config.num_train_timesteps // self.num_inference_steps
        a_t = float(self.alphas_cumprod[t])
        a_prev = float(self.alphas_cumprod[prev_t]) if prev_t >= 0 else 1.0
        x = sample.float()
        out = model_output.float()
        beta_t = 1.0 - a_t
        pt = self.config.prediction_type
        pred_x0 = _pred_x0(pt, x, out, a_t)
        if pt == "epsilon":
            eps = out
        elif pt == "v_prediction":
            eps = a_t**0.5 * out + beta_t**0.5 * x
        else:
            eps = (x - a_t**0.5 * pred_x0) / beta_t**0.5
        if self.clip_sample:
            pred_x0 = pred_x0.clamp(-1.0, 1.0)
        var = (1.0 - a_prev) / (1.0 - a_t) * (1.0 - a_t / a_prev)
        std = self.eta * max(var, 0.0) ** 0.5
        prev = a_prev**0.5 * pred_x0 + max(1.0 - a_prev - std**2, 0.0) ** 0.5 * eps
        if self.eta > 0:
            prev = prev + std * step_noise(sample, noise, generator, noise_type, w_ind_noise)
        return prev.to(sample.dtype), pred_x0.to(sample.dtype)


@dataclasses.dataclass(frozen=True, eq=False)
class DDPMScheduler(AlphaSchedule):
    config: ScheduleConfig
    num_inference_steps: int
    timesteps: np.ndarray
    alphas_cumprod: np.ndarray

    @classmethod
    def create(cls, num_inference_steps: int, config: Optional[ScheduleConfig] = None):
        config = config or ScheduleConfig()
        return cls(config, num_inference_steps, _int_timesteps(config, num_inference_steps),
                   config.alphas_cumprod().astype(np.float32))

    def step(
        self, model_output: torch.Tensor, step_index: int, sample: torch.Tensor,
        generator: Optional[torch.Generator] = None, w_ind_noise: float = 0.5,
        noise_type: str = "video_fusion", noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (prev_sample, pred_x0); draws noise at every step and adds
        it at all but the last."""
        t = int(self.timesteps[step_index])
        prev_t = t - self.config.num_train_timesteps // self.num_inference_steps
        a_t = float(self.alphas_cumprod[t])
        a_prev = float(self.alphas_cumprod[prev_t]) if prev_t >= 0 else 1.0
        alpha = a_t / a_prev
        beta = 1.0 - alpha
        x = sample.float()
        pred_x0 = _pred_x0(self.config.prediction_type, x, model_output.float(), a_t)
        x0_coef = a_prev**0.5 * beta / (1.0 - a_t)
        xt_coef = alpha**0.5 * (1.0 - a_prev) / (1.0 - a_t)
        prev = x0_coef * pred_x0 + xt_coef * x
        var = max((1.0 - a_prev) / (1.0 - a_t) * beta, 1e-20)
        drawn = step_noise(sample, noise, generator, noise_type, w_ind_noise)
        if prev_t >= 0:
            prev = prev + var**0.5 * drawn
        return prev.to(sample.dtype), pred_x0.to(sample.dtype)
