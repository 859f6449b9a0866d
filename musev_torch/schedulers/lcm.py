"""Latent Consistency Model sampler (counterpart of ``musev_tpu/schedulers/lcm.py``).

Reference: musev/schedulers/scheduling_lcm.py (video_fusion at :178-187),
enabled with an LCM-LoRA at pipeline_controlnet_predictor.py:301-306.
Integer timesteps skip through the ``original_inference_steps`` grid;
between consistency steps the sample is re-noised to the next boundary
with temporally-correlated noise, except after the last step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.noise import step_noise
from .ancestral import AlphaSchedule, _pred_x0
from .base import ScheduleConfig


@dataclasses.dataclass(frozen=True, eq=False)
class LCMScheduler(AlphaSchedule):
    config: ScheduleConfig
    num_inference_steps: int
    timesteps: np.ndarray  # int, descending
    alphas_cumprod: np.ndarray
    sigma_data: float = 0.5
    timestep_scaling: float = 10.0
    original_inference_steps: int = 50

    @classmethod
    def create(cls, num_inference_steps: int, config: Optional[ScheduleConfig] = None,
               original_inference_steps: int = 50):
        config = config or ScheduleConfig()
        if num_inference_steps > original_inference_steps:
            raise ValueError(
                f"LCM num_inference_steps ({num_inference_steps}) must be <= "
                f"original_inference_steps ({original_inference_steps})"
            )
        k = config.num_train_timesteps // original_inference_steps
        lcm_origin_timesteps = np.arange(1, original_inference_steps + 1) * k - 1
        skipping = len(lcm_origin_timesteps) // num_inference_steps
        ts = lcm_origin_timesteps[::-1][::skipping][:num_inference_steps]
        return cls(config, num_inference_steps, ts.astype(np.int64),
                   config.alphas_cumprod().astype(np.float32),
                   original_inference_steps=original_inference_steps)

    def step(
        self, model_output: torch.Tensor, step_index: int, sample: torch.Tensor,
        generator: Optional[torch.Generator] = None, w_ind_noise: float = 0.5,
        noise_type: str = "video_fusion", noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (prev_sample, denoised); draws noise at every step, as the
        JAX package does, and uses it at all but the last."""
        t = int(self.timesteps[step_index])
        a_t = float(self.alphas_cumprod[t])
        x = sample.float()
        pred_x0 = _pred_x0(self.config.prediction_type, x, model_output.float(), a_t)
        scaled = float(np.float32(t)) * self.timestep_scaling
        c_skip = self.sigma_data**2 / (scaled**2 + self.sigma_data**2)
        c_out = scaled / (scaled**2 + self.sigma_data**2) ** 0.5
        denoised = c_out * pred_x0 + c_skip * x
        last = self.num_inference_steps - 1
        a_next = float(self.alphas_cumprod[int(self.timesteps[min(step_index + 1, last)])])
        drawn = step_noise(sample, noise, generator, noise_type, w_ind_noise)
        if step_index >= last:
            prev = denoised
        else:
            prev = a_next**0.5 * denoised + (1.0 - a_next) ** 0.5 * drawn
        return prev.to(sample.dtype), denoised.to(sample.dtype)
