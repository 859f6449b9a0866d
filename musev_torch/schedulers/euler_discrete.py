"""Euler-discrete sampler (counterpart of ``musev_tpu/schedulers/euler_discrete.py``).

Reference: musev/schedulers/scheduling_euler_discrete.py:47-173, the default
scheduler. Sigma and timestep tables are numpy; the step runs in float32
whatever the sample dtype. Only the deterministic step (the reference's
default ``s_churn=0``, linear sigma interpolation) is ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .base import ScheduleConfig, spaced_timesteps


@dataclasses.dataclass(frozen=True, eq=False)
class EulerDiscreteScheduler:
    config: ScheduleConfig
    num_inference_steps: int
    timesteps: np.ndarray  # (N,) float, descending
    sigmas: np.ndarray  # (N+1,) float, last is 0

    @classmethod
    def create(cls, num_inference_steps: int,
               config: Optional[ScheduleConfig] = None) -> "EulerDiscreteScheduler":
        config = config or ScheduleConfig()
        ac = config.alphas_cumprod()
        sigmas_full = np.sqrt((1.0 - ac) / ac)
        timesteps = spaced_timesteps(
            config.num_train_timesteps, num_inference_steps,
            config.timestep_spacing, config.steps_offset,
        )
        sigmas = np.interp(timesteps, np.arange(len(sigmas_full)), sigmas_full)
        sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
        return cls(config=config, num_inference_steps=num_inference_steps,
                   timesteps=timesteps.astype(np.float32), sigmas=sigmas)

    @property
    def init_noise_sigma(self) -> float:
        if self.config.timestep_spacing in ("linspace", "trailing"):
            return float(np.sqrt(self.sigmas.max() ** 2 + 1))
        return float(self.sigmas.max())

    def scale_model_input(self, sample: torch.Tensor, step_index: int) -> torch.Tensor:
        sigma = float(self.sigmas[step_index])
        return sample / float(np.float32(np.sqrt(sigma**2 + 1.0)))

    def step(
        self, model_output: torch.Tensor, step_index: int, sample: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (prev_sample, pred_original_sample) in ``sample``'s dtype."""
        sigma = float(self.sigmas[step_index])
        x = sample.float()
        out = model_output.float()
        pt = self.config.prediction_type
        if pt in ("original_sample", "sample"):
            pred_original = out
        elif pt == "epsilon":
            pred_original = x - sigma * out
        elif pt == "v_prediction":
            pred_original = out * (-sigma / (sigma**2 + 1.0) ** 0.5) + x / (sigma**2 + 1.0)
        else:
            raise ValueError(pt)
        derivative = (x - pred_original) / sigma
        prev = x + derivative * (float(self.sigmas[step_index + 1]) - sigma)
        return prev.to(sample.dtype), pred_original.to(sample.dtype)

    def add_noise(self, original: torch.Tensor, noise: torch.Tensor,
                  step_index: int) -> torch.Tensor:
        """``original + noise * sigma`` at ``step_index`` in float32, returned
        in ``original``'s dtype (the img2img start of a truncated schedule)."""
        sigma = float(self.sigmas[step_index])
        return (original.float() + noise.float() * sigma).to(original.dtype)
