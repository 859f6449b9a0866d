"""Euler-discrete sampler (counterpart of ``musev_tpu/schedulers/euler_discrete.py``).

Reference: musev/schedulers/scheduling_euler_discrete.py:47-173, the default
scheduler. Sigma and timestep tables are numpy; the step runs in float32
whatever the sample dtype. With the default ``s_churn=0`` the step is
deterministic; ``s_churn > 0`` adds noise of the reference's ``noise_type``
before the step, drawn from the caller's ``torch.Generator`` (or given as
``noise=``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.noise import step_noise
from .base import ScheduleConfig, spaced_timesteps


def sigma_table(config: ScheduleConfig, num_inference_steps: int,
                interpolation_type: str = "linear") -> Tuple[np.ndarray, np.ndarray]:
    """The descending timesteps and their sigmas, then 0, both float32."""
    ac = config.alphas_cumprod()
    sigmas_full = np.sqrt((1.0 - ac) / ac)
    timesteps = spaced_timesteps(
        config.num_train_timesteps, num_inference_steps,
        config.timestep_spacing, config.steps_offset,
    )
    if interpolation_type == "linear":
        sigmas = np.interp(timesteps, np.arange(len(sigmas_full)), sigmas_full)
    elif interpolation_type == "log_linear":
        sigmas = np.exp(np.linspace(np.log(sigmas_full[-1]), np.log(sigmas_full[0]),
                                    num_inference_steps + 1))[::-1][:num_inference_steps]
    else:
        raise ValueError(interpolation_type)
    sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
    return timesteps.astype(np.float32), sigmas


class SigmaSchedule:
    """What the sampler families indexed by a sigma table share (Euler,
    Euler-ancestral, DPM-Solver++): the initial noise scale, the model
    input's scaling and the img2img start."""

    sigmas: np.ndarray  # (N+1,) float, last is 0

    @property
    def init_noise_sigma(self) -> float:
        if self.config.timestep_spacing in ("linspace", "trailing"):
            return float(np.sqrt(self.sigmas.max() ** 2 + 1))
        return float(self.sigmas.max())

    def scale_model_input(self, sample: torch.Tensor, step_index: int) -> torch.Tensor:
        sigma = float(self.sigmas[step_index])
        return sample / float(np.float32(np.sqrt(sigma**2 + 1.0)))

    def add_noise(self, original: torch.Tensor, noise: torch.Tensor,
                  step_index: int) -> torch.Tensor:
        """``original + noise * sigma`` at ``step_index`` in float32, returned
        in ``original``'s dtype (the img2img start of a truncated schedule)."""
        sigma = float(self.sigmas[step_index])
        return (original.float() + noise.float() * sigma).to(original.dtype)


@dataclasses.dataclass(frozen=True, eq=False)
class EulerDiscreteScheduler(SigmaSchedule):
    config: ScheduleConfig
    num_inference_steps: int
    timesteps: np.ndarray  # (N,) float, descending
    sigmas: np.ndarray  # (N+1,) float, last is 0
    s_churn: float = 0.0
    s_tmin: float = 0.0
    s_tmax: float = float("inf")
    s_noise: float = 1.0

    @classmethod
    def create(cls, num_inference_steps: int, config: Optional[ScheduleConfig] = None,
               interpolation_type: str = "linear", **kw) -> "EulerDiscreteScheduler":
        config = config or ScheduleConfig()
        timesteps, sigmas = sigma_table(config, num_inference_steps, interpolation_type)
        return cls(config=config, num_inference_steps=num_inference_steps,
                   timesteps=timesteps, sigmas=sigmas, **kw)

    def step(
        self, model_output: torch.Tensor, step_index: int, sample: torch.Tensor,
        generator: Optional[torch.Generator] = None, w_ind_noise: float = 0.5,
        noise_type: str = "random", noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (prev_sample, pred_original_sample) in ``sample``'s dtype.
        Draws noise only when ``s_churn > 0``."""
        sigma = float(self.sigmas[step_index])
        x = sample.float()
        out = model_output.float()
        sigma_hat = sigma
        if self.s_churn > 0:
            gamma = min(self.s_churn / (len(self.sigmas) - 1), 2**0.5 - 1)
            if not self.s_tmin <= sigma <= self.s_tmax:
                gamma = 0.0
            eps = step_noise(sample, noise, generator, noise_type, w_ind_noise) * self.s_noise
            sigma_hat = sigma * (gamma + 1.0)
            x = x + eps * max(sigma_hat**2 - sigma**2, 0.0) ** 0.5
        pt = self.config.prediction_type
        if pt in ("original_sample", "sample"):
            pred_original = out
        elif pt == "epsilon":
            pred_original = x - sigma_hat * out
        elif pt == "v_prediction":
            # sigma, not sigma_hat, as the JAX package (euler_discrete.py:145-148)
            pred_original = out * (-sigma / (sigma**2 + 1.0) ** 0.5) + x / (sigma**2 + 1.0)
        else:
            raise ValueError(pt)
        derivative = (x - pred_original) / sigma_hat
        prev = x + derivative * (float(self.sigmas[step_index + 1]) - sigma_hat)
        return prev.to(sample.dtype), pred_original.to(sample.dtype)
