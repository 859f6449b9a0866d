"""DPM-Solver++ (2M) multistep sampler (counterpart of ``musev_tpu/schedulers/dpm_multistep.py``).

Reference: musev/schedulers/scheduling_dpmsolver_multistep.py. The
deterministic 2M ODE solver in data-prediction (++) form. The one-step
history (the previous x0 prediction) is explicit state, as in the JAX
package's scan carry: ``is_multistep`` tells the denoise loop to start it
from ``init_state`` (zeros) and thread it through ``step``. As there, every
step after the first of the schedule takes the second-order branch, also
the first step of a run that starts at ``start_step > 0`` against the zero
state (diffusers would take a first-order step there).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .base import ScheduleConfig
from .euler_discrete import SigmaSchedule, sigma_table


def _alpha_sigma(sigma: float) -> Tuple[float, float]:
    """alpha_t, sigma_t of the "++" parameterisation."""
    alpha = 1.0 / (sigma**2 + 1.0) ** 0.5
    return alpha, sigma * alpha


@dataclasses.dataclass(frozen=True, eq=False)
class DPMSolverMultistepScheduler(SigmaSchedule):
    config: ScheduleConfig
    num_inference_steps: int
    timesteps: np.ndarray
    sigmas: np.ndarray  # sigma(t) aligned to timesteps, then 0
    is_multistep: bool = True

    @classmethod
    def create(cls, num_inference_steps: int, config: Optional[ScheduleConfig] = None):
        config = config or ScheduleConfig()
        return cls(config, num_inference_steps, *sigma_table(config, num_inference_steps))

    def init_state(self, shape: Sequence[int], device=None) -> torch.Tensor:
        """The previous x0 prediction before the first step: zeros."""
        return torch.zeros(tuple(shape), dtype=torch.float32, device=device)

    def step(
        self, model_output: torch.Tensor, step_index: int, sample: torch.Tensor,
        state: torch.Tensor, generator: Optional[torch.Generator] = None,
        w_ind_noise: float = 0.5, noise_type: str = "video_fusion",
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Returns (prev_sample, pred_x0, new_state); draws no noise (the
        generator and noise arguments keep the samplers' one signature)."""
        s0 = float(self.sigmas[step_index])
        s1 = float(self.sigmas[step_index + 1])
        s_prev = float(self.sigmas[max(step_index - 1, 0)])
        x = sample.float()
        out = model_output.float()
        pt = self.config.prediction_type
        if pt == "epsilon":
            x0 = x - s0 * out
        elif pt == "v_prediction":
            x0 = out * (-s0 / (s0**2 + 1) ** 0.5) + x / (s0**2 + 1)
        else:
            x0 = out
        if s1 <= 0:  # the final step (sigma -> 0) returns x0
            prev = x0
        else:
            a0, st0 = _alpha_sigma(s0)
            a1, st1 = _alpha_sigma(max(s1, 1e-10))
            ap, stp = _alpha_sigma(s_prev)
            lam0 = math.log(a0 / max(st0, 1e-10))
            lam1 = math.log(a1 / max(st1, 1e-10))
            lamp = math.log(ap / max(stp, 1e-10))
            h, h_prev = lam1 - lam0, lam0 - lamp
            if step_index > 0:  # second order (2M) against the previous x0
                r = max(h_prev / h if abs(h_prev) > 0 else 1.0, 1e-10)
                d = (1.0 + 1.0 / (2.0 * r)) * x0 - (1.0 / (2.0 * r)) * state.float()
            else:  # first order (DPM-Solver++ 1S)
                d = x0
            prev = (st1 / st0) * x - a1 * math.expm1(-h) * d
        return prev.to(sample.dtype), x0.to(sample.dtype), x0.to(sample.dtype)
