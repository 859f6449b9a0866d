"""DDIM inversion: the noise trajectory of existing latents.

Counterpart of ``musev_tpu/utils/inversion.py`` (reference
musev/utils/util.py:264-345): the DDIM update run in reverse with the
model's noise prediction at each step, on the port's ``DDIMScheduler``, in
float32 whatever the latents' dtype.
"""

from __future__ import annotations

from typing import Callable, List

import torch

from ..schedulers.ancestral import DDIMScheduler


def next_step(
    scheduler: DDIMScheduler,
    model_output: torch.Tensor,
    step_index: int,
    sample: torch.Tensor,
) -> torch.Tensor:
    """x_t -> x_{t+1} (the reversed DDIM update), in the sample's dtype."""
    ac = torch.from_numpy(scheduler.alphas_cumprod).float()
    t = int(scheduler.timesteps[step_index])
    step_ratio = scheduler.config.num_train_timesteps // scheduler.num_inference_steps
    next_t = min(t + step_ratio, scheduler.config.num_train_timesteps - 1)
    a_t, a_next = ac[t].to(sample.device), ac[next_t].to(sample.device)
    x, eps = sample.float(), model_output.float()
    x0 = (x - (1 - a_t).sqrt() * eps) / a_t.sqrt()
    return (a_next.sqrt() * x0 + (1 - a_next).sqrt() * eps).to(sample.dtype)


def ddim_inversion(
    scheduler: DDIMScheduler,
    latents: torch.Tensor,
    eps_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
) -> List[torch.Tensor]:
    """Invert clean latents to the noise trajectory [x_0, x_t1, ..., x_T]
    (util.py:318-345). ``eps_fn(latent, t)`` is the conditioned noise
    prediction at the float32 0-d timestep ``t``."""
    traj = [latents]
    x = latents
    for i in range(scheduler.num_inference_steps - 1, -1, -1):
        t = torch.tensor(float(scheduler.timesteps[i]), device=latents.device)
        x = next_step(scheduler, eps_fn(x, t), i, x)
        traj.append(x)
    return traj
