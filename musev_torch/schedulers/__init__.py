from typing import Optional, Union

from .ancestral import DDIMScheduler, DDPMScheduler, EulerAncestralScheduler
from .base import ScheduleConfig
from .dpm_multistep import DPMSolverMultistepScheduler
from .euler_discrete import EulerDiscreteScheduler
from .lcm import LCMScheduler

Scheduler = Union[EulerDiscreteScheduler, EulerAncestralScheduler, DDIMScheduler,
                  DDPMScheduler, LCMScheduler, DPMSolverMultistepScheduler]

_SCHEDULERS = {
    "euler": EulerDiscreteScheduler,
    "euler_ancestral": EulerAncestralScheduler,
    "ddim": DDIMScheduler,
    "ddpm": DDPMScheduler,
    "lcm": LCMScheduler,
    "dpmpp_2m": DPMSolverMultistepScheduler,
}


def create_scheduler(
    name: str,
    num_inference_steps: int,
    config: Optional[ScheduleConfig] = None,
    **kw,
) -> Scheduler:
    """Factory over the six sampler families of the reference
    (musev/schedulers/, SURVEY §2.5); ``kw`` goes to the family's ``create``."""
    try:
        cls = _SCHEDULERS[name]
    except KeyError:
        raise ValueError(
            f"unknown scheduler {name!r}; choose from {sorted(_SCHEDULERS)}"
        ) from None
    return cls.create(num_inference_steps, config=config, **kw)


__all__ = [
    "ScheduleConfig",
    "Scheduler",
    "EulerDiscreteScheduler",
    "EulerAncestralScheduler",
    "DDIMScheduler",
    "DDPMScheduler",
    "LCMScheduler",
    "DPMSolverMultistepScheduler",
    "create_scheduler",
]
