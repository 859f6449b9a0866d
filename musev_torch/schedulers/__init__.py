from typing import Optional

from .base import ScheduleConfig
from .euler_discrete import EulerDiscreteScheduler

_SCHEDULERS = {"euler": EulerDiscreteScheduler}
# sampler families of the JAX package that the port does not have yet
_NOT_PORTED = ("euler_ancestral", "ddim", "ddpm", "lcm", "dpmpp_2m")


def create_scheduler(
    name: str,
    num_inference_steps: int,
    config: Optional[ScheduleConfig] = None,
    **kw,
):
    if name in _NOT_PORTED:
        raise NotImplementedError(f"scheduler {name!r} is not ported to musev_torch yet")
    if name not in _SCHEDULERS:
        raise ValueError(f"unknown scheduler {name!r}; choose from {sorted(_SCHEDULERS)}")
    return _SCHEDULERS[name].create(num_inference_steps, config=config, **kw)


__all__ = ["ScheduleConfig", "EulerDiscreteScheduler", "create_scheduler"]
