"""Per-timestep guidance-scale schedules (a copy of ``musev_tpu/ops/guidance.py``).

Reference: musev/utils/timesteps_util.py:5-61 — the pipeline evaluates a
guidance scale per denoise step (pipeline_controlnet.py:1717-1727, used at
:2100-2105). Returned as a numpy array.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def guidance_schedule(
    start: float,
    num: int,
    stop: Optional[float] = None,
    method: str = "linear",
    n_fix_start: int = 3,
) -> np.ndarray:
    if stop is None or start == stop:
        return np.full((num,), float(start), dtype=np.float32)
    if method == "linear":
        return np.linspace(start, stop, num=num, dtype=np.float32)
    if method == "two_stage":
        n_start = num // 2
        return np.asarray(
            [start] * n_start + [stop] * (num - n_start), dtype=np.float32
        )
    if method == "fix_two_stage":
        return np.asarray(
            [start] * n_fix_start + [stop] * (num - n_fix_start), dtype=np.float32
        )
    if method == "three_stage":
        middle = (start + stop) // 2
        n_start = num // 3
        return np.asarray(
            [start] * n_start
            + [middle] * n_start
            + [stop] * (num - 2 * n_start),
            dtype=np.float32,
        )
    raise ValueError(
        f"method must be linear|two_stage|three_stage|fix_two_stage, got {method!r}"
    )
