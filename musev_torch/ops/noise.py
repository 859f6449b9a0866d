"""Temporally-correlated sampler noise (the VideoFusion decomposition).

Counterpart of ``musev_tpu/ops/noise.py`` (reference
musev/utils/noise_util.py:8-83): ``sqrt(1-w) * common + sqrt(w) * individual``
where ``common`` is shared across the time axis and ``individual`` is i.i.d.
per frame. Draws come from an explicit ``torch.Generator`` on the CPU and are
moved to ``device``, so a seed gives the same noise on every device; they do
not reproduce ``jax.random``'s numbers.
"""

from __future__ import annotations

from typing import Sequence

import torch


def video_fusion_noise(
    generator: torch.Generator,
    shape: Sequence[int],
    w_ind_noise: float = 0.5,
) -> torch.Tensor:
    """``sqrt(1-w) * common + sqrt(w) * individual`` over ``shape`` (BTHWC)."""
    common_shape = list(shape)
    common_shape[1] = 1
    common = torch.randn(tuple(common_shape), generator=generator)
    ind = torch.randn(tuple(shape), generator=generator)
    return (1.0 - w_ind_noise) ** 0.5 * common + w_ind_noise**0.5 * ind


def make_noise(
    generator: torch.Generator,
    shape: Sequence[int],
    noise_type: str = "video_fusion",
    w_ind_noise: float = 0.5,
    device=None,
) -> torch.Tensor:
    """Dispatch on the reference's ``noise_type`` (scheduling_euler_discrete.py:120-130)."""
    if noise_type == "random":
        noise = torch.randn(tuple(shape), generator=generator)
    elif noise_type == "video_fusion":
        noise = video_fusion_noise(generator, shape, w_ind_noise=w_ind_noise)
    else:
        raise ValueError(f"unknown noise_type {noise_type!r}")
    return noise.to(device)
