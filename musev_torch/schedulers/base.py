"""Shared diffusion-schedule math (betas, alphas, timestep spacing).

A copy of ``musev_tpu/schedulers/base.py``; pure numpy. Matches the
diffusers semantics the reference schedulers inherit (musev/schedulers/*,
all subclasses of diffusers with a video_fusion hook).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def make_betas(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "scaled_linear",
    trained_betas: Optional[np.ndarray] = None,
) -> np.ndarray:
    if trained_betas is not None:
        return np.asarray(trained_betas, dtype=np.float64)
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    if beta_schedule == "scaled_linear":
        return (
            np.linspace(
                beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64
            )
            ** 2
        )
    if beta_schedule == "squaredcos_cap_v2":
        steps = np.arange(num_train_timesteps + 1, dtype=np.float64)
        t = steps / num_train_timesteps
        alpha_bar = np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
        betas = 1.0 - alpha_bar[1:] / alpha_bar[:-1]
        return np.clip(betas, 0, 0.999)
    raise ValueError(f"unknown beta_schedule {beta_schedule!r}")


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Zero-SNR rescale (arXiv:2305.08891), used by the reference's DDIM
    option (pipeline_controlnet_predictor.py:270-282)."""
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    alphas_bar_sqrt = np.sqrt(alphas_cumprod)
    t0 = alphas_bar_sqrt[0].copy()
    t_last = alphas_bar_sqrt[-1].copy()
    alphas_bar_sqrt = alphas_bar_sqrt - t_last
    alphas_bar_sqrt = alphas_bar_sqrt * t0 / (t0 - t_last)
    alphas_bar = alphas_bar_sqrt**2
    alphas = alphas_bar[1:] / alphas_bar[:-1]
    alphas = np.concatenate([alphas_bar[0:1], alphas])
    return 1.0 - alphas


def spaced_timesteps(
    num_train_timesteps: int,
    num_inference_steps: int,
    spacing: str = "linspace",
    steps_offset: int = 0,
) -> np.ndarray:
    """Descending timestep array (float64), diffusers semantics."""
    if spacing == "linspace":
        return np.linspace(
            0, num_train_timesteps - 1, num_inference_steps, dtype=np.float64
        )[::-1].copy()
    if spacing == "leading":
        step_ratio = num_train_timesteps // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].copy()
        return ts.astype(np.float64) + steps_offset
    if spacing == "trailing":
        step_ratio = num_train_timesteps / num_inference_steps
        ts = np.arange(num_train_timesteps, 0, -step_ratio).round().copy() - 1
        return ts.astype(np.float64)
    raise ValueError(f"unknown timestep_spacing {spacing!r}")


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"
    timestep_spacing: str = "linspace"
    steps_offset: int = 0
    rescale_betas_zero_snr: bool = False

    def alphas_cumprod(self) -> np.ndarray:
        betas = make_betas(
            self.num_train_timesteps,
            self.beta_start,
            self.beta_end,
            self.beta_schedule,
        )
        if self.rescale_betas_zero_snr:
            betas = rescale_zero_terminal_snr(betas)
        return np.cumprod(1.0 - betas)
