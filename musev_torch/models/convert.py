"""Carry JAX-package weights into the port.

``*_from_jax(params, cfg)`` turn a param tree of the JAX package (nested dicts
and lists of arrays, as its ``init_*`` functions build them) into a
``state_dict`` of this package's modules, through the reference torch key
maps of ``sd_weights``. The keys are the reference checkpoints' own, so the
result loads with ``load_state_dict(strict=True)`` and so would a MuseV
checkpoint.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import sd_weights


def _to_torch(arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in arrays.items()}


def unet3d_from_jax(params, cfg) -> Dict[str, torch.Tensor]:
    return _to_torch(sd_weights.export_state_dict(sd_weights.unet3d_key_map(cfg), params))


def vae_from_jax(params, cfg) -> Dict[str, torch.Tensor]:
    return _to_torch(sd_weights.export_state_dict(sd_weights.vae_key_map(cfg), params))


def clip_text_from_jax(params, cfg) -> Dict[str, torch.Tensor]:
    return _to_torch(sd_weights.export_state_dict(sd_weights.clip_text_key_map(cfg), params))


def referencenet_from_jax(params, cfg) -> Dict[str, torch.Tensor]:
    return _to_torch(sd_weights.export_state_dict(sd_weights.referencenet_key_map(cfg), params))


def clip_vision_from_jax(params, cfg) -> Dict[str, torch.Tensor]:
    return _to_torch(sd_weights.export_state_dict(sd_weights.clip_vision_key_map(cfg), params))


def image_proj_from_jax(params) -> Dict[str, torch.Tensor]:
    return _to_torch(sd_weights.export_state_dict(sd_weights.image_proj_key_map(), params))


def controlnet_from_jax(params, cfg) -> Dict[str, torch.Tensor]:
    return _to_torch(sd_weights.export_state_dict(sd_weights.controlnet_key_map(cfg), params))


def pose_guider_from_jax(params, cfg) -> Dict[str, torch.Tensor]:
    return _to_torch(sd_weights.export_state_dict(sd_weights.pose_guider_key_map(cfg), params))


def resampler_from_jax(params, cfg) -> Dict[str, torch.Tensor]:
    return _to_torch(sd_weights.export_state_dict(sd_weights.resampler_key_map(cfg), params))


def mlp_proj_from_jax(params) -> Dict[str, torch.Tensor]:
    return _to_torch(sd_weights.export_state_dict(sd_weights.mlp_proj_key_map(), params))
