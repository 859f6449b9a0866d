"""Histogram matching, crop/resize and CFG rescale.

Counterpart of ``musev_tpu/utils/image_util.py``. Histogram matching runs on
the host in numpy, after the decode (reference his_match,
tensor_util.py:13-34, applied at predictor.py:745-750);
``dynamic_crop_resize`` on the host in PIL (mmcm's
batch_dynamic_crop_resize_images); the rescale on the device in the denoise
step.
"""

from __future__ import annotations

import numpy as np
import torch


def hist_match_frame(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """``dst`` with each channel's histogram matched to ``src``'s; both
    (H, W, 3) floats in [0, 1]. The reference's CDF search."""
    src8 = (src * 255.0).astype(np.uint8)
    dst8 = (dst * 255.0).astype(np.uint8)
    res = np.zeros_like(dst8)
    kw = dict(bins=256, range=(0, 256), density=True)
    for ch in range(3):
        cdf_src = np.cumsum(np.histogram(src8[:, :, ch], **kw)[0])
        cdf_dst = np.cumsum(np.histogram(dst8[:, :, ch], **kw)[0])
        index = np.clip(np.searchsorted(cdf_src, cdf_dst, side="left"), 0, 255)
        res[:, :, ch] = index[dst8[:, :, ch]]
    return res.astype(np.float32) / 255.0


def hist_match_video_to_frame(video: np.ndarray, reference_frame: np.ndarray) -> np.ndarray:
    """Every frame of (T, H, W, 3) matched to ``reference_frame``."""
    return np.stack([hist_match_frame(reference_frame, f) for f in video])


def dynamic_crop_resize(image: np.ndarray, target_h: int, target_w: int) -> np.ndarray:
    """Center-crop (H, W, 3) to the target aspect ratio, then resize with
    PIL's default filter to (target_h, target_w, 3) uint8 (the mmcm
    batch_dynamic_crop_resize_images contract)."""
    from PIL import Image

    h, w = image.shape[:2]
    target_ratio = target_w / target_h
    ratio = w / h
    if ratio > target_ratio:  # too wide: crop width
        new_w = int(round(h * target_ratio))
        x0 = (w - new_w) // 2
        image = image[:, x0:x0 + new_w]
    elif ratio < target_ratio:  # too tall: crop height
        new_h = int(round(w / target_ratio))
        y0 = (h - new_h) // 2
        image = image[y0:y0 + new_h]
    return np.asarray(Image.fromarray(image.astype(np.uint8)).resize((target_w, target_h)))


def rescale_noise_cfg(noise_cfg: torch.Tensor, noise_pred_text: torch.Tensor,
                      guidance_rescale: float = 0.0) -> torch.Tensor:
    """Guidance rescale (arXiv:2305.08891 §3.4; reference util.py:368-383):
    the CFG-combined noise scaled to the text branch's std per sample, mixed
    back by ``guidance_rescale``. The std is the population std, as
    ``jnp.std``'s (``correction=0``)."""
    axes = tuple(range(1, noise_pred_text.ndim))
    std_text = noise_pred_text.std(dim=axes, keepdim=True, correction=0)
    std_cfg = noise_cfg.std(dim=axes, keepdim=True, correction=0)
    rescaled = noise_cfg * (std_text / std_cfg)
    return guidance_rescale * rescaled + (1.0 - guidance_rescale) * noise_cfg
