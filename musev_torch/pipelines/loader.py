"""Model construction: preset name -> randomly initialized ``MusevModels``.

Counterpart of ``musev_tpu/pipelines/loader.py`` for the three presets
(``configs/model_registry.py:69-80``): ``musev``; ``musev_referencenet``,
which adds the ReferenceNet, the ViT-H CLIP vision encoder and the
IP-Adapter ImageProjModel, 1024 -> 4 x 768; ``musev_referencenet_pose``,
which adds the ControlNet (320/640/1280/1280, stem 16/32/96/256) to those.
With no checkpoints in the repository, weights are drawn at full width from
a seed the way the JAX package's ``fast_init`` draws them (N(0, 0.02) for
matrices, zero biases, unit norm scales), the zero-initialised fuse
``to_out`` and ControlNet zero convs included, so the branches act. The JAX
loader builds the PoseGuider only from a checkpoint; without one, a caller
builds ``MusevModels`` with a ``PoseGuider`` of its own. Checkpoint
ingestion and the IP-Adapter-Plus Resampler are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from ..models.clip_text import CLIPTextConfig, CLIPTextModel
from ..models.clip_vision import CLIPVisionConfig, CLIPVisionModel
from ..models.common import GroupNorm, LayerNorm
from ..models.controlnet import ControlNet, ControlNetConfig
from ..models.ip_adapter import ImageProjModel
from ..models.referencenet import ReferenceNet2D, ReferenceNetConfig
from ..models.unet3d import UNet3D, musev_config, musev_referencenet_config
from ..models.vae import AutoencoderKL, VAEConfig
from ..utils.tokenizer import HashTokenizer
from .pipeline import MusevModels

_PRESETS = ("musev", "musev_referencenet", "musev_referencenet_pose")
# ModelPreset defaults of the referencenet presets (model_registry.py:35-42)
IP_ADAPTER_CLIP_DIM = 1024
IP_ADAPTER_TOKENS = 4


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """``cuda`` unless the caller names a device; never falls back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "musev_torch runs on CUDA and no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return device


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator, scale: float = 0.02) -> None:
    """Redraw every weight in place: N(0, scale) matrices and kernels, zero
    biases, unit norm weights. Other parameters keep their defaults."""
    for m in module.modules():
        if isinstance(m, (GroupNorm, LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d, nn.Embedding)):
            m.weight.normal_(0.0, scale, generator=generator)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()


def _conv_weights_channels_last(module: nn.Module) -> None:
    """Store 2-D conv kernels in channels_last, the layout of the activations
    they meet, so cuDNN takes its NHWC path without a per-call copy."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.data = m.weight.data.contiguous(memory_format=torch.channels_last)


def build_models(
    preset: str = "musev",
    *,
    device: Union[str, torch.device, None] = None,
    dtype: Optional[torch.dtype] = None,
    seed: int = 0,
    ip_adapter_model_name: str = "IPAdapter",
) -> MusevModels:
    """Full-width random-weight models for ``preset`` on ``device`` (default
    CUDA, bf16; float32 on the CPU)."""
    if preset not in _PRESETS:
        raise ValueError(f"unknown preset {preset!r}")
    if ip_adapter_model_name != "IPAdapter":
        raise NotImplementedError(
            f"IP-Adapter model {ip_adapter_model_name!r} is not ported to musev_torch yet "
            "(only the ImageProjModel of 'IPAdapter')"
        )
    device = resolve_device(device)
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    # float32 runs stay full float32, as the JAX reference's matmuls are
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    text_cfg = CLIPTextConfig()
    refnet = preset.startswith("musev_referencenet")
    pose = preset == "musev_referencenet_pose"
    unet_cfg = musev_referencenet_config() if refnet else musev_config()
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device(device):
        modules = [UNet3D(unet_cfg), AutoencoderKL(VAEConfig()), CLIPTextModel(text_cfg)]
        if refnet:
            modules += [ReferenceNet2D(ReferenceNetConfig()), CLIPVisionModel(CLIPVisionConfig()),
                        ImageProjModel(IP_ADAPTER_CLIP_DIM, unet_cfg.ip_adapter_dim,
                                       IP_ADAPTER_TOKENS)]
        if pose:
            modules.append(ControlNet(ControlNetConfig()))
    for m in modules:
        init_random_(m, gen)
        m.to(dtype).eval()
        _conv_weights_channels_last(m)
    unet, vae, text = modules[:3]
    extra = dict(zip(("referencenet", "clip_vision", "ip_proj", "controlnet"), modules[3:]))
    return MusevModels(unet=unet, vae=vae, text_encoder=text,
                       tokenizer=HashTokenizer(vocab_size=text_cfg.vocab_size), **extra)
