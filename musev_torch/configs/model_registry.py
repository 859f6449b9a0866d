"""Named model presets and negative-prompt registry.

Counterpart of ``musev_tpu/configs/model_registry.py`` over the port's
config classes. A ``ModelPreset`` bundles the architecture configs with the
checkpoint-path slots a user fills in; every slot of the JAX preset is kept,
so a task or CLI flag names the same field in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..models.clip_text import CLIPTextConfig
from ..models.clip_vision import CLIPVisionConfig
from ..models.controlnet import ControlNetConfig
from ..models.referencenet import ReferenceNetConfig
from ..models.unet3d import UNet3DConfig, musev_config, musev_referencenet_config
from ..models.vae import VAEConfig

PRESET_NAMES = ("musev", "musev_referencenet", "musev_referencenet_pose")


@dataclasses.dataclass
class ModelPreset:
    name: str
    unet_cfg: UNet3DConfig
    vae_cfg: VAEConfig = VAEConfig()
    text_cfg: CLIPTextConfig = CLIPTextConfig()
    referencenet_cfg: Optional[ReferenceNetConfig] = None
    clip_vision_cfg: Optional[CLIPVisionConfig] = None
    controlnet_cfg: Optional[ControlNetConfig] = None
    ip_adapter_clip_dim: int = 1024
    ip_adapter_tokens: int = 4
    ip_adapter_face_id_dim: int = 512
    # "IPAdapter" (pooled embedding -> ImageProjModel) or "IPAdapterPlus" /
    # "IPAdapterPlus-face" (penultimate patch tokens -> the perceiver
    # Resampler, ip_adapter_loader.py:95-111)
    ip_adapter_model_name: str = "IPAdapter"
    # checkpoint path slots (filled by the user / task config)
    unet_checkpoint: Optional[str] = None
    sd_base_checkpoint: Optional[str] = None
    vae_checkpoint: Optional[str] = None
    text_checkpoint: Optional[str] = None
    referencenet_checkpoint: Optional[str] = None
    # IP-Adapter image encoder (transformers CLIPVisionModelWithProjection)
    clip_vision_checkpoint: Optional[str] = None
    ip_adapter_checkpoint: Optional[str] = None
    ip_adapter_face_checkpoint: Optional[str] = None
    controlnet_checkpoint: Optional[str] = None
    # Moore-AnimateAnyone-style PoseGuider stem; built when a path is given
    pose_guider_checkpoint: Optional[str] = None
    pose_guider_cfg: Optional[ControlNetConfig] = None
    tokenizer_path: Optional[str] = None
    # entries are "path", "path:scale" (LoRA) or "path:trigger" (textual inversion)
    lora_checkpoints: Optional[List[str]] = None
    textual_inversion_checkpoints: Optional[List[str]] = None
    lcm_lora_checkpoint: Optional[str] = None
    lcm_lora_scale: float = 1.0


def get_model_preset(name: str, **overrides) -> ModelPreset:
    """The three shipped presets (unet_loader.py:232-268); ``overrides`` set
    fields of the preset, checkpoint slots included."""
    if name == "musev":
        preset = ModelPreset(name=name, unet_cfg=musev_config())
    elif name in ("musev_referencenet", "musev_referencenet_pose"):
        preset = ModelPreset(
            name=name,
            unet_cfg=musev_referencenet_config(),
            referencenet_cfg=ReferenceNetConfig(),
            clip_vision_cfg=CLIPVisionConfig(),
            controlnet_cfg=ControlNetConfig() if name.endswith("pose") else None,
        )
    else:
        raise ValueError(f"unknown preset {name!r}; choose {', '.join(PRESET_NAMES)}")
    for k, v in overrides.items():
        if not hasattr(preset, k):
            raise TypeError(f"ModelPreset has no field {k!r}")
        setattr(preset, k, v)
    return preset


# Named negative prompts (reference configs/model/negative_prompt.py; user-facing
# config data that must match the reference by name).
NEGATIVE_PROMPTS: Dict[str, str] = {
    "Empty": "",
    "V1": (
        "nsfw, lowres, bad anatomy, bad hands, text, error, missing fingers, "
        "extra digit, fewer digits, cropped, worst quality, low quality, "
        "normal quality, jpeg artifacts, signature, watermark, username, "
        "blurry, tail, watermarks"
    ),
    "V2": (
        "badhandv4, ng_deepnegative_v1_75t, (((multiple heads))), "
        "(((bad body))), (((two people))), ((extra arms)), ((deformed body)), "
        "(((sexy))), paintings,(((two heads))), ((big head)),sketches, "
        "(worst quality:2), (low quality:2), (normal quality:2), lowres, "
        "((monochrome)), ((grayscale)), skin spots, acnes, skin blemishes, "
        "age spot, glans, (((nsfw))), nipples, extra fingers, (extra legs), "
        "(long neck), mutated hands, (fused fingers), (too many fingers)"
    ),
    "V3": "badhandv4, ng_deepnegative_v1_75t, bad quality",
    "V4": (
        "badhandv4,ng_deepnegative_v1_75t,EasyNegativeV2,"
        "bad_prompt_version2-neg,bad quality"
    ),
    "V5": (
        "(((multiple heads))), (((bad body))), (((two people))), "
        "((extra arms)), ((deformed body)), (((sexy))), paintings,"
        "(((two heads))), ((big head)),sketches, (worst quality:2), "
        "(low quality:2), (normal quality:2), lowres, ((monochrome)), "
        "((grayscale)), skin spots, acnes, skin blemishes, age spot, glans, "
        "(((nsfw))), nipples, extra fingers, (extra legs), (long neck), "
        "mutated hands, (fused fingers), (too many fingers)"
    ),
}


def resolve_negative_prompt(name_or_text: str) -> str:
    return NEGATIVE_PROMPTS.get(name_or_text, name_or_text)
