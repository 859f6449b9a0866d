"""A narrow cell for the CPU tests: every module of both presets at small
widths, 64 x 64 clips of 8 frames in windows of 4, two steps of each kind."""

from __future__ import annotations

import copy
import json
from pathlib import Path

UNET = dict(block_out_channels=[32, 64, 64, 64], layers_per_block=1, in_channels=4,
            out_channels=4, cross_attention_dim=32, attention_heads=2, norm_num_groups=8)
UNET_FLAGS = {
    "musev": dict(need_transformer_in=True, use_anivv1_cfg=False, resnet_skip_time_act=False,
                  keep_vision_condition=False, need_refer_emb=False, ip_adapter_dim=None),
    "musev_referencenet": dict(need_transformer_in=False, use_anivv1_cfg=True,
                               resnet_skip_time_act=True, keep_vision_condition=True,
                               need_refer_emb=True, ip_adapter_dim=32),
}
VAE = dict(block_out_channels=[16, 16, 32, 32], layers_per_block=1, latent_channels=4,
           norm_num_groups=8, scaling_factor=0.18215)
TEXT = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64, vocab_size=49408,
            max_positions=77)
VISION = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64, image_size=28,
              patch_size=14, projection_dim=32)
BENCH_DIR = Path(__file__).resolve().parents[1]


def config(preset: str) -> dict:
    """The preset's configuration file with narrow widths."""
    cfg = json.loads((BENCH_DIR / "configs" / f"{preset}.json").read_text())
    cfg["modules"] = dict(unet=dict(UNET, **UNET_FLAGS[preset]), vae=VAE, text_encoder=TEXT)
    if preset == "musev_referencenet":
        cfg["modules"].update(referencenet={k: v for k, v in UNET.items() if k != "out_channels"},
                              clip_vision=VISION,
                              ip_proj=dict(clip_dim=32, cross_dim=32, tokens=4))
    return cfg


def traffic(name: str) -> dict:
    t = copy.deepcopy(json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text()))
    t["clip"].update(height=64, width=64, video_length=8, context_frames=4, context_overlap=2,
                     video_steps=2, t2i_steps=2)
    t["decode_segment"] = 3
    return t


def port_preset(cfg: dict):
    """The program's ``ModelPreset`` at ``cfg``'s widths."""
    from musev_torch.configs.model_registry import get_model_preset
    from musev_torch.models.clip_text import CLIPTextConfig
    from musev_torch.models.clip_vision import CLIPVisionConfig
    from musev_torch.models.referencenet import ReferenceNetConfig
    from musev_torch.models.unet3d import UNet3DConfig
    from musev_torch.models.vae import VAEConfig

    m = cfg["modules"]
    u = dict(m["unet"])
    ip_dim = u.pop("ip_adapter_dim")
    u["block_out_channels"] = tuple(u["block_out_channels"])
    kw = dict(unet_cfg=UNet3DConfig(**u, ip_adapter_cross_attn=ip_dim is not None,
                                    ip_adapter_dim=ip_dim or 768),
              vae_cfg=VAEConfig(**dict(m["vae"], block_out_channels=tuple(
                  m["vae"]["block_out_channels"]))),
              text_cfg=CLIPTextConfig(hidden_size=TEXT["hidden_size"],
                                      num_layers=TEXT["num_layers"], num_heads=TEXT["num_heads"],
                                      intermediate_size=TEXT["intermediate_size"]))
    if "referencenet" in m:
        r = dict(m["referencenet"])
        r["block_out_channels"] = tuple(r["block_out_channels"])
        kw.update(referencenet_cfg=ReferenceNetConfig(**r),
                  clip_vision_cfg=CLIPVisionConfig(**VISION),
                  ip_adapter_clip_dim=m["ip_proj"]["clip_dim"],
                  ip_adapter_tokens=m["ip_proj"]["tokens"])
    return get_model_preset(cfg["preset"], **kw)
