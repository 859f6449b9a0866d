"""Model construction: a preset -> ``MusevModels``, random or from checkpoints.

Counterpart of ``musev_tpu/pipelines/loader.py`` for the three presets
(``configs/model_registry.py``): ``musev``; ``musev_referencenet``, which adds
the ReferenceNet, the ViT-H CLIP vision encoder and the IP-Adapter
ImageProjModel, 1024 -> 4 x 768; ``musev_referencenet_pose``, which adds the
ControlNet (320/640/1280/1280, stem 16/32/96/256) to those. Every module is
first drawn at full width from a seed the way the JAX package's
``fast_init`` draws it (N(0, 0.02) for matrices, zero biases, unit norm
scales), the zero-initialised fuse ``to_out`` and ControlNet zero convs
included, so the branches act. Then the preset's checkpoint files are read
into it (``sd_weights.load_into``), in the JAX loader's order: the unet
file, the T2I base (``sd_base``) over its spatial sites (an original-LDM
``.ckpt`` is split, and its VAE and text encoder serve where no explicit
file loads), the VAE, text encoder, ReferenceNet, CLIP vision, the
IP-Adapter (its ``image_proj`` into the ImageProjModel, its numbered
``to_k_ip``/``to_v_ip`` onto the UNet's attn2 sites), the ControlNet and
the PoseGuider, built only when its slot is set. ``strict=True`` refuses a
set path that is missing and a module with a checkpoint of which some key
came from no file: the UNet's keys are checked against the union of what
the unet, sd_base and ip_adapter files wrote. Last come the adapters, in
the JAX loader's order: each textual-inversion file appends its rows to
the token table and binds its trigger (``path`` or ``path:trigger``, the
file's stem by default), then each LoRA (``path`` or ``path:scale``), the
LCM-LoRA last at ``lcm_lora_scale``, fuses into the UNet and the text
encoder. A missing adapter file raises ``FileNotFoundError`` (the JAX
loader logs it and goes on without it).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Set, Tuple, Union

import torch
from torch import nn

from ..configs.model_registry import ModelPreset, get_model_preset
from ..models import sd_weights
from ..models.clip_text import CLIPTextModel
from ..models.clip_vision import CLIPVisionModel
from ..models.common import GroupNorm, LayerNorm
from ..models.controlnet import ControlNet, ControlNetConfig, PoseGuider
from ..models.ip_adapter import ImageProjModel
from ..models.ldm_convert import is_ldm_checkpoint, split_ldm_checkpoint
from ..models.lora import fuse_lora
from ..models.referencenet import ReferenceNet2D
from ..models.unet3d import UNet3D
from ..models.vae import AutoencoderKL
from ..utils.textual_inversion import (
    InversionTokenizer,
    add_textual_inversion,
    load_inversion_state_dict,
)
from ..utils.tokenizer import get_tokenizer
from .pipeline import MusevModels

logger = logging.getLogger(__name__)

# the checkpoint slots, each a ``<slot>_checkpoint`` field of ModelPreset
SLOTS = ("unet", "sd_base", "vae", "text", "referencenet", "clip_vision", "ip_adapter",
         "controlnet", "pose_guider")
# preset fields whose branch is not ported yet: (field, what, ROADMAP queue 1 item)
NOT_PORTED_SLOTS = (("ip_adapter_face_checkpoint", "the FaceID IP-Adapter", 9),)


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """``cuda`` unless the caller names a device; never falls back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "musev_torch runs on CUDA and no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return device


def resolve_dtype(device: torch.device, dtype: Optional[torch.dtype]) -> torch.dtype:
    """bf16 on CUDA, float32 on the CPU, unless given; on CUDA the port's
    kernels take bf16 only, so another dtype raises here rather than deep
    inside the first attention call."""
    if dtype is None:
        return torch.bfloat16 if device.type == "cuda" else torch.float32
    if device.type == "cuda" and dtype != torch.bfloat16:
        raise ValueError(
            f"musev_torch's CUDA kernels take bfloat16, not {dtype}: use bfloat16 on the "
            "card, or device='cpu' for float32"
        )
    return dtype


def refuse_unported(preset: ModelPreset) -> None:
    """Raise NotImplementedError for a preset field whose branch the port lacks."""
    for field, what, item in NOT_PORTED_SLOTS:
        if getattr(preset, field):
            raise NotImplementedError(
                f"{field} ({what}) is not ported to musev_torch yet (ROADMAP queue 1, item {item})"
            )
    if preset.ip_adapter_model_name != "IPAdapter":
        raise NotImplementedError(
            f"IP-Adapter model {preset.ip_adapter_model_name!r} is not ported to musev_torch yet "
            "(only the ImageProjModel of 'IPAdapter'; ROADMAP queue 1, item 9)"
        )


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


def _checkpoint_paths(preset: ModelPreset, strict: bool) -> Dict[str, str]:
    """The set slots whose file exists; a set path that does not exist
    raises under ``strict`` and is logged otherwise."""
    paths = {}
    for slot in SLOTS:
        path = getattr(preset, f"{slot}_checkpoint")
        if not path:
            continue
        if os.path.exists(path):
            paths[slot] = path
        elif strict:
            raise FileNotFoundError(
                f"{slot}_checkpoint {path!r} does not exist: the network would silently "
                "stay at random init"
            )
        else:
            logger.warning("%s_checkpoint %r does not exist: the network stays at its random "
                           "init", slot, path)
    return paths


def build_models(
    preset: Union[str, ModelPreset] = "musev",
    *,
    device: Union[str, torch.device, None] = None,
    dtype: Optional[torch.dtype] = None,
    seed: int = 0,
    strict: bool = False,
) -> MusevModels:
    """Full-width models of ``preset`` (a name or a ``ModelPreset``) on
    ``device`` (default CUDA, bf16; float32 on the CPU), drawn from ``seed``
    and then read from the preset's checkpoint files."""
    if isinstance(preset, str):
        preset = get_model_preset(preset)
    refuse_unported(preset)
    device = resolve_device(device)
    dtype = resolve_dtype(device, dtype)
    paths = _checkpoint_paths(preset, strict)
    adapters = _adapter_specs(preset)
    # float32 runs stay full float32, as the JAX reference's matmuls are
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    unet_cfg = preset.unet_cfg
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device(device):
        modules = dict(unet=UNet3D(unet_cfg), vae=AutoencoderKL(preset.vae_cfg),
                       text_encoder=CLIPTextModel(preset.text_cfg))
        if preset.referencenet_cfg is not None:
            modules["referencenet"] = ReferenceNet2D(preset.referencenet_cfg)
        if preset.clip_vision_cfg is not None:
            modules["clip_vision"] = CLIPVisionModel(preset.clip_vision_cfg)
            modules["ip_proj"] = ImageProjModel(preset.ip_adapter_clip_dim,
                                                unet_cfg.ip_adapter_dim, preset.ip_adapter_tokens)
        if preset.controlnet_cfg is not None:
            modules["controlnet"] = ControlNet(preset.controlnet_cfg)
        if preset.pose_guider_checkpoint:
            # the guider's conv_out matches the UNet's conv_in width: its
            # embedding is added after conv_in
            modules["pose_guider"] = PoseGuider(preset.pose_guider_cfg or ControlNetConfig(
                block_out_channels=unet_cfg.block_out_channels,
                cross_attention_dim=unet_cfg.cross_attention_dim,
                attention_heads=unet_cfg.attention_heads,
                norm_num_groups=unet_cfg.norm_num_groups,
            ))
    for m in modules.values():
        init_random_(m, gen)
        m.to(dtype).eval()
        _conv_weights_channels_last(m)

    written = _load_checkpoints(preset, modules, paths)
    if strict:
        for name, keys in written.items():
            missing = sd_weights.missing_keys(modules[name], keys)
            if missing:
                raise ValueError(
                    f"the {name} checkpoints leave {len(missing)} required sites of the "
                    f"{preset.name} preset unwritten (naming drift or wrong file?): "
                    + ", ".join(missing[:8]) + (" ..." if len(missing) > 8 else "")
                )
    tokenizer = get_tokenizer(preset.tokenizer_path, preset.text_cfg.vocab_size)
    tokenizer = _load_adapters(*adapters, modules, tokenizer)
    return MusevModels(tokenizer=tokenizer, **modules)


def _adapter_specs(preset: ModelPreset) -> Tuple[List[Tuple[str, str]], List[Tuple[str, float]]]:
    """The preset's textual inversions as (path, trigger) and its LoRAs as
    (path, scale), the LCM-LoRA last at ``lcm_lora_scale`` (JAX
    loader.py:361-406); raises ``FileNotFoundError`` for a file that does
    not exist, and ``ValueError`` for a malformed scale."""
    def existing(path: str, what: str) -> str:
        if not os.path.exists(path):
            raise FileNotFoundError(f"{what} {path!r} does not exist: the clip would silently "
                                    "run without it")
        return path

    inversions = []
    for spec in preset.textual_inversion_checkpoints or []:
        path, trigger = _split_path_arg(spec)
        existing(path, "textual inversion")
        inversions.append((path, trigger or os.path.splitext(os.path.basename(path))[0]))
    entries = list(preset.lora_checkpoints or [])
    if preset.lcm_lora_checkpoint:
        entries.append(f"{preset.lcm_lora_checkpoint}:{preset.lcm_lora_scale}")
    loras = []
    for spec in entries:
        path, suffix = _split_path_arg(spec)
        loras.append((existing(path, "LoRA"), _parse_scale(suffix, spec)))
    return inversions, loras


def _load_adapters(inversions, loras, modules: Dict[str, nn.Module], tokenizer):
    """Textual inversions, then LoRAs, into ``modules`` in place; returns
    the tokenizer, wrapped when a textual inversion binds a trigger."""
    # negative embeddings appended to the token table so the V2/V4 negative
    # prompts' triggers bind (predictor.py:248-254 loads four by default)
    if inversions:
        tokenizer = InversionTokenizer(tokenizer)
    for path, trigger in inversions:
        emb = load_inversion_state_dict(sd_weights.load_checkpoint(path))
        add_textual_inversion(modules["text_encoder"], tokenizer, trigger, emb)
        logger.info("textual inversion %r: %d vectors", trigger, emb.shape[0])
    # LoRA fuse-at-load with per-entry scale (model_util.py:108-263)
    for path, scale in loras:
        n, unmatched = fuse_lora(modules["unet"], sd_weights.load_checkpoint(path), scale=scale,
                                 text_encoder=modules["text_encoder"])
        logger.info("lora %s: %d modules fused (scale %.3g), %d unmatched", path, n, scale,
                    len(unmatched))
    return tokenizer


def _split_path_arg(spec: str):
    """Parse 'path', 'path:suffix' or 'path=suffix' -> (path, suffix).

    '=' is the unambiguous form (paths may contain ':'); for ':' the split is
    rejected in favour of the whole spec when the whole spec names an
    existing file and the head does not (a path with a ':' in it).
    """
    if "=" in spec:
        path, suffix = spec.rsplit("=", 1)
        return path, suffix
    if ":" in spec:
        path, suffix = spec.rsplit(":", 1)
        if os.path.exists(spec) and not os.path.exists(path):
            return spec, None
        return path, suffix
    return spec, None


def _parse_scale(suffix, spec: str) -> float:
    """The scale suffix of a 'path:scale' spec, with an actionable error."""
    if suffix is None:
        return 1.0
    try:
        return float(suffix)
    except ValueError:
        raise ValueError(
            f"malformed LoRA spec {spec!r}: expected 'path', 'path:scale' or "
            f"'path=scale' with a numeric scale, got suffix {suffix!r}. "
            "If the checkpoint path itself contains ':', use the '=' form: "
            "'/my:path/lora.safetensors=0.8'."
        ) from None


def _load_checkpoints(preset: ModelPreset, modules: Dict[str, nn.Module],
                      paths: Dict[str, str]) -> Dict[str, Set[str]]:
    """Read every file of ``paths`` into ``modules``; returns, for each module
    that some file wrote to, the keys written."""
    written: Dict[str, Set[str]] = {}
    ldm: Dict[str, dict] = {}

    def load(name: str, state_dict, aliases=None) -> None:
        if name not in modules:
            logger.warning("the %s preset has no %s: its checkpoint is not read", preset.name, name)
            return
        keys = sd_weights.load_into(modules[name], state_dict, preset.name, aliases)
        written.setdefault(name, set()).update(keys)
        logger.info("%s: %d tensors loaded", name, len(keys))

    if "unet" in paths:
        load("unet", sd_weights.load_checkpoint(paths["unet"]))
    if "sd_base" in paths:
        # T2I base overwrite of the spatial sites (unet_loader.py:41-80); an
        # original-LDM .ckpt is split (convert_from_ckpt.py)
        base = sd_weights.load_checkpoint(paths["sd_base"])
        if is_ldm_checkpoint(base):
            ldm = split_ldm_checkpoint(base)
            base = ldm["unet"]
        load("unet", base)
    # the LDM file's VAE and text encoder serve where no explicit file loads
    for name, slot, aliases in (("vae", "vae", sd_weights._VAE_LEGACY_ALIASES),
                                ("text_encoder", "text", None)):
        if slot in paths:
            load(name, sd_weights.load_checkpoint(paths[slot]), aliases)
        elif ldm.get(slot):
            load(name, ldm[slot], aliases)
    for name in ("referencenet", "clip_vision"):
        if name in paths:
            load(name, sd_weights.load_checkpoint(paths[name]))
    if "ip_adapter" in paths:
        ip_sd = sd_weights.load_checkpoint(paths["ip_adapter"])
        load("ip_proj", sd_weights.image_proj_state_dict(ip_sd))
        if "ip_proj" in modules:
            load("unet", sd_weights.ip_adapter_unet_state_dict(preset.unet_cfg, ip_sd))
    for name in ("controlnet", "pose_guider"):
        if name in paths:
            load(name, sd_weights.load_checkpoint(paths[name]))
    return written
