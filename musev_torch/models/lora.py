"""LoRA fuse and unfuse by in-place weight delta (counterpart of ``musev_tpu/models/lora.py``).

Reference: musev/utils/model_util.py:108-263 (update_pipeline_lora_model):
LoRA weights are folded into the base weights (W += scale * up @ down)
rather than kept as runtime branches; unload subtracts the same delta
(model_util.py:468). Keys of the three common layouts (kohya, peft,
attn-procs) are matched to modules through the reference torch key maps of
``sd_weights``, by the JAX package's normalised names, so any linear or
conv site the checkpoint loader knows can take a LoRA. The port's modules
carry those torch keys, so a match names the parameter ``<key>.weight``
directly; torch keeps linears as (out, in), the delta's own layout, and
convolutions as OIHW (an InflatedConv3d as (O, I, 1, kH, kW)).

The delta and the add run in float32 on the weight's device, rounded once
to the weight's dtype; so in bf16 an unfuse restores the weights only
within that rounding.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from .sd_weights import clip_text_key_map, unet3d_key_map


def _normalize(name: str) -> str:
    return re.sub(r"[^a-z0-9]", "", name.lower())


def _collect_modules(key_map) -> Dict[str, str]:
    """normalised torch module name -> torch module name (linear and conv sites)."""
    return {_normalize(tk): tk for tk, _, kind in key_map if kind in ("linear", "conv2d")}


def parse_kohya_lora(state_dict: Mapping[str, object]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Group flat LoRA keys into {module: {down, up, alpha}}.

    The three layouts the JAX package's parser takes:
      * kohya:      lora_unet_<mod>.lora_down.weight / .lora_up / .alpha
      * peft:       unet.<mod>.lora_A[.default].weight / lora_B
      * attn-procs: unet.<mod>.processor.to_q_lora.down.weight / .up
    """
    mods: Dict[str, Dict[str, torch.Tensor]] = {}
    for k, v in state_dict.items():
        v = torch.as_tensor(v)
        if ".lora_down" in k:
            mods.setdefault(k.split(".lora_down", 1)[0], {})["down"] = v
        elif ".lora_up" in k:
            mods.setdefault(k.split(".lora_up", 1)[0], {})["up"] = v
        elif ".lora_A" in k:  # peft
            mods.setdefault(k.split(".lora_A", 1)[0], {})["down"] = v
        elif ".lora_B" in k:
            mods.setdefault(k.split(".lora_B", 1)[0], {})["up"] = v
        elif ".lora.down" in k:  # diffusers "<mod>.lora.down.weight"
            mods.setdefault(k.split(".lora.down", 1)[0], {})["down"] = v
        elif ".lora.up" in k:
            mods.setdefault(k.split(".lora.up", 1)[0], {})["up"] = v
        elif "_lora.down" in k:
            mods.setdefault(_strip_attn_proc(k.split(".down.weight", 1)[0]), {})["down"] = v
        elif "_lora.up" in k:
            mods.setdefault(_strip_attn_proc(k.split(".up.weight", 1)[0]), {})["up"] = v
        elif k.endswith(".alpha"):
            mods.setdefault(k[: -len(".alpha")], {})["alpha"] = v
    return mods


def _strip_attn_proc(mod: str) -> str:
    """'...attn1.processor.to_q_lora' -> '...attn1.to_q'."""
    mod = mod.replace(".processor.", ".")
    return re.sub(r"_lora$", "", mod).replace("to_out_lora", "to_out")


def _delta(entry: Dict[str, torch.Tensor], device) -> torch.Tensor:
    """(alpha / rank) * up @ down as float32 (out, in) on ``device``; a conv
    LoRA's (r, in, kh, kw) / (out, r, 1, 1) factors are flattened first."""
    down = entry["down"].to(device=device, dtype=torch.float32)
    up = entry["up"].to(device=device, dtype=torch.float32)
    if down.ndim == 4:
        down = down.reshape(down.shape[0], -1)
        up = up.reshape(up.shape[0], -1)
    rank = down.shape[0]
    alpha = float(entry.get("alpha", rank))
    return (alpha / rank) * (up @ down)


@torch.no_grad()
def fuse_lora(
    unet: nn.Module,
    lora_state_dict: Mapping[str, object],
    scale: float = 1.0,
    text_encoder: Optional[nn.Module] = None,
) -> Tuple[int, List[str]]:
    """Fold LoRA deltas into the UNet's (and the text encoder's) weights in
    place: W = dtype(float32(W) + scale * delta). Call again with
    ``scale=-scale`` to unfuse (model_util.py:468). Returns (modules fused,
    unmatched module names), in the JAX package's order. A name that
    matches a site the model does not build (a resnet without a
    ``conv_shortcut``) is unmatched here; the JAX package raises KeyError."""
    lookups = {"unet": _collect_modules(unet3d_key_map(unet.cfg))}
    params = {"unet": dict(unet.named_parameters())}
    if text_encoder is not None:
        lookups["text"] = _collect_modules(clip_text_key_map(text_encoder.cfg))
        params["text"] = dict(text_encoder.named_parameters())
    fused, unmatched = 0, []
    for mod, entry in parse_kohya_lora(lora_state_dict).items():
        if "down" not in entry or "up" not in entry:
            unmatched.append(mod)
            continue
        if mod.startswith("lora_unet_"):
            which, name = "unet", mod[len("lora_unet_"):]
        elif mod.startswith("unet."):
            which, name = "unet", mod[len("unet."):]
        elif mod.startswith("lora_te") and text_encoder is not None:
            # lora_te_ / lora_te1_ (sdxl splits te1/te2; te1 = CLIP-L)
            which, name = "text", mod.split("_", 2)[2]
        elif mod.startswith("text_encoder.") and text_encoder is not None:
            which, name = "text", mod[len("text_encoder."):]
        else:
            unmatched.append(mod)
            continue
        tk = lookups[which].get(_normalize(name))
        weight = None if tk is None else params[which].get(f"{tk}.weight")
        if weight is None:
            unmatched.append(mod)
            continue
        d = _delta(entry, weight.device).reshape(weight.shape)
        weight.copy_((weight.float() + scale * d).to(weight.dtype))
        fused += 1
    return fused, unmatched
