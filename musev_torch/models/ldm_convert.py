"""Original-LDM (.ckpt) checkpoint layout -> diffusers-layout key renamer.

A copy of ``musev_tpu/models/ldm_convert.py`` that takes torch tensors as
well as numpy arrays (it only renames keys and squeezes), the
counterpart of the reference's vendored HF script
(musev/utils/convert_from_ckpt.py, 963 LoC): users with a CompVis-layout
SD1.x checkpoint (``model.diffusion_model.*`` / ``first_stage_model.*`` /
``cond_stage_model.transformer.*``) get it split + renamed into the
diffusers key space that ``sd_weights``'s declarative tables consume. The
mapping below was re-derived from the SD1.x module structure, not copied.

Outputs: ``split_ldm_checkpoint(sd) -> {"unet": ..., "vae": ..., "text": ...}``
with diffusers-layout keys, ready for convert_unet3d / merge_sd_base_weights
/ convert_vae / convert_clip_text.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np

UNET_PREFIX = "model.diffusion_model."
VAE_PREFIX = "first_stage_model."
TEXT_PREFIX = "cond_stage_model.transformer."


def is_ldm_checkpoint(state_dict: Dict[str, np.ndarray]) -> bool:
    return any(k.startswith(UNET_PREFIX) for k in state_dict)


def _resnet_rename(key: str) -> str:
    key = key.replace("in_layers.0.", "norm1.")
    key = key.replace("in_layers.2.", "conv1.")
    key = key.replace("emb_layers.1.", "time_emb_proj.")
    key = key.replace("out_layers.0.", "norm2.")
    key = key.replace("out_layers.3.", "conv2.")
    key = key.replace("skip_connection.", "conv_shortcut.")
    return key


def convert_ldm_unet_keys(
    sd: Dict[str, np.ndarray], layers_per_block: int = 2
) -> Dict[str, np.ndarray]:
    """model.diffusion_model.* -> diffusers UNet2DConditionModel keys."""
    out: Dict[str, np.ndarray] = {}
    per = layers_per_block + 1  # input blocks per resolution incl. downsample
    for key, val in sd.items():
        if not key.startswith(UNET_PREFIX):
            continue
        k = key[len(UNET_PREFIX):]
        if k.startswith("time_embed.0."):
            nk = k.replace("time_embed.0.", "time_embedding.linear_1.")
        elif k.startswith("time_embed.2."):
            nk = k.replace("time_embed.2.", "time_embedding.linear_2.")
        elif k.startswith("input_blocks.0.0."):
            nk = k.replace("input_blocks.0.0.", "conv_in.")
        elif k.startswith("input_blocks."):
            m = re.match(r"input_blocks\.(\d+)\.(\d+)\.(.*)", k)
            i, sub, rest = int(m.group(1)), int(m.group(2)), m.group(3)
            block, layer = (i - 1) // per, (i - 1) % per
            if layer == layers_per_block:  # downsample slot
                nk = f"down_blocks.{block}.downsamplers.0.conv." + rest.replace(
                    "op.", ""
                )
            elif sub == 0:
                nk = f"down_blocks.{block}.resnets.{layer}." + _resnet_rename(rest)
            else:
                nk = f"down_blocks.{block}.attentions.{layer}." + rest
        elif k.startswith("middle_block.0."):
            nk = k.replace("middle_block.0.", "mid_block.resnets.0.")
            nk = _resnet_rename(nk)
        elif k.startswith("middle_block.1."):
            nk = k.replace("middle_block.1.", "mid_block.attentions.0.")
        elif k.startswith("middle_block.2."):
            nk = k.replace("middle_block.2.", "mid_block.resnets.1.")
            nk = _resnet_rename(nk)
        elif k.startswith("output_blocks."):
            m = re.match(r"output_blocks\.(\d+)\.(\d+)\.(.*)", k)
            i, sub, rest = int(m.group(1)), int(m.group(2)), m.group(3)
            block, layer = i // per, i % per
            if rest.startswith("conv.") and sub > 0:
                # upsampler: the trailing conv module of blocks 2, 5, 8
                nk = f"up_blocks.{block}.upsamplers.0.conv." + rest[len("conv."):]
            elif sub == 0:
                nk = f"up_blocks.{block}.resnets.{layer}." + _resnet_rename(rest)
            else:
                nk = f"up_blocks.{block}.attentions.{layer}." + rest
        elif k.startswith("out.0."):
            nk = k.replace("out.0.", "conv_norm_out.")
        elif k.startswith("out.2."):
            nk = k.replace("out.2.", "conv_out.")
        else:
            continue
        out[nk] = val
    return out


def _vae_attn_rename(rest: str) -> Tuple[str, bool]:
    """attn_1 member -> diffusers Attention member; second value = needs the
    (C, C, 1, 1) conv weight squeezed to a (C, C) linear."""
    table = {
        "norm.": ("group_norm.", False),
        "q.": ("to_q.", True),
        "k.": ("to_k.", True),
        "v.": ("to_v.", True),
        "proj_out.": ("to_out.0.", True),
    }
    for src, (dst, squeeze) in table.items():
        if rest.startswith(src):
            return dst + rest[len(src):], squeeze
    return rest, False


def convert_ldm_vae_keys(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """first_stage_model.* -> diffusers AutoencoderKL keys."""
    out: Dict[str, np.ndarray] = {}
    n_up = 1 + max(
        (int(m.group(1)) for k in sd for m in [re.match(
            re.escape(VAE_PREFIX) + r"decoder\.up\.(\d+)\.", k)] if m),
        default=3,
    )
    for key, val in sd.items():
        if not key.startswith(VAE_PREFIX):
            continue
        k = key[len(VAE_PREFIX):]
        nk = None
        squeeze = False
        m = re.match(r"encoder\.down\.(\d+)\.block\.(\d+)\.(.*)", k)
        if m:
            nk = (
                f"encoder.down_blocks.{m.group(1)}.resnets.{m.group(2)}."
                + m.group(3).replace("nin_shortcut.", "conv_shortcut.")
            )
        elif (m := re.match(r"encoder\.down\.(\d+)\.downsample\.conv\.(.*)", k)):
            nk = f"encoder.down_blocks.{m.group(1)}.downsamplers.0.conv.{m.group(2)}"
        elif (m := re.match(r"decoder\.up\.(\d+)\.block\.(\d+)\.(.*)", k)):
            # LDM decoder.up is indexed bottom-up; diffusers processes
            # top-down: up_blocks.i == decoder.up.(n-1-i)
            i = n_up - 1 - int(m.group(1))
            nk = (
                f"decoder.up_blocks.{i}.resnets.{m.group(2)}."
                + m.group(3).replace("nin_shortcut.", "conv_shortcut.")
            )
        elif (m := re.match(r"decoder\.up\.(\d+)\.upsample\.conv\.(.*)", k)):
            i = n_up - 1 - int(m.group(1))
            nk = f"decoder.up_blocks.{i}.upsamplers.0.conv.{m.group(2)}"
        elif (m := re.match(r"(encoder|decoder)\.mid\.block_([12])\.(.*)", k)):
            idx = int(m.group(2)) - 1
            nk = (
                f"{m.group(1)}.mid_block.resnets.{idx}."
                + m.group(3).replace("nin_shortcut.", "conv_shortcut.")
            )
        elif (m := re.match(r"(encoder|decoder)\.mid\.attn_1\.(.*)", k)):
            rest, squeeze = _vae_attn_rename(m.group(2))
            nk = f"{m.group(1)}.mid_block.attentions.0.{rest}"
        elif (m := re.match(r"(encoder|decoder)\.norm_out\.(.*)", k)):
            nk = f"{m.group(1)}.conv_norm_out.{m.group(2)}"
        elif k.startswith(("encoder.conv_in.", "encoder.conv_out.",
                           "decoder.conv_in.", "decoder.conv_out.",
                           "quant_conv.", "post_quant_conv.")):
            nk = k
        if nk is None:
            continue
        v = val  # a numpy array or a torch tensor
        if squeeze and nk.endswith(".weight") and v.ndim == 4:
            v = v[:, :, 0, 0]
        out[nk] = v
    return out


def convert_ldm_text_keys(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """cond_stage_model.transformer.* -> transformers CLIPTextModel keys
    (SD1.x stores the transformers layout verbatim under the prefix; SD2's
    open_clip layout is not supported — the reference converter has the
    same split, convert_from_ckpt.py textenc path)."""
    out = {}
    for key, val in sd.items():
        if key.startswith(TEXT_PREFIX):
            k = key[len(TEXT_PREFIX):]
            if not k.startswith("text_model."):
                k = "text_model." + k
            out[k] = val
    return out


def split_ldm_checkpoint(
    sd: Dict[str, np.ndarray]
) -> Dict[str, Dict[str, np.ndarray]]:
    return {
        "unet": convert_ldm_unet_keys(sd),
        "vae": convert_ldm_vae_keys(sd),
        "text": convert_ldm_text_keys(sd),
    }
