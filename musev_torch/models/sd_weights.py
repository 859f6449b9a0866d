"""Reference torch key maps, checkpoint reading and loading into the port's modules.

The key-map part is a copy of ``musev_tpu/models/sd_weights.py`` (the port
imports nothing of the JAX package): ``unet3d_key_map``, ``vae_key_map``,
``clip_text_key_map``, ``referencenet_key_map``, ``clip_vision_key_map``,
``image_proj_key_map``, ``resampler_key_map``, ``mlp_proj_key_map``,
``controlnet_key_map`` and ``pose_guider_key_map``
yield ``(torch_key, tree_path, kind)`` triples, and ``export_state_dict``
reads a JAX-layout param tree (nested dicts/lists of arrays) through a map
into torch-layout numpy arrays: HWIO -> OIHW for convolutions (HWIO ->
(O, I, 1, kH, kW) for an InflatedConv3d), (in, out) -> (out, in) for
linears, (kT, 1, I, O) -> (O, I, kT, 1, 1) for the temporal conv.
``ip_adapter_site_paths`` names the attn2 modules in the numbering of an
``ip_adapter.bin``. The maps the JAX package converts by hand
(``convert_resampler``, ``convert_mlp_proj``) are written as key maps here,
and the ReferenceNet's map gains the up blocks that ``need_self_attn_embs``
builds, which the JAX map lacks.

Checkpoints: ``load_safetensors`` reads the safetensors format itself (no
``safetensors`` package needed) through a memory map, and
``load_torch_checkpoint`` reads ``torch.save`` files. The port's modules
carry the reference key names, so ``load_into`` is a lookup into
``module.state_dict()`` that copies each tensor in place, cast to the
module's dtype on its device: the legacy VAE attention names are aliased
(``_VAE_LEGACY_ALIASES``), a 2-D conv weight (O, I, kH, kW) is lifted into
an InflatedConv3d (O, I, 1, kH, kW), and a shape that disagrees raises
naming the tensor and the preset. ``ip_adapter_unet_state_dict`` and
``image_proj_state_dict`` take an ``ip_adapter.bin`` (or a FaceID file)
apart.
"""

from __future__ import annotations

import json
import os
import struct
import zipfile
from typing import Dict, Iterable, Iterator, List, Mapping, Optional, Set, Tuple

import numpy as np
import torch
from torch import nn

Path = Tuple
KeyEntry = Tuple[str, Path, str]  # torch key prefix (no .weight/.bias), path, kind


def _attn_entries(tk: str, path: Path, with_ip: bool = False,
                  with_face: bool = False) -> Iterator[KeyEntry]:
    yield f"{tk}.to_q", (*path, "to_q"), "linear"
    yield f"{tk}.to_k", (*path, "to_k"), "linear"
    yield f"{tk}.to_v", (*path, "to_v"), "linear"
    yield f"{tk}.to_out.0", (*path, "to_out"), "linear"
    if with_ip:  # the IP-Adapter dual-KV projections
        yield f"{tk}.to_k_ip", (*path, "to_k_ip"), "linear"
        yield f"{tk}.to_v_ip", (*path, "to_v_ip"), "linear"
    if with_face:  # the FaceID pair
        yield f"{tk}.ip_adapter_face_to_k_ip", (*path, "to_k_ip_face"), "linear"
        yield f"{tk}.ip_adapter_face_to_v_ip", (*path, "to_v_ip_face"), "linear"


def _tf_block_entries(tk: str, path: Path, ip: bool = False,
                      face: bool = False) -> Iterator[KeyEntry]:
    yield f"{tk}.norm1", (*path, "norm1"), "norm"
    yield from _attn_entries(f"{tk}.attn1", (*path, "attn1"))
    yield f"{tk}.norm2", (*path, "norm2"), "norm"
    yield from _attn_entries(f"{tk}.attn2", (*path, "attn2"), with_ip=ip, with_face=face)
    yield f"{tk}.norm3", (*path, "norm3"), "norm"
    yield f"{tk}.ff.net.0.proj", (*path, "ff", "proj_in"), "linear"
    yield f"{tk}.ff.net.2", (*path, "ff", "proj_out"), "linear"


def _spatial_attn_entries(tk: str, path: Path, ip: bool = False,
                          face: bool = False) -> Iterator[KeyEntry]:
    yield f"{tk}.norm", (*path, "norm"), "norm"
    yield f"{tk}.proj_in", (*path, "proj_in"), "conv2d"
    yield from _tf_block_entries(f"{tk}.transformer_blocks.0", (*path, "block"), ip, face)
    yield f"{tk}.proj_out", (*path, "proj_out"), "conv2d"


def _temporal_attn_entries(tk: str, path: Path) -> Iterator[KeyEntry]:
    yield f"{tk}.norm", (*path, "norm"), "norm"
    yield f"{tk}.proj_in", (*path, "proj_in"), "linear"
    yield f"{tk}.frame_emb_proj", (*path, "femb_proj"), "linear"
    # need_spatial_position_emb: the sincos grid's per-pixel projection
    # (named as the JAX parameter; skipped where the tree has none)
    yield f"{tk}.spatial_emb_proj", (*path, "spatial_emb_proj"), "linear"
    yield from _tf_block_entries(f"{tk}.transformer_blocks.0", (*path, "block"))
    yield f"{tk}.proj_out", (*path, "proj_out"), "linear"
    yield f"{tk}.temporal_weight", (*path, "temporal_weight"), "raw"


def _temporal_conv_entries(tk: str, path: Path) -> Iterator[KeyEntry]:
    # conv1 = (GN, SiLU, Conv) -> .0/.2; conv2..4 = (GN, SiLU, Dropout, Conv)
    # -> .0/.3 (reference resnet.py:56-78)
    for i in range(1, 5):
        conv_idx = 2 if i == 1 else 3
        yield f"{tk}.conv{i}.0", (*path, f"conv{i}", "norm"), "norm"
        yield f"{tk}.conv{i}.{conv_idx}", (*path, f"conv{i}", "conv"), "conv3d_t"
    yield f"{tk}.temporal_weight", (*path, "temporal_weight"), "raw"


def _resnet_entries(tk: str, path: Path, temb: bool = True) -> Iterator[KeyEntry]:
    yield f"{tk}.norm1", (*path, "norm1"), "norm"
    yield f"{tk}.conv1", (*path, "conv1"), "conv2d"
    if temb:
        yield f"{tk}.time_emb_proj", (*path, "time_emb_proj"), "linear"
    yield f"{tk}.norm2", (*path, "norm2"), "norm"
    yield f"{tk}.conv2", (*path, "conv2"), "conv2d"
    yield f"{tk}.conv_shortcut", (*path, "conv_shortcut"), "conv2d"


def unet3d_key_map(cfg) -> Iterator[KeyEntry]:
    """Keys of the UNet3D sites this port builds (the ReferenceNet fuse, the
    IP-Adapter and FaceID projections and the spatial position embedding
    included)."""
    yield "conv_in", ("conv_in",), "conv2d"
    yield "time_embedding.linear_1", ("time_embedding", "linear_1"), "linear"
    yield "time_embedding.linear_2", ("time_embedding", "linear_2"), "linear"
    if cfg.temporal_transformer:
        yield "frame_embedding.linear_1", ("frame_embedding", "linear_1"), "linear"
        yield "frame_embedding.linear_2", ("frame_embedding", "linear_2"), "linear"
    if cfg.need_transformer_in and cfg.temporal_transformer:
        yield from _temporal_attn_entries("transformer_in", ("transformer_in",))
    if cfg.need_spatial_position_emb:
        for lin in ("linear_1", "linear_2"):
            yield (f"spatial_position_embedding.{lin}", ("spatial_position_embedding", lin),
                   "linear")
    ip = (cfg.ip_adapter_cross_attn, cfg.need_ip_adapter_face)
    for i, btype in enumerate(cfg.down_block_types):
        base = f"down_blocks.{i}"
        for j in range(cfg.layers_per_block):
            path = ("down_blocks", i, "layers", j)
            yield from _resnet_entries(f"{base}.resnets.{j}", (*path, "resnet"))
            if cfg.temporal_conv:
                yield from _temporal_conv_entries(f"{base}.temp_convs.{j}", (*path, "temp_conv"))
            if "CrossAttn" in btype:
                yield from _spatial_attn_entries(f"{base}.attentions.{j}", (*path, "attn"), *ip)
            if cfg.temporal_transformer:
                yield from _temporal_attn_entries(
                    f"{base}.temp_attentions.{j}", (*path, "temp_attn")
                )
        last = i == len(cfg.down_block_types) - 1
        if not last:
            yield (f"{base}.downsamplers.0.conv", ("down_blocks", i, "downsample", "conv"),
                   "conv2d")
        if cfg.need_refer_emb:
            for j in range(cfg.layers_per_block + (0 if last else 1)):
                yield from _attn_entries(f"{base}.refer_emb_attns.{j}",
                                         ("down_blocks", i, "refer_emb_attns", j))
    if cfg.need_refer_emb:
        yield from _attn_entries("first_refer_emb_attns", ("first_refer_emb_attns",))
        yield from _attn_entries("mid_block_refer_emb_attns", ("mid_block_refer_emb_attns",))
    yield from _resnet_entries("mid_block.resnets.0", ("mid_block", "resnet_0"))
    yield from _resnet_entries("mid_block.resnets.1", ("mid_block", "resnet_1"))
    if cfg.temporal_conv:
        yield from _temporal_conv_entries("mid_block.temp_convs.0", ("mid_block", "temp_conv_0"))
        yield from _temporal_conv_entries("mid_block.temp_convs.1", ("mid_block", "temp_conv_1"))
    yield from _spatial_attn_entries("mid_block.attentions.0", ("mid_block", "attn"), *ip)
    if cfg.temporal_transformer:
        yield from _temporal_attn_entries(
            "mid_block.temp_attentions.0", ("mid_block", "temp_attn")
        )
    for i, btype in enumerate(cfg.up_block_types):
        base = f"up_blocks.{i}"
        for j in range(cfg.layers_per_block + 1):
            path = ("up_blocks", i, "layers", j)
            yield from _resnet_entries(f"{base}.resnets.{j}", (*path, "resnet"))
            if cfg.temporal_conv:
                yield from _temporal_conv_entries(f"{base}.temp_convs.{j}", (*path, "temp_conv"))
            if "CrossAttn" in btype:
                yield from _spatial_attn_entries(f"{base}.attentions.{j}", (*path, "attn"), *ip)
            if cfg.temporal_transformer:
                yield from _temporal_attn_entries(
                    f"{base}.temp_attentions.{j}", (*path, "temp_attn")
                )
        if i < len(cfg.up_block_types) - 1:
            yield (f"{base}.upsamplers.0.conv", ("up_blocks", i, "upsample", "conv"), "conv2d")
    yield "conv_norm_out", ("conv_norm_out",), "norm"
    yield "conv_out", ("conv_out",), "conv2d"


def vae_key_map(cfg) -> Iterator[KeyEntry]:
    def attn(tk, path):
        yield f"{tk}.group_norm", (*path, "norm"), "norm"
        yield f"{tk}.to_q", (*path, "to_q"), "linear"
        yield f"{tk}.to_k", (*path, "to_k"), "linear"
        yield f"{tk}.to_v", (*path, "to_v"), "linear"
        yield f"{tk}.to_out.0", (*path, "to_out"), "linear"

    n = len(cfg.block_out_channels)
    yield "encoder.conv_in", ("encoder", "conv_in"), "conv2d"
    for i in range(n):
        for j in range(cfg.layers_per_block):
            yield from _resnet_entries(
                f"encoder.down_blocks.{i}.resnets.{j}", ("encoder", "down", i, "layers", j),
                temb=False,
            )
        if i < n - 1:
            yield (f"encoder.down_blocks.{i}.downsamplers.0.conv",
                   ("encoder", "down", i, "downsample"), "conv2d")
    for side in ("encoder", "decoder"):
        if side == "decoder":
            yield "quant_conv", ("quant_conv",), "conv2d"
            yield "post_quant_conv", ("post_quant_conv",), "conv2d"
            yield "decoder.conv_in", ("decoder", "conv_in"), "conv2d"
        yield from _resnet_entries(f"{side}.mid_block.resnets.0", (side, "mid", "resnet_0"),
                                   temb=False)
        yield from attn(f"{side}.mid_block.attentions.0", (side, "mid", "attn"))
        yield from _resnet_entries(f"{side}.mid_block.resnets.1", (side, "mid", "resnet_1"),
                                   temb=False)
        if side == "encoder":
            yield "encoder.conv_norm_out", ("encoder", "norm_out"), "norm"
            yield "encoder.conv_out", ("encoder", "conv_out"), "conv2d"
    for i in range(n):
        for j in range(cfg.layers_per_block + 1):
            yield from _resnet_entries(
                f"decoder.up_blocks.{i}.resnets.{j}", ("decoder", "up", i, "layers", j),
                temb=False,
            )
        if i < n - 1:
            yield (f"decoder.up_blocks.{i}.upsamplers.0.conv",
                   ("decoder", "up", i, "upsample"), "conv2d")
    yield "decoder.conv_norm_out", ("decoder", "norm_out"), "norm"
    yield "decoder.conv_out", ("decoder", "conv_out"), "conv2d"


def clip_text_key_map(cfg) -> Iterator[KeyEntry]:
    yield "text_model.embeddings.token_embedding", ("token_embedding",), "embedding"
    yield "text_model.embeddings.position_embedding", ("position_embedding",), "embedding"
    for i in range(cfg.num_layers):
        pre = f"text_model.encoder.layers.{i}"
        path = ("layers", i)
        yield f"{pre}.layer_norm1", (*path, "layer_norm1"), "norm"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            yield f"{pre}.self_attn.{n}", (*path, n), "linear"
        yield f"{pre}.layer_norm2", (*path, "layer_norm2"), "norm"
        yield f"{pre}.mlp.fc1", (*path, "fc1"), "linear"
        yield f"{pre}.mlp.fc2", (*path, "fc2"), "linear"
    yield "text_model.final_layer_norm", ("final_layer_norm",), "norm"


def referencenet_key_map(cfg) -> Iterator[KeyEntry]:
    """ReferenceNet2D = the SD UNet trunk (its head pruned, referencenet.py
    :624-636): the 2D UNet's down and mid keys, and its up blocks' under
    ``need_self_attn_embs``."""
    yield "conv_in", ("conv_in",), "conv2d"
    yield "time_embedding.linear_1", ("time_embedding", "linear_1"), "linear"
    yield "time_embedding.linear_2", ("time_embedding", "linear_2"), "linear"
    n = len(cfg.block_out_channels)
    for i in range(n):
        base = f"down_blocks.{i}"
        for j in range(cfg.layers_per_block):
            path = ("down_blocks", i, "layers", j)
            yield from _resnet_entries(f"{base}.resnets.{j}", (*path, "resnet"))
            if i < n - 1:
                yield from _spatial_attn_entries(f"{base}.attentions.{j}", (*path, "attn"))
        if i < n - 1:
            yield (f"{base}.downsamplers.0.conv", ("down_blocks", i, "downsample", "conv"),
                   "conv2d")
    yield from _resnet_entries("mid_block.resnets.0", ("mid_block", "resnet_0"))
    yield from _spatial_attn_entries("mid_block.attentions.0", ("mid_block", "attn"))
    yield from _resnet_entries("mid_block.resnets.1", ("mid_block", "resnet_1"))
    if not cfg.need_self_attn_embs:
        return
    for i in range(n):  # SD1.5: the first up block has no attention
        base = f"up_blocks.{i}"
        for j in range(cfg.layers_per_block + 1):
            path = ("up_blocks", i, "layers", j)
            yield from _resnet_entries(f"{base}.resnets.{j}", (*path, "resnet"))
            if i > 0:
                yield from _spatial_attn_entries(f"{base}.attentions.{j}", (*path, "attn"))
        if i < n - 1:
            yield f"{base}.upsamplers.0.conv", ("up_blocks", i, "upsample", "conv"), "conv2d"


def controlnet_key_map(cfg) -> Iterator[KeyEntry]:
    """diffusers ControlNetModel keys (``controlnet_key_map``,
    sd_weights.py:279-335): the trunk of ``referencenet_key_map`` plus the
    conditioning stem and one zero conv per skip feature and the mid block."""
    yield "conv_in", ("conv_in",), "conv2d"
    yield "time_embedding.linear_1", ("time_embedding", "linear_1"), "linear"
    yield "time_embedding.linear_2", ("time_embedding", "linear_2"), "linear"
    ce = "controlnet_cond_embedding"
    yield f"{ce}.conv_in", ("cond_embedding", "conv_in"), "conv2d"
    for i in range(len(cfg.cond_embed_channels) - 1):
        yield f"{ce}.blocks.{2 * i}", ("cond_embedding", "blocks", i, "conv1"), "conv2d"
        yield f"{ce}.blocks.{2 * i + 1}", ("cond_embedding", "blocks", i, "conv2"), "conv2d"
    yield f"{ce}.conv_out", ("cond_embedding", "conv_out"), "conv2d"
    n = len(cfg.block_out_channels)
    zc = 0
    yield f"controlnet_down_blocks.{zc}", ("zero_convs", zc), "conv2d"
    for i in range(n):
        base = f"down_blocks.{i}"
        for j in range(cfg.layers_per_block):
            path = ("down_blocks", i, "layers", j)
            yield from _resnet_entries(f"{base}.resnets.{j}", (*path, "resnet"))
            if i < n - 1:
                yield from _spatial_attn_entries(f"{base}.attentions.{j}", (*path, "attn"))
            zc += 1
            yield f"controlnet_down_blocks.{zc}", ("zero_convs", zc), "conv2d"
        if i < n - 1:
            yield (f"{base}.downsamplers.0.conv", ("down_blocks", i, "downsample", "conv"),
                   "conv2d")
            zc += 1
            yield f"controlnet_down_blocks.{zc}", ("zero_convs", zc), "conv2d"
    yield from _resnet_entries("mid_block.resnets.0", ("mid_block", "resnet_0"))
    yield from _spatial_attn_entries("mid_block.attentions.0", ("mid_block", "attn"))
    yield from _resnet_entries("mid_block.resnets.1", ("mid_block", "resnet_1"))
    yield "controlnet_mid_block", ("mid_zero_conv",), "conv2d"


def pose_guider_key_map(cfg) -> Iterator[KeyEntry]:
    """PoseGuider keys (``pose_guider_key_map``, sd_weights.py:575-587):
    conv_in, (conv, strided conv) pairs and conv_out, all InflatedConv3d."""
    yield "conv_in", ("conv_in",), "conv3d_spatial"
    for i in range(len(cfg.cond_embed_channels) - 1):
        yield f"blocks.{2 * i}", ("blocks", i, "conv1"), "conv3d_spatial"
        yield f"blocks.{2 * i + 1}", ("blocks", i, "conv2"), "conv3d_spatial"
    yield "conv_out", ("conv_out",), "conv3d_spatial"


def clip_vision_key_map(cfg) -> Iterator[KeyEntry]:
    """transformers CLIPVisionModelWithProjection keys (the IP-Adapter image
    encoder). The JAX package converts the bare HWIO patch-embedding array
    outside its map (``convert_clip_vision``); here it is the "patch" entry.
    'pre_layrnorm' is the checkpoints' own spelling."""
    pre = "vision_model"
    yield f"{pre}.embeddings.patch_embedding", ("patch_embedding",), "patch"
    yield f"{pre}.embeddings.class_embedding", ("class_embedding",), "raw"
    yield f"{pre}.embeddings.position_embedding", ("position_embedding",), "embedding"
    yield f"{pre}.pre_layrnorm", ("pre_layrnorm",), "norm"
    for i in range(cfg.num_layers):
        lk = f"{pre}.encoder.layers.{i}"
        path = ("layers", i)
        yield f"{lk}.layer_norm1", (*path, "layer_norm1"), "norm"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            yield f"{lk}.self_attn.{n}", (*path, n), "linear"
        yield f"{lk}.layer_norm2", (*path, "layer_norm2"), "norm"
        yield f"{lk}.mlp.fc1", (*path, "fc1"), "linear"
        yield f"{lk}.mlp.fc2", (*path, "fc2"), "linear"
    yield f"{pre}.post_layernorm", ("post_layernorm",), "norm"
    yield "visual_projection", ("visual_projection",), "linear"


def image_proj_key_map() -> Iterator[KeyEntry]:
    """ImageProjModel, the "image_proj" part of an ip_adapter.bin
    (``convert_image_proj``, sd_weights.py:747-765)."""
    yield "proj", ("proj",), "linear"
    yield "norm", ("norm",), "norm"


def resampler_key_map(cfg) -> Iterator[KeyEntry]:
    """The IP-Adapter-Plus Resampler, the "image_proj" part of an
    ip-adapter-plus file: ``layers.{i}.0`` the PerceiverAttention (norm1
    over the image tokens, norm2 over the latents), ``layers.{i}.1`` its
    feed-forward (LayerNorm, Linear, GELU, Linear) (``convert_resampler``,
    sd_weights.py:795-840); the latents (1, Q, D) against the JAX (Q, D)."""
    yield "latents", ("latents",), "latents"
    yield "proj_in", ("proj_in",), "linear"
    yield "proj_out", ("proj_out",), "linear"
    yield "norm_out", ("norm_out",), "norm"
    for i in range(cfg.depth):
        path = ("layers", i)
        yield f"layers.{i}.0.norm1", (*path, "norm_media"), "norm"
        yield f"layers.{i}.0.norm2", (*path, "norm1"), "norm"
        for name in ("to_q", "to_kv", "to_out"):
            yield f"layers.{i}.0.{name}", (*path, name), "linear"
        yield f"layers.{i}.1.0", (*path, "ff_norm"), "norm"
        yield f"layers.{i}.1.1", (*path, "ff1"), "linear"
        yield f"layers.{i}.1.3", (*path, "ff2"), "linear"


def mlp_proj_key_map() -> Iterator[KeyEntry]:
    """The FaceID MLPProjModel, the "image_proj" part of an
    ip-adapter-faceid file (``convert_mlp_proj``, sd_weights.py:767-794)."""
    yield "proj.0", ("fc1",), "linear"
    yield "proj.2", ("fc2",), "linear"
    yield "norm", ("norm",), "norm"


def ip_adapter_site_paths(cfg) -> List[str]:
    """Module prefixes of the attn2 sites in the IP-Adapter checkpoint order:
    down blocks, up blocks (skipping the attention-less first up block), mid
    last (``ip_adapter_site_paths``, sd_weights.py:700-716, after
    ip_adapter_loader.py:232-305). Site i holds the checkpoint's
    ``{2i + 1}.to_k_ip.weight`` and ``{2i + 1}.to_v_ip.weight``."""
    block = "transformer_blocks.0.attn2"
    paths = []
    for i, btype in enumerate(cfg.down_block_types):
        if "CrossAttn" in btype:
            for j in range(cfg.layers_per_block):
                paths.append(f"down_blocks.{i}.attentions.{j}.{block}")
    for i, btype in enumerate(cfg.up_block_types):
        if "CrossAttn" in btype:
            for j in range(cfg.layers_per_block + 1):
                paths.append(f"up_blocks.{i}.attentions.{j}.{block}")
    paths.append(f"mid_block.attentions.0.{block}")
    return paths


def _get(tree, path):
    for k in path:
        if isinstance(tree, (list, tuple)):
            tree = tree[k]
        else:
            if k not in tree:
                return None
            tree = tree[k]
    return tree


def export_state_dict(key_map, params) -> Dict[str, np.ndarray]:
    """Read a JAX-layout param tree through a key map into torch-layout
    arrays; sites absent from the tree are skipped."""
    out: Dict[str, np.ndarray] = {}
    c = np.ascontiguousarray
    for tk, path, kind in key_map:
        if kind in ("raw", "embedding", "latents"):
            node = _get(params, path[:-1])
            if node is None or path[-1] not in node:
                continue
            arr = np.asarray(node[path[-1]])
            out[f"{tk}.weight" if kind == "embedding" else tk] = c(
                arr[None] if kind == "latents" else arr)
            continue
        node = _get(params, path)
        if node is None or (kind != "patch" and "kernel" not in node and "scale" not in node):
            continue
        if kind == "norm":
            out[f"{tk}.weight"] = c(np.asarray(node["scale"]))
            out[f"{tk}.bias"] = c(np.asarray(node["bias"]))
            continue
        if kind == "patch":  # bare HWIO conv array
            out[f"{tk}.weight"] = c(np.asarray(node).transpose(3, 2, 0, 1))
            continue
        kern = np.asarray(node["kernel"])
        if kind == "linear":
            out[f"{tk}.weight"] = c(kern.T)
        elif kind == "conv2d":
            out[f"{tk}.weight"] = c(kern.transpose(3, 2, 0, 1))
        elif kind == "conv3d_spatial":  # InflatedConv3d (O, I, 1, kH, kW)
            out[f"{tk}.weight"] = c(kern.transpose(3, 2, 0, 1)[:, :, None])
        elif kind == "conv3d_t":
            out[f"{tk}.weight"] = c(kern.transpose(3, 2, 0, 1)[:, :, :, :, None])
        else:
            raise ValueError(kind)
        if "bias" in node:
            out[f"{tk}.bias"] = c(np.asarray(node["bias"]))
    return out



# ---------------------------------------------------------------------------
# reading checkpoints and loading them into modules

# diffusers' pre-0.14 VAE attention names (``_VAE_LEGACY_ALIASES``,
# musev_tpu/models/sd_weights.py:393)
_VAE_LEGACY_ALIASES = {
    ".query": ".to_q",
    ".key": ".to_k",
    ".value": ".to_v",
    ".proj_attn": ".to_out.0",
}

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Tensors of a ``.safetensors`` file: a little-endian u64 header size N,
    N bytes of JSON ``{name: {"dtype", "shape", "data_offsets": [begin,
    end]}}`` (and an optional ``__metadata__``), then the raw bytes, offsets
    counted from the end of the header. The file is memory-mapped
    copy-on-write: each tensor is a view of the map, read from disk when it
    is copied, so a file of several GB is never held twice."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    size = os.path.getsize(path) - 8 - n
    data = np.memmap(path, dtype=np.uint8, mode="c", offset=8 + n) if size > 0 else \
        np.empty(0, np.uint8)  # numpy cannot map zero bytes
    out = {}
    for name, info in header.items():
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']!r}")
        begin, end = info["data_offsets"]
        itemsize = torch.empty((), dtype=dtype).element_size()
        if not 0 <= begin <= end <= data.shape[0] or \
                end - begin != itemsize * int(np.prod(info["shape"], dtype=np.int64)):
            raise ValueError(f"{path}: tensor {name!r} has data offsets {info['data_offsets']} "
                             f"that do not fit its shape {info['shape']} or the file")
        if begin == end:  # an empty tensor: its zero-byte slice cannot be viewed as dtype
            out[name] = torch.empty(info["shape"], dtype=dtype)
            continue
        raw = data[begin:end]
        if begin % itemsize:  # a writer that did not align its tensors
            raw = raw.copy()
        out[name] = torch.from_numpy(raw).view(dtype).reshape(info["shape"])
    return out


def load_torch_checkpoint(path: str) -> Dict[str, object]:
    """A ``torch.save`` file, read with ``weights_only=True`` (and
    memory-mapped where it is in the zip format); a ``state_dict`` entry is
    unwrapped. Nested dicts stay nested: an ``ip_adapter.bin`` holds
    ``{"image_proj": {...}, "ip_adapter": {...}}``."""
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=zipfile.is_zipfile(path))
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def load_checkpoint(path: str) -> Dict[str, object]:
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    return load_torch_checkpoint(path)


def _apply_aliases(key: str, aliases: Mapping[str, str]) -> str:
    for old, new in aliases.items():
        key = key.replace(old, new)
    return key


def _check_shape(name: str, preset: str, want: Tuple[int, ...], got: Tuple[int, ...]) -> None:
    if tuple(want) != tuple(got):
        raise ValueError(
            f"checkpoint tensor {name} has shape {tuple(got)}, the {preset} preset's model "
            f"expects {tuple(want)}: wrong checkpoint for this architecture preset?"
        )


@torch.no_grad()
def load_into(module: nn.Module, state_dict: Mapping[str, object], preset: str,
              aliases: Optional[Mapping[str, str]] = None) -> Set[str]:
    """Copy every tensor of ``state_dict`` whose key (after ``aliases``) is a
    key of ``module.state_dict()`` into the module in place: cast to the
    module's dtype, onto its device, into its memory format (a
    ``channels_last`` conv kernel stays so). A 4-D tensor for a 5-D
    InflatedConv3d weight (O, I, 1, kH, kW) gains its unit time axis. Keys
    the module lacks are ignored. Returns the module keys written."""
    own = module.state_dict()
    written = set()
    for key, value in state_dict.items():
        if not torch.is_tensor(value):
            continue
        key = _apply_aliases(key, aliases) if aliases else key
        target = own.get(key)
        if target is None:
            continue
        if value.ndim == 4 and target.ndim == 5 and target.shape[2] == 1:
            value = value.unsqueeze(2)
        _check_shape(key, preset, target.shape, value.shape)
        target.copy_(value)
        written.add(key)
    return written


def missing_keys(module: nn.Module, written: Iterable[str]) -> List[str]:
    """Keys of ``module.state_dict()`` that no checkpoint wrote."""
    written = set(written)
    return [k for k in module.state_dict() if k not in written]


def ip_adapter_unet_state_dict(cfg, ip_state_dict: Mapping[str, object],
                               face: bool = False) -> Dict[str, object]:
    """The numbered ``{2i + 1}.to_k_ip.weight`` / ``.to_v_ip.weight`` of an
    ``ip_adapter.bin`` ("ip_adapter" part) under the UNet's own keys, site i
    of ``ip_adapter_site_paths``; ``face=True`` puts a FaceID file's pairs
    on the ``ip_adapter_face_to_k_ip`` / ``_v_ip`` slots
    (``convert_ip_adapter_unet``, musev_tpu/models/sd_weights.py:719-746)."""
    sd = ip_state_dict.get("ip_adapter", ip_state_dict)
    out = {}
    for i, site in enumerate(ip_adapter_site_paths(cfg)):
        for proj in ("to_k_ip", "to_v_ip"):
            key = f"{2 * i + 1}.{proj}.weight"
            if key in sd:
                out[f"{site}.{'ip_adapter_face_' if face else ''}{proj}.weight"] = sd[key]
    return out


def image_proj_state_dict(ip_state_dict: Mapping[str, object]) -> Mapping[str, object]:
    """The projection part of an ``ip_adapter.bin`` ("image_proj"): the
    ImageProjModel's, the Resampler's or the FaceID MLPProjModel's keys
    (``convert_image_proj``, ``convert_resampler``, ``convert_mlp_proj``)."""
    return ip_state_dict.get("image_proj", ip_state_dict)
