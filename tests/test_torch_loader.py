"""The port's checkpoint ingestion against the JAX package's loader.

A checkpoint set is written from a JAX ``build_models`` donor (tiny presets
of the CLIs' ``_shrink_preset``) through ``musev_tpu.models.sd_weights``'s
exporters, in the layouts users hold: a diffusers unet, a T2I base of the
spatial sites from a second donor, a VAE with the legacy attention names, a
CLIP text encoder as a torch file, ReferenceNet, CLIP vision, an
``ip_adapter.bin`` (nested ``image_proj`` / numbered ``ip_adapter``), the
ControlNet and a PoseGuider with 2-D conv kernels. Both loaders read the
same files with ``strict=True``; every module of the port must equal the
JAX loader's params carried by ``musev_torch.models.convert`` exactly
(atol 0: loading is a copy). JAX only builds params here (``fast_init``
traces the init functions shape-only); nothing is run or jitted.
"""

import dataclasses
import logging
import re

import numpy as np
import pytest
import safetensors.numpy as stn
import safetensors.torch as stt
import torch

from musev_tpu.cli.text2video import _shrink_preset as j_shrink
from musev_tpu.configs.model_registry import get_model_preset as j_preset
from musev_tpu.models import sd_weights as jsw
from musev_tpu.pipelines.loader import build_models as j_build
from musev_torch.cli.text2video import _shrink_preset
from musev_torch.configs.model_registry import get_model_preset
from musev_torch.models import convert, sd_weights
from musev_torch.pipelines import loader
from musev_torch.pipelines.loader import build_models


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: torch's OpenMP pool spun
    against the suite's other xdist workers. Restored after, as the setting
    is the process's and JAX shares it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


PRESETS = ("musev", "musev_referencenet", "musev_referencenet_pose")
_MUSEV_ONLY = ("temp_", "frame_embedding", "transformer_in", "refer_emb", "to_k_ip", "to_v_ip")
_LEGACY = {".to_q.": ".query.", ".to_k.": ".key.", ".to_v.": ".value.", ".to_out.0.": ".proj_attn."}


def _presets(name, **unet):
    """The same tiny preset in both packages (unet config fields overridden)."""
    jp, tp = j_shrink(j_preset(name)), _shrink_preset(get_model_preset(name))
    jp.unet_cfg = dataclasses.replace(jp.unet_cfg, **unet)
    tp.unet_cfg = dataclasses.replace(tp.unet_cfg, **unet)
    return jp, tp


def _f32(sd):
    return {k: np.ascontiguousarray(np.asarray(v, np.float32)) for k, v in sd.items()}


def _spatial(sd):
    """The keys an SD1.5 base file holds: none of MuseV's own sites."""
    return {k: v for k, v in sd.items() if not any(s in k for s in _MUSEV_ONLY)}


def _write_set(d, name, **unet):
    """Write a checkpoint set of tiny preset ``name``; returns (paths, donors)."""
    jp, _ = _presets(name, **unet)
    jp.pose_guider_checkpoint = str(d / "absent")  # builds a random PoseGuider donor
    donor, donor2 = j_build(jp, seed=7), j_build(jp, seed=11)
    rng = np.random.default_rng(3)
    p = {}

    def save(fname, sd):
        p[fname] = str(d / fname)
        if fname.endswith(".safetensors"):
            stn.save_file(_f32(sd), p[fname])
        else:
            torch.save({k: torch.from_numpy(v) for k, v in _f32(sd).items()}, p[fname])

    save("unet.safetensors", jsw.export_unet3d(donor.unet_params, jp.unet_cfg))
    save("sd_base.safetensors", _spatial(jsw.export_unet3d(donor2.unet_params, jp.unet_cfg)))
    vae = jsw.export_state_dict(jsw.vae_key_map(jp.vae_cfg), donor.vae_params)
    legacy = {}
    for k, v in vae.items():
        if ".attentions." in k:
            for new, old in _LEGACY.items():
                k = k.replace(new, old)
        legacy[k] = v
    assert any(".query." in k for k in legacy)
    save("vae.safetensors", legacy)
    save("text.bin", jsw.export_state_dict(jsw.clip_text_key_map(jp.text_cfg), donor.text_params))
    if jp.referencenet_cfg is not None:
        save("referencenet.safetensors", jsw.export_state_dict(
            jsw.referencenet_key_map(jp.referencenet_cfg), donor.referencenet_params))
        cv = jsw.export_state_dict(jsw.clip_vision_key_map(jp.clip_vision_cfg),
                                   donor.clip_vision_params)
        cv["vision_model.embeddings.patch_embedding.weight"] = np.asarray(
            donor.clip_vision_params["patch_embedding"]).transpose(3, 2, 0, 1)
        save("clip_vision.safetensors", cv)
        # tencent-ailab layout: {"image_proj": ImageProjModel, "ip_adapter": numbered KV}
        ip = {}
        for i, site in enumerate(jsw.ip_adapter_site_paths(jp.unet_cfg)):
            node = donor.unet_params
            for key in site:
                node = node[key]
            for proj in ("to_k_ip", "to_v_ip"):
                ip[f"{2 * i + 1}.{proj}.weight"] = torch.from_numpy(
                    rng.standard_normal(node[proj]["kernel"].shape[::-1], dtype=np.float32))
        pk = np.asarray(donor.ip_proj_params["proj"]["kernel"])
        width = np.asarray(donor.ip_proj_params["norm"]["scale"]).shape[0]
        image_proj = {
            "proj.weight": rng.standard_normal(pk.shape[::-1], dtype=np.float32),
            "proj.bias": rng.standard_normal(pk.shape[1], dtype=np.float32),
            "norm.weight": rng.standard_normal(width, dtype=np.float32),
            "norm.bias": rng.standard_normal(width, dtype=np.float32),
        }
        p["ip_adapter.bin"] = str(d / "ip_adapter.bin")
        torch.save({"image_proj": {k: torch.from_numpy(v) for k, v in image_proj.items()},
                    "ip_adapter": ip}, p["ip_adapter.bin"])
    if jp.controlnet_cfg is not None:
        save("controlnet.safetensors", jsw.export_state_dict(
            jsw.controlnet_key_map(jp.controlnet_cfg), donor.controlnet_params))
    # the PoseGuider's InflatedConv3d kernels stored as 2-D convs (O, I, kH, kW)
    pg = jsw.export_state_dict(jsw.pose_guider_key_map(donor.pose_guider_cfg),
                               donor.pose_guider_params)
    save("pose_guider.pth", {k: v[:, :, 0] if v.ndim == 5 else v for k, v in pg.items()})
    return p, donor, donor2


_SLOTS = dict(unet="unet.safetensors", sd_base="sd_base.safetensors", vae="vae.safetensors",
              text="text.bin", referencenet="referencenet.safetensors",
              clip_vision="clip_vision.safetensors", ip_adapter="ip_adapter.bin",
              controlnet="controlnet.safetensors", pose_guider="pose_guider.pth")


def _with_paths(preset, paths, **replace):
    for slot, fname in _SLOTS.items():
        if fname in paths:
            setattr(preset, f"{slot}_checkpoint", replace.get(slot, paths[fname]))
    return preset


@pytest.fixture(scope="module", params=PRESETS)
def ckpt_set(request, tmp_path_factory):
    d = tmp_path_factory.mktemp(request.param)
    paths, donor, donor2 = _write_set(d, request.param)
    return request.param, d, paths, donor, donor2


def _port_and_jax(name, paths, **unet):
    jp, tp = _presets(name, **unet)
    jm = j_build(_with_paths(jp, paths), seed=3, strict=True)
    tm = build_models(_with_paths(tp, paths), device="cpu", seed=5, strict=True)
    return jp, jm, tm


def _assert_equal(module, want):
    got = module.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_loader_reproduces_jax_loader(ckpt_set):
    name, _, paths, donor, donor2 = ckpt_set
    jp, jm, tm = _port_and_jax(name, paths)
    _assert_equal(tm.unet, convert.unet3d_from_jax(jm.unet_params, jp.unet_cfg))
    _assert_equal(tm.vae, convert.vae_from_jax(jm.vae_params, jp.vae_cfg))
    _assert_equal(tm.text_encoder, convert.clip_text_from_jax(jm.text_params, jp.text_cfg))
    _assert_equal(tm.pose_guider, convert.pose_guider_from_jax(jm.pose_guider_params,
                                                               jm.pose_guider_cfg))
    if jp.referencenet_cfg is not None:
        _assert_equal(tm.referencenet,
                      convert.referencenet_from_jax(jm.referencenet_params, jp.referencenet_cfg))
        _assert_equal(tm.clip_vision,
                      convert.clip_vision_from_jax(jm.clip_vision_params, jp.clip_vision_cfg))
        _assert_equal(tm.ip_proj, convert.image_proj_from_jax(jm.ip_proj_params))
    if jp.controlnet_cfg is not None:
        _assert_equal(tm.controlnet,
                      convert.controlnet_from_jax(jm.controlnet_params, jp.controlnet_cfg))
    # the files did reach the modules: spatial from the base donor, temporal
    # from the unet donor; the conv kernels keep their channels_last layout
    unet = tm.unet.state_dict()
    base = jsw.export_unet3d(donor2.unet_params, jp.unet_cfg)
    own = jsw.export_unet3d(donor.unet_params, jp.unet_cfg)
    np.testing.assert_array_equal(unet["conv_in.weight"].numpy(), base["conv_in.weight"])
    temporal = next(k for k in own if "temp_convs" in k and k.endswith("weight"))
    np.testing.assert_array_equal(unet[temporal].numpy(), own[temporal])
    assert tm.unet.conv_in.weight.is_contiguous(memory_format=torch.channels_last)


def test_loaded_weights_take_the_model_dtype(ckpt_set):
    name, _, paths, _, _ = ckpt_set
    _, tp = _presets(name)
    fp32 = build_models(_with_paths(tp, paths), device="cpu", strict=True)
    bf16 = build_models(_with_paths(tp, paths), device="cpu", dtype=torch.bfloat16, strict=True)
    for module in ("unet", "vae", "text_encoder"):
        want = getattr(fp32, module).state_dict()
        for k, v in getattr(bf16, module).state_dict().items():
            assert v.dtype == torch.bfloat16 and torch.equal(v, want[k].bfloat16()), k


def _drop(paths, fname, d, tag, pred):
    """A copy of checkpoint ``fname`` without the keys ``pred`` selects."""
    sd = stn.load_file(paths[fname])
    gone = [k for k in sd if pred(k)]
    assert gone
    out = str(d / f"{tag}_{fname}")
    stn.save_file({k: v for k, v in sd.items() if k not in gone}, out)
    return out, gone


def test_strict_refuses_a_unet_file_without_a_temporal_key(ckpt_set):
    name, d, paths, _, _ = ckpt_set
    temporal = next(k for k in stn.load_file(paths["unet.safetensors"]) if "temp_attentions" in k)
    unet, _ = _drop(paths, "unet.safetensors", d, "no_temporal", lambda k: k == temporal)
    jp, tp = _presets(name)
    with pytest.raises(ValueError, match=re.escape(temporal)):
        build_models(_with_paths(tp, paths, unet=unet), device="cpu", strict=True)
    with pytest.raises(ValueError, match="unconsumed"):
        j_build(_with_paths(jp, paths, unet=unet), strict=True)


def test_strict_checks_the_union_of_unet_and_sd_base(ckpt_set):
    """A spatial key in neither the unet nor the sd_base file. The JAX
    loader passes this set: once an sd_base file exists it drops every
    spatial key from its missing list without asking whether the base file
    holds it (musev_tpu/pipelines/loader.py:157-166), so ``conv_in`` stays at
    its random init. The port refuses it."""
    name, d, paths, _, _ = ckpt_set
    unet, _ = _drop(paths, "unet.safetensors", d, "no_conv_in", lambda k: k.startswith("conv_in."))
    base, _ = _drop(paths, "sd_base.safetensors", d, "no_conv_in",
                    lambda k: k.startswith("conv_in."))
    jp, tp = _presets(name)
    j_build(_with_paths(jp, paths, unet=unet, sd_base=base), strict=True)  # passes
    with pytest.raises(ValueError, match=r"conv_in\.weight"):
        build_models(_with_paths(tp, paths, unet=unet, sd_base=base), device="cpu", strict=True)
    # either file alone supplying the key satisfies the union
    build_models(_with_paths(tp, paths, unet=unet), device="cpu", strict=True)


def test_missing_path_raises_under_strict_and_warns_otherwise(ckpt_set, caplog):
    name, d, paths, _, _ = ckpt_set
    _, tp = _presets(name)
    absent = str(d / "no_such_vae.safetensors")
    with pytest.raises(FileNotFoundError, match="vae_checkpoint"):
        build_models(_with_paths(tp, paths, vae=absent), device="cpu", strict=True)
    with caplog.at_level(logging.WARNING, logger=loader.__name__):
        build_models(_with_paths(tp, paths, vae=absent), device="cpu")
    assert "does not exist" in caplog.text


@pytest.mark.parametrize("field,value", [
    ("ip_adapter_face_checkpoint", "face.bin"),
    ("ip_adapter_model_name", "IPAdapterPlus"),
])
def test_unported_slots_raise_before_weights_are_drawn(caplog, field, value):
    """The two slots of the ReferenceNet preset that the port refused before
    it had their branches now build as the JAX loader builds them: a FaceID
    path alone (here a missing file, logged) turns nothing on, as the UNet's
    ``need_ip_adapter_face`` is off; "IPAdapterPlus" builds the Resampler
    of the JAX loader's config and shapes."""
    jp, tp = j_shrink(j_preset("musev_referencenet")), _shrink_preset(
        get_model_preset("musev_referencenet"))
    for preset in (jp, tp):
        setattr(preset, field, value)
    jm = j_build(jp, seed=3)
    with caplog.at_level(logging.WARNING, logger=loader.__name__):
        tm = build_models(tp, device="cpu")
    if field == "ip_adapter_face_checkpoint":
        assert jm.ip_face_proj_params is None and tm.ip_face_proj is None
        assert "ip_adapter_face_checkpoint" in caplog.text and "does not exist" in caplog.text
        want = convert.image_proj_from_jax(jm.ip_proj_params)
    else:
        assert jm.ip_proj_kind == "resampler"
        assert dataclasses.asdict(tm.ip_proj.cfg) == dataclasses.asdict(jm.ip_resampler_cfg)
        want = convert.resampler_from_jax(jm.ip_proj_params, jm.ip_resampler_cfg)
    got = tm.ip_proj.state_dict()
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}


def test_sd_base_as_ldm_checkpoint(tmp_path):
    """An original-LDM ``.ckpt`` (``state_dict``-wrapped) as sd_base, at the
    SD1.x two layers per block the LDM layout assumes: its UNet part
    overwrites the spatial sites, and with no explicit files its VAE (1x1
    conv attention kernels) and text encoder load too."""
    paths, _, donor2 = _write_set(tmp_path, "musev", layers_per_block=2)
    jp, _ = _presets("musev", layers_per_block=2)
    ldm = {"model.diffusion_model." + k: v for k, v in _diffusers_unet_to_ldm(
        _spatial(jsw.export_unet3d(donor2.unet_params, jp.unet_cfg))).items()}
    ldm.update({"first_stage_model." + k: v for k, v in _diffusers_vae_to_ldm(
        jsw.export_state_dict(jsw.vae_key_map(jp.vae_cfg), donor2.vae_params),
        len(jp.vae_cfg.block_out_channels)).items()})
    ldm.update({"cond_stage_model.transformer." + k: v for k, v in jsw.export_state_dict(
        jsw.clip_text_key_map(jp.text_cfg), donor2.text_params).items()})
    ckpt = tmp_path / "sd15.ckpt"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in _f32(ldm).items()}}, ckpt)
    paths = {"unet.safetensors": paths["unet.safetensors"], "sd_base.safetensors": str(ckpt)}
    jp, jm, tm = _port_and_jax("musev", paths, layers_per_block=2)
    _assert_equal(tm.unet, convert.unet3d_from_jax(jm.unet_params, jp.unet_cfg))
    _assert_equal(tm.vae, convert.vae_from_jax(donor2.vae_params, jp.vae_cfg))
    _assert_equal(tm.text_encoder, convert.clip_text_from_jax(donor2.text_params, jp.text_cfg))
    _assert_equal(tm.vae, convert.vae_from_jax(jm.vae_params, jp.vae_cfg))
    base = stn.load_file(paths["unet.safetensors"])
    assert not torch.equal(tm.unet.state_dict()["conv_in.weight"],
                           torch.from_numpy(base["conv_in.weight"]))


def _diffusers_unet_to_ldm(sd, layers_per_block=2):
    """diffusers UNet keys -> ``model.diffusion_model.*`` names (without the
    prefix), the inverse of ``ldm_convert.convert_ldm_unet_keys``."""
    per = layers_per_block + 1
    res = {"norm1.": "in_layers.0.", "conv1.": "in_layers.2.", "time_emb_proj.": "emb_layers.1.",
           "norm2.": "out_layers.0.", "conv2.": "out_layers.3.",
           "conv_shortcut.": "skip_connection."}

    def resnet(rest):
        for new, old in res.items():
            rest = rest.replace(new, old)
        return rest

    out = {}
    for k, v in sd.items():
        if m := re.match(r"time_embedding\.linear_([12])\.(.*)", k):
            nk = f"time_embed.{2 * int(m.group(1)) - 2}.{m.group(2)}"
        elif k.startswith("conv_in."):
            nk = "input_blocks.0.0." + k[len("conv_in."):]
        elif m := re.match(r"down_blocks\.(\d+)\.(resnets|attentions)\.(\d+)\.(.*)", k):
            i = 1 + int(m.group(1)) * per + int(m.group(3))
            nk = (f"input_blocks.{i}.0." + resnet(m.group(4)) if m.group(2) == "resnets"
                  else f"input_blocks.{i}.1." + m.group(4))
        elif m := re.match(r"down_blocks\.(\d+)\.downsamplers\.0\.conv\.(.*)", k):
            nk = f"input_blocks.{1 + int(m.group(1)) * per + layers_per_block}.0.op.{m.group(2)}"
        elif m := re.match(r"mid_block\.resnets\.([01])\.(.*)", k):
            nk = f"middle_block.{2 * int(m.group(1))}." + resnet(m.group(2))
        elif k.startswith("mid_block.attentions.0."):
            nk = "middle_block.1." + k[len("mid_block.attentions.0."):]
        elif m := re.match(r"up_blocks\.(\d+)\.(resnets|attentions)\.(\d+)\.(.*)", k):
            i = int(m.group(1)) * per + int(m.group(3))
            nk = (f"output_blocks.{i}.0." + resnet(m.group(4)) if m.group(2) == "resnets"
                  else f"output_blocks.{i}.1." + m.group(4))
        elif m := re.match(r"up_blocks\.(\d+)\.upsamplers\.0\.conv\.(.*)", k):
            nk = f"output_blocks.{int(m.group(1)) * per + per - 1}.2.conv.{m.group(2)}"
        elif k.startswith("conv_norm_out."):
            nk = "out.0." + k[len("conv_norm_out."):]
        elif k.startswith("conv_out."):
            nk = "out.2." + k[len("conv_out."):]
        else:
            raise KeyError(k)
        out[nk] = v
    return out


def _diffusers_vae_to_ldm(sd, n_blocks):
    """diffusers AutoencoderKL keys -> ``first_stage_model.*`` names (without
    the prefix); the mid-block attention linears become 1x1 conv kernels."""
    attn = {"group_norm.": "norm.", "to_q.": "q.", "to_k.": "k.", "to_v.": "v.",
            "to_out.0.": "proj_out."}
    out = {}
    for k, v in sd.items():
        k = k.replace("conv_shortcut.", "nin_shortcut.")
        if m := re.match(r"encoder\.down_blocks\.(\d+)\.resnets\.(\d+)\.(.*)", k):
            k = f"encoder.down.{m.group(1)}.block.{m.group(2)}.{m.group(3)}"
        elif m := re.match(r"encoder\.down_blocks\.(\d+)\.downsamplers\.0\.(.*)", k):
            k = f"encoder.down.{m.group(1)}.downsample.{m.group(2)}"
        elif m := re.match(r"decoder\.up_blocks\.(\d+)\.resnets\.(\d+)\.(.*)", k):
            k = f"decoder.up.{n_blocks - 1 - int(m.group(1))}.block.{m.group(2)}.{m.group(3)}"
        elif m := re.match(r"decoder\.up_blocks\.(\d+)\.upsamplers\.0\.(.*)", k):
            k = f"decoder.up.{n_blocks - 1 - int(m.group(1))}.upsample.{m.group(2)}"
        elif m := re.match(r"(encoder|decoder)\.mid_block\.resnets\.([01])\.(.*)", k):
            k = f"{m.group(1)}.mid.block_{int(m.group(2)) + 1}.{m.group(3)}"
        elif m := re.match(r"(encoder|decoder)\.mid_block\.attentions\.0\.(.*)", k):
            rest = m.group(2)
            for new, old in attn.items():
                if rest.startswith(new):
                    rest = old + rest[len(new):]
                    if new != "group_norm." and v.ndim == 2:
                        v = v[:, :, None, None]
            k = f"{m.group(1)}.mid.attn_1.{rest}"
        elif m := re.match(r"(encoder|decoder)\.conv_norm_out\.(.*)", k):
            k = f"{m.group(1)}.norm_out.{m.group(2)}"
        out[k] = v
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_safetensors_reader_equals_the_package(tmp_path, dtype):
    """F32 and F16 against ``safetensors.numpy.load_file``; BF16, which numpy
    cannot hold, against ``safetensors.torch.load_file``; both bit for bit."""
    gen = torch.Generator().manual_seed(0)
    tensors = {"w": torch.randn(3, 5, 2, generator=gen).to(dtype),
               "b": torch.randn(7, generator=gen).to(dtype),
               "s": torch.randn((), generator=gen).to(dtype),
               "e": torch.zeros(0, 4, dtype=dtype),
               "i": torch.arange(6, dtype=torch.int64)}
    path = str(tmp_path / "t.safetensors")
    stt.save_file(tensors, path, metadata={"format": "pt"})
    got = sd_weights.load_safetensors(path)
    if dtype == torch.bfloat16:
        want = stt.load_file(path)
    else:
        want = {k: torch.from_numpy(v) for k, v in stn.load_file(path).items()}
    assert set(got) == set(want) == set(tensors)
    for k in tensors:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def test_a_tokenizer_path_that_fails_to_load_raises(monkeypatch):
    """A given tokenizer path must load or raise, never fall back to hashing."""
    from musev_torch.utils import tokenizer

    class Unloadable:
        def __init__(self, path):
            raise OSError(f"no vocabulary files in {path}")

    monkeypatch.setattr(tokenizer, "HFCLIPTokenizer", Unloadable)
    assert isinstance(tokenizer.get_tokenizer(None, 1000), tokenizer.HashTokenizer)
    preset = _shrink_preset(get_model_preset("musev", tokenizer_path="clip-vocab"))
    with pytest.raises(ValueError, match="clip-vocab"):
        build_models(preset, device="cpu")
