"""The rest of the port's ``musev_referencenet`` preset against the JAX package.

The FaceID ``MLPProjModel``, CLIP vision's penultimate tokens and the
IP-Adapter-Plus ``Resampler``, the UNet's FaceID branch, the ReferenceNet's
self-attention embeddings (written by the ReferenceNet, read by the UNet
through ``denoise_loop``), image-to-video through the Resampler with a face
embedding and the image tokens as the text, and the loader reading Plus and
FaceID files. Both sides get the same weights: the JAX ``init_*`` trees with
every leaf redrawn as init + N(0, 0.05), carried by
``musev_torch.models.convert``. Inputs come from a seeded numpy RNG; the
pipelines' ``make_noise`` is replaced by the same seeded draws on both
sides. float32 on the CPU. Tolerances, relative L2: one module or network
1e-5 (float32 rounding in another summation order), two Euler steps 1e-4;
loading is a copy (exact).
"""

import contextlib
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy as stn
import torch

import musev_torch.pipelines.pipeline as tpipe
import musev_tpu.pipelines.pipeline as jpipe
from musev_tpu.cli.text2video import _shrink_preset as j_shrink
from musev_tpu.configs.model_registry import get_model_preset as j_preset
from musev_tpu.models import sd_weights as jsw
from musev_tpu.models import unet_blocks as jblk
from musev_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from musev_tpu.models.clip_text import init_clip_text
from musev_tpu.models.clip_vision import CLIPVisionConfig as JVisionConfig
from musev_tpu.models.clip_vision import clip_vision_encode as j_clip_vision_encode
from musev_tpu.models.clip_vision import init_clip_vision
from musev_tpu.models.ip_adapter import ResamplerConfig as JResamplerConfig
from musev_tpu.models.ip_adapter import init_mlp_proj, init_resampler
from musev_tpu.models.ip_adapter import mlp_proj as j_mlp_proj
from musev_tpu.models.ip_adapter import resampler as j_resampler
from musev_tpu.models.referencenet import ReferenceNetConfig as JRefConfig
from musev_tpu.models.referencenet import init_referencenet
from musev_tpu.models.referencenet import referencenet_apply as j_referencenet_apply
from musev_tpu.models.unet3d import init_unet3d
from musev_tpu.models.unet3d import musev_referencenet_config as j_refnet_config
from musev_tpu.models.vae import VAEConfig as JVAEConfig
from musev_tpu.models.vae import init_vae
from musev_tpu.ops.context import make_window_plan as j_plan
from musev_tpu.pipelines import denoiser as jden
from musev_tpu.pipelines.loader import build_models as j_build
from musev_tpu.schedulers.euler_discrete import EulerDiscreteScheduler as JEuler
from musev_tpu.utils.tokenizer import HashTokenizer as JHashTokenizer
from musev_torch.cli.text2video import _shrink_preset, enable_face
from musev_torch.configs.model_registry import get_model_preset
from musev_torch.models import convert, sd_weights
from musev_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from musev_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionModel, clip_vision_encode
from musev_torch.models.ip_adapter import MLPProjModel, Resampler, ResamplerConfig
from musev_torch.models.referencenet import ReferenceNet2D, ReferenceNetConfig, referencenet_apply
from musev_torch.models.unet3d import UNet3D, musev_referencenet_config, unet3d_apply
from musev_torch.models.vae import AutoencoderKL, VAEConfig
from musev_torch.ops.context import make_window_plan
from musev_torch.pipelines import denoiser
from musev_torch.pipelines.loader import build_models
from musev_torch.schedulers.euler_discrete import EulerDiscreteScheduler
from musev_torch.utils.tokenizer import HashTokenizer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: torch's OpenMP pool spun
    against the suite's other xdist workers. Restored after, as the setting
    is the process's and JAX shares it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FACE = dict(need_ip_adapter_face=True, ip_adapter_face_dim=20)
TINY_UNET = dict(block_out_channels=(16, 16, 32, 32), layers_per_block=1,
                 cross_attention_dim=24, attention_heads=4, norm_num_groups=8,
                 ip_adapter_dim=24, **FACE)
TINY_REF = dict(block_out_channels=(16, 16, 32, 32), layers_per_block=1,
                cross_attention_dim=24, attention_heads=4, norm_num_groups=8,
                need_self_attn_embs=True)
TINY_VISION = dict(image_size=28, patch_size=14, hidden_size=32, num_layers=2, num_heads=4,
                   intermediate_size=64, projection_dim=16)
# the loader's Resampler for the tiny UNet: 12 heads as 24 divides by 12
TINY_RESAMPLER = dict(dim=24, depth=4, heads=12, num_queries=16, embedding_dim=32,
                      output_dim=24)
TINY_VAE = dict(block_out_channels=(16, 16, 32, 32), layers_per_block=1, norm_num_groups=8)
TINY_CLIP = dict(vocab_size=1000, hidden_size=24, num_layers=2, num_heads=4,
                 intermediate_size=48)
ID_DIM, FACE_TOKENS = 40, 4
MODULE_REL_L2 = 1e-5
LOOP_REL_L2 = 1e-4
N_SITES = 10  # spatial transformer sites of the tiny configs: 3 down, 1 mid, 6 up


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _redraw(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a), dtype=np.float32),
        params,
    )


def _port(module, state):
    module.load_state_dict(state, strict=True)
    return module.eval()


@pytest.fixture(scope="module")
def nets():
    k = jax.random.PRNGKey(13)
    rcfg = JResamplerConfig(**TINY_RESAMPLER)
    j = dict(
        unet=_redraw(init_unet3d(jax.random.fold_in(k, 0), j_refnet_config(**TINY_UNET)), 0),
        ref=_redraw(init_referencenet(jax.random.fold_in(k, 1), JRefConfig(**TINY_REF)), 1),
        vision=_redraw(init_clip_vision(jax.random.fold_in(k, 2), JVisionConfig(**TINY_VISION)),
                       2),
        resampler=_redraw(init_resampler(jax.random.fold_in(k, 3), rcfg), 3),
        face=_redraw(init_mlp_proj(jax.random.fold_in(k, 4), ID_DIM, 20, FACE_TOKENS), 4),
    )
    ucfg, refcfg = musev_referencenet_config(**TINY_UNET), ReferenceNetConfig(**TINY_REF)
    vcfg, tcfg = CLIPVisionConfig(**TINY_VISION), ResamplerConfig(**TINY_RESAMPLER)
    port = dict(
        unet=_port(UNet3D(ucfg), convert.unet3d_from_jax(j["unet"], ucfg)),
        ref=_port(ReferenceNet2D(refcfg), convert.referencenet_from_jax(j["ref"], refcfg)),
        vision=_port(CLIPVisionModel(vcfg), convert.clip_vision_from_jax(j["vision"], vcfg)),
        resampler=_port(Resampler(tcfg), convert.resampler_from_jax(j["resampler"], tcfg)),
        face=_port(MLPProjModel(ID_DIM, 20, FACE_TOKENS), convert.mlp_proj_from_jax(j["face"])),
    )
    return j, port


def test_mlp_proj_matches_jax(nets):
    j, port = nets
    emb = _rand(1, 3, ID_DIM)
    want = j_mlp_proj(j["face"], jnp.asarray(emb))
    with torch.no_grad():
        got = port["face"](_t(emb))
    assert got.shape == want.shape == (3, FACE_TOKENS, 20)
    assert _rel_l2(got.numpy(), want) <= MODULE_REL_L2
    # exact GELU: the tanh form would move it by far more
    fc1 = port["face"].proj[0]
    h = fc1(_t(emb))
    assert (torch.nn.functional.gelu(h) - torch.nn.functional.gelu(h, approximate="tanh")
            ).abs().max() > 10 * MODULE_REL_L2


def test_penultimate_tokens_and_resampler_match_jax(nets):
    """CLIP's penultimate hidden states through the Resampler: 5 + 16 keys,
    12 heads of width 2; its feed-forward takes tanh GELU, as the JAX one."""
    j, port = nets
    pixels = _rand(2, 2, 28, 28, 3)
    want_tokens, want_pooled = j_clip_vision_encode(j["vision"], JVisionConfig(**TINY_VISION),
                                                    jnp.asarray(pixels), penultimate=True)
    last, _ = j_clip_vision_encode(j["vision"], JVisionConfig(**TINY_VISION),
                                   jnp.asarray(pixels))
    want = j_resampler(j["resampler"], JResamplerConfig(**TINY_RESAMPLER), want_tokens)
    with torch.no_grad():
        tokens, pooled = clip_vision_encode(port["vision"], _t(pixels), penultimate=True)
        got = port["resampler"](tokens)
    assert tokens.shape == want_tokens.shape == (2, 5, 32)
    assert _rel_l2(tokens.numpy(), want_tokens) <= MODULE_REL_L2
    assert _rel_l2(pooled.numpy(), want_pooled) <= MODULE_REL_L2
    assert _rel_l2(tokens.numpy(), last) > 1e-2  # not the last layer's
    assert got.shape == want.shape == (2, 16, 24)
    assert _rel_l2(got.numpy(), want) <= MODULE_REL_L2


def test_faceid_branch_matches_jax(nets):
    """One attn2 module with its text, IP and FaceID branches (the UNet
    with face tokens is held against the JAX package through
    ``denoise_loop`` below); dropping the face tokens moves the UNet's
    output."""
    j, port = nets
    x, text, clip, face = _rand(11, 3, 16, 16), _rand(12, 3, 7, 24), _rand(13, 3, 16, 24), \
        _rand(14, 3, FACE_TOKENS, 20)
    p = j["unet"]["down_blocks"][0]["layers"][0]["attn"]["block"]["attn2"]
    want = jblk.attention(p, jnp.asarray(x), jnp.asarray(text), heads=4,
                          ip_context=jnp.asarray(clip), ip_scale=0.8,
                          ip_face_context=jnp.asarray(face), ip_face_scale=0.6)
    attn2 = port["unet"].down_blocks[0].attentions[0].transformer_blocks[0].attn2
    with torch.no_grad():
        got = attn2(_t(x), _t(text), ip_context=_t(clip), ip_scale=0.8,
                    ip_face_context=_t(face), ip_face_scale=0.6)
    assert _rel_l2(got.numpy(), want) <= MODULE_REL_L2

    sample, cond = _rand(6, 2, 3, 8, 8, 4), _rand(7, 2, 1, 8, 8, 4)
    kw = dict(condition_latents=_t(cond), gen_index=(1, 2, 3), cond_index=(0,), do_cfg=True,
              vision_clip_emb=_t(_rand(9, 2, 16, 24)))
    with torch.no_grad():
        got = unet3d_apply(port["unet"], _t(sample), 641.0, _t(_rand(8, 2, 7, 24)),
                           ip_adapter_face_emb=_t(_rand(10, 2, FACE_TOKENS, 20)), **kw)
        cut = unet3d_apply(port["unet"], _t(sample), 641.0, _t(_rand(8, 2, 7, 24)), **kw)
    assert _rel_l2(cut.numpy(), got.numpy()) > 1e-3


@pytest.fixture(scope="module")
def self_attn_embs(nets):
    """The ReferenceNet's write mode on both sides: (JAX list, port list)."""
    j, port = nets
    latent, ctx = _rand(20, 1, 8, 8, 4), _rand(21, 1, 16, 24)
    _, _, want = j_referencenet_apply(j["ref"], JRefConfig(**TINY_REF), jnp.asarray(latent), 0.0,
                                      jnp.asarray(ctx))
    got = []
    with torch.no_grad():
        referencenet_apply(port["ref"], _t(latent), 0.0, _t(ctx), self_attn_embs=got)
    return want, got


def test_referencenet_self_attn_embs_match_jax(self_attn_embs):
    """Write mode: the normalised self-attention input of every spatial
    site, down, mid and up (the JAX list has 16 slots, the tiny net fills
    10)."""
    want, got = self_attn_embs
    assert len(got) == N_SITES and all(w is None for w in want[N_SITES:])
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel_l2(g.numpy(), w) <= MODULE_REL_L2
    assert [g.shape[1] for g in got] == [64, 16, 4, 1, 4, 4, 16, 16, 64, 64]


def test_denoise_loop_with_plus_face_and_self_attn_embs_matches_jax(nets, self_attn_embs):
    """2 Euler steps, 6 frames in 2 windows of 4 overlapping by 2, one vision
    condition frame, CFG, with the Resampler's [uncond; cond] tokens, the
    FaceID tokens and the ReferenceNet's self-attention embeddings read at
    every spatial site as extra ReferenceOnly keys; dropping the embeddings
    moves the latents."""
    j, port = nets
    rng = np.random.default_rng(0)
    latents = rng.standard_normal((1, 6, 8, 8, 4), dtype=np.float32) * 14.6
    cond = rng.standard_normal((1, 1, 8, 8, 4), dtype=np.float32)
    text_c, text_uc = (rng.standard_normal((1, 7, 24), dtype=np.float32) for _ in range(2))
    clip = rng.standard_normal((2, 16, 24), dtype=np.float32)
    face = rng.standard_normal((2, FACE_TOKENS, 20), dtype=np.float32)
    want_embs, embs = self_attn_embs
    kw = dict(guidance=np.full((2,), 3.5, np.float32), n_vision_cond=1, ip_adapter_scale=0.8,
              ip_adapter_face_scale=0.6)
    jspec = jden.DenoiseSpec(unet_cfg=j_refnet_config(**TINY_UNET), scheduler=JEuler.create(2),
                             plan=j_plan(6, 4, 2), **kw)
    want = jax.jit(jden.denoise_loop, static_argnames=("spec",))(
        j["unet"], jspec, jnp.asarray(latents), jnp.asarray(text_uc), jnp.asarray(text_c),
        jax.random.PRNGKey(0), condition_latents=jnp.asarray(cond),
        vision_clip_emb=jnp.asarray(clip), ip_adapter_face_emb=jnp.asarray(face),
        refer_self_attn_embs=list(want_embs))
    spec = denoiser.DenoiseSpec(unet_cfg=port["unet"].cfg,
                                scheduler=EulerDiscreteScheduler.create(2),
                                plan=make_window_plan(6, 4, 2), **kw)
    args = (port["unet"], spec, _t(latents), _t(text_uc), _t(text_c))
    inputs = dict(condition_latents=_t(cond), vision_clip_emb=_t(clip),
                  ip_adapter_face_emb=_t(face))
    with torch.no_grad():
        got = denoiser.denoise_loop(*args, refer_self_attn_embs=embs, **inputs)
        cut = denoiser.denoise_loop(*args, **inputs)
    assert _rel_l2(got.numpy(), want) <= LOOP_REL_L2
    assert _rel_l2(cut.numpy(), got.numpy()) > 1e-3


@contextlib.contextmanager
def _same_noise(seed):
    """Both pipelines' ``make_noise`` draw, call by call, the same seeded
    N(0, 1) arrays (``jax.random`` and ``torch.Generator`` differ)."""
    rng = np.random.default_rng(seed)
    draws, calls = [], {"jax": 0, "torch": 0}

    def draw(side, shape):
        i = calls[side]
        calls[side] += 1
        if i == len(draws):
            draws.append(rng.standard_normal(tuple(shape), dtype=np.float32))
        assert draws[i].shape == tuple(shape), (side, i, shape)
        return draws[i]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe, "make_noise", lambda key, shape, **kw: jnp.asarray(draw("jax", shape)))
        mp.setattr(tpipe, "make_noise",
                   lambda gen, shape, device=None, **kw: _t(draw("torch", shape)).to(device))
        yield calls


def test_text2video_plus_faceid_image_prompt_matches_jax(nets):
    """Image-to-video from one condition image through the ReferenceNet and
    the Resampler's 16 tokens, with a face embedding at FaceID scale 0.6 and
    the image tokens as the text (``prompt_only_use_image_prompt``): 3
    frames in one window, 2 Euler steps. Zeroing the face embedding, or
    keeping the text, moves the port's latents; a preset without FaceID
    takes ``face_emb`` and ignores it, as the JAX pipeline does."""
    j, port = nets
    kv = jax.random.PRNGKey(17)
    jvae = init_vae(jax.random.fold_in(kv, 0), JVAEConfig(**TINY_VAE))
    jtext = init_clip_text(jax.random.fold_in(kv, 1), JCLIPConfig(**TINY_CLIP))
    jmodels = jpipe.MusevModels(
        unet_params=j["unet"], unet_cfg=j_refnet_config(**TINY_UNET), vae_params=jvae,
        vae_cfg=JVAEConfig(**TINY_VAE), text_params=jtext, text_cfg=JCLIPConfig(**TINY_CLIP),
        tokenizer=JHashTokenizer(vocab_size=1000), referencenet_params=j["ref"],
        referencenet_cfg=JRefConfig(**TINY_REF), clip_vision_params=j["vision"],
        clip_vision_cfg=JVisionConfig(**TINY_VISION), ip_proj_params=j["resampler"],
        ip_proj_kind="resampler", ip_resampler_cfg=JResamplerConfig(**TINY_RESAMPLER),
        ip_face_proj_params=j["face"],
    )
    models = tpipe.MusevModels(
        unet=port["unet"],
        vae=_port(AutoencoderKL(VAEConfig(**TINY_VAE)),
                  convert.vae_from_jax(jvae, VAEConfig(**TINY_VAE))),
        text_encoder=_port(CLIPTextModel(CLIPTextConfig(**TINY_CLIP)),
                           convert.clip_text_from_jax(jtext, CLIPTextConfig(**TINY_CLIP))),
        tokenizer=HashTokenizer(vocab_size=1000), referencenet=port["ref"],
        clip_vision=port["vision"], ip_proj=port["resampler"], ip_face_proj=port["face"],
    )
    rng = np.random.default_rng(18)
    image = rng.uniform(0, 255, (1, 1, 32, 32, 3)).astype(np.float32)
    face_emb = rng.standard_normal((1, ID_DIM)).astype(np.float32)
    kw = dict(height=32, width=32, video_length=3, condition_images=image,
              video_num_inference_steps=2, context_frames=3, context_overlap=1, seed=5,
              face_emb=face_emb, ip_adapter_face_scale=0.6, prompt_only_use_image_prompt=True)
    pipe = tpipe.MusevPipeline(models)
    with _same_noise(19):
        want = jpipe.MusevPipeline(jmodels).text2video("a cat", **kw)
        got = pipe.text2video("a cat", **kw)
    assert got.latents.shape == want.latents.shape == (1, 4, 4, 4, 4)
    assert _rel_l2(got.latents, want.latents) <= LOOP_REL_L2
    for change in (dict(face_emb=np.zeros_like(face_emb)),
                   dict(prompt_only_use_image_prompt=False)):
        with _same_noise(19):
            moved = pipe.text2video("a cat", **dict(kw, **change))
        assert _rel_l2(moved.latents, got.latents) > 1e-3, change
    no_face = dataclasses.replace(models, ip_face_proj=None)
    with _same_noise(19):
        inert = tpipe.MusevPipeline(no_face).text2video("a cat", **kw)
    with _same_noise(19):
        plain = tpipe.MusevPipeline(no_face).text2video(
            "a cat", **dict(kw, face_emb=None, ip_adapter_face_scale=1.0))
    np.testing.assert_array_equal(inert.latents, plain.latents)


def _presets(**unet):
    """The tiny IPAdapterPlus preset with FaceID in both packages."""
    over = dict(ip_adapter_model_name="IPAdapterPlus", ip_adapter_tokens=16,
                ip_adapter_face_id_dim=ID_DIM)
    jp = j_shrink(j_preset("musev_referencenet", **over))
    tp = _shrink_preset(get_model_preset("musev_referencenet", **over))
    for p in (jp, tp):
        p.unet_cfg = dataclasses.replace(p.unet_cfg, **FACE, **unet)
    return jp, tp


@pytest.fixture(scope="module")
def plus_files(tmp_path_factory):
    """A unet file without the IP and face projections, a Plus file (the
    Resampler's "image_proj" and numbered ``to_k_ip``/``to_v_ip``) and a
    FaceID file (the MLPProjModel's "image_proj" and numbered pairs for the
    face slots), written from a JAX donor's params in the published files'
    layouts by the port's key maps."""
    d = tmp_path_factory.mktemp("plus")
    jp, _ = _presets()
    donor = j_build(jp, seed=7)
    unet = jsw.export_unet3d(donor.unet_params, jp.unet_cfg)
    paths = dict(unet=str(d / "unet.safetensors"), ip_adapter=str(d / "plus.bin"),
                 ip_adapter_face=str(d / "faceid.bin"))
    stn.save_file({k: np.ascontiguousarray(v, np.float32) for k, v in unet.items()
                   if not k.endswith(("to_k_ip.weight", "to_v_ip.weight"))}, paths["unet"])
    sites = jsw.ip_adapter_site_paths(jp.unet_cfg)
    for slot, proj, names in (
            ("ip_adapter", convert.resampler_from_jax(donor.ip_proj_params,
                                                      donor.ip_resampler_cfg),
             ("to_k_ip", "to_v_ip")),
            ("ip_adapter_face", convert.mlp_proj_from_jax(donor.ip_face_proj_params),
             ("to_k_ip_face", "to_v_ip_face"))):
        numbered = {}
        for i, site in enumerate(sites):
            node = donor.unet_params
            for key in site:
                node = node[key]
            for name, ref in zip(names, ("to_k_ip", "to_v_ip")):
                numbered[f"{2 * i + 1}.{ref}.weight"] = _t(np.asarray(node[name]["kernel"]).T)
        torch.save({"image_proj": proj, "ip_adapter": numbered}, paths[slot])
    return d, paths, donor


def _with_paths(preset, paths, **replace):
    for slot, path in paths.items():
        setattr(preset, f"{slot}_checkpoint", replace.get(slot, path))
    return preset


def test_loader_reads_plus_and_faceid_files_like_jax(plus_files):
    """Both loaders read the same files with ``strict=True``: the port's
    Resampler, MLPProjModel and UNet (IP and face slots from their files)
    equal the JAX loader's params exactly, and the donor's."""
    _, paths, donor = plus_files
    jp, tp = _presets()
    jm = j_build(_with_paths(jp, paths), seed=3, strict=True)
    tm = build_models(_with_paths(tp, paths), device="cpu", seed=5, strict=True)
    assert isinstance(tm.ip_proj, Resampler) and tm.ip_proj.cfg == ResamplerConfig(
        **dataclasses.asdict(jm.ip_resampler_cfg))
    for module, want in (
            (tm.ip_proj, convert.resampler_from_jax(jm.ip_proj_params, jm.ip_resampler_cfg)),
            (tm.ip_face_proj, convert.mlp_proj_from_jax(jm.ip_face_proj_params)),
            (tm.unet, convert.unet3d_from_jax(jm.unet_params, jp.unet_cfg)),
            (tm.unet, convert.unet3d_from_jax(donor.unet_params, jp.unet_cfg))):
        got = module.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k
    assert any("ip_adapter_face_to_k_ip" in k for k in tm.unet.state_dict())


def test_strict_refuses_a_faceid_file_without_a_face_key(plus_files):
    d, paths, _ = plus_files
    face = torch.load(paths["ip_adapter_face"], weights_only=True)
    del face["ip_adapter"]["1.to_v_ip.weight"]
    short = str(d / "faceid_short.bin")
    torch.save(face, short)
    _, tp = _presets()
    site = r"down_blocks\.0\.attentions\.0\..*ip_adapter_face_to_v_ip"
    with pytest.raises(ValueError, match=site):
        build_models(_with_paths(tp, paths, ip_adapter_face=short), device="cpu", strict=True)
    build_models(_with_paths(tp, paths, ip_adapter_face=short), device="cpu")  # not strict


def test_face_checkpoint_turns_on_faceid_and_full_width_keys_match_jax():
    """``enable_face`` (the CLI's ``--ip_adapter_face_checkpoint``) turns on
    the branch; the full-width FaceID UNet (meta device) carries the JAX
    key map's keys, the face slots under ``ip_adapter_face_to_k_ip``."""
    preset = get_model_preset("musev_referencenet")
    enable_face(preset, "faceid.bin")
    assert preset.unet_cfg.need_ip_adapter_face
    with torch.device("meta"):
        keys = set(UNet3D(preset.unet_cfg).state_dict())
    jcfg = j_refnet_config(need_ip_adapter_face=True)
    tree = jax.eval_shape(partial(init_unet3d, jax.random.PRNGKey(0), jcfg))
    assert keys == set(jsw.export_key_names(list(jsw.unet3d_key_map(jcfg)), tree))
    assert sum("ip_adapter_face_to_k_ip" in k for k in keys) == len(
        sd_weights.ip_adapter_site_paths(preset.unet_cfg)) == 16
