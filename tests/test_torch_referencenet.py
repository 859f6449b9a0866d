"""The port's ``musev_referencenet`` slice against the JAX package.

ReferenceNet, CLIP vision, the IP-Adapter ImageProjModel, the ReferenceNet
fuse, the referencenet UNet, the denoise engine with those inputs and the
image-to-video pipeline. Both sides get the same weights: the JAX package's
``init_*`` trees with every leaf redrawn as init + N(0, 0.05), so the
zero-initialised fuse ``to_out`` is not zero and the fuse and IP branches
show in the output; ``musev_torch.models.convert`` carries them over. Inputs
come from a seeded numpy RNG; everything runs in float32 on the CPU.
Tolerances: one module 1e-5 (float32 rounding in another summation order),
a whole network 1e-4 (differences compound through its layers), two Euler
steps 1e-3 (amplified by the CFG scale and sigma_max ~ 14.6).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musev_tpu.models import sd_weights as jsw
from musev_tpu.models import unet_blocks as jblk
from musev_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from musev_tpu.models.clip_text import init_clip_text
from musev_tpu.models.clip_vision import CLIPVisionConfig as JVisionConfig
from musev_tpu.models.clip_vision import clip_vision_encode as j_clip_vision_encode
from musev_tpu.models.clip_vision import init_clip_vision
from musev_tpu.models.clip_vision import preprocess_clip_image as j_preprocess
from musev_tpu.models.ip_adapter import image_proj as j_image_proj
from musev_tpu.models.ip_adapter import init_image_proj
from musev_tpu.models.referencenet import ReferenceNetConfig as JRefConfig
from musev_tpu.models.referencenet import init_referencenet
from musev_tpu.models.referencenet import referencenet_apply as j_referencenet_apply
from musev_tpu.models.unet3d import init_unet3d
from musev_tpu.models.unet3d import musev_referencenet_config as j_refnet_config
from musev_tpu.models.unet3d import unet3d_apply as j_unet3d_apply
from musev_tpu.models.vae import VAEConfig as JVAEConfig
from musev_tpu.models.vae import init_vae
from musev_tpu.ops.context import make_window_plan as j_plan
from musev_tpu.pipelines import denoiser as jden
from musev_tpu.pipelines.pipeline import MusevModels as JModels
from musev_tpu.pipelines.pipeline import MusevPipeline as JPipeline
from musev_tpu.schedulers.euler_discrete import EulerDiscreteScheduler as JEuler
from musev_tpu.utils.tokenizer import HashTokenizer as JHashTokenizer
from musev_torch.models import convert, sd_weights
from musev_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from musev_torch.models.clip_vision import (
    CLIPVisionConfig,
    CLIPVisionModel,
    clip_vision_encode,
    preprocess_clip_image,
)
from musev_torch.models.ip_adapter import ImageProjModel
from musev_torch.models.referencenet import ReferenceNet2D, ReferenceNetConfig, referencenet_apply
from musev_torch.models.unet3d import UNet3D, musev_referencenet_config, unet3d_apply
from musev_torch.models.unet_blocks import ReferEmbFuse
from musev_torch.models.vae import AutoencoderKL, VAEConfig
from musev_torch.ops.context import make_window_plan
from musev_torch.pipelines import denoiser
from musev_torch.pipelines.pipeline import MusevModels, MusevPipeline
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


TINY_UNET = dict(block_out_channels=(16, 16, 32, 32), layers_per_block=1,
                 cross_attention_dim=24, attention_heads=4, norm_num_groups=8,
                 ip_adapter_dim=24)
TINY_REF = dict(block_out_channels=(16, 16, 32, 32), layers_per_block=1,
                cross_attention_dim=24, attention_heads=4, norm_num_groups=8)
TINY_VISION = dict(image_size=28, patch_size=14, hidden_size=32, num_layers=2, num_heads=4,
                   intermediate_size=64, projection_dim=16)
TINY_VAE = dict(block_out_channels=(16, 16, 32, 32), layers_per_block=1, norm_num_groups=8)
TINY_CLIP = dict(vocab_size=1000, hidden_size=24, num_layers=2, num_heads=4,
                 intermediate_size=48)
MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
NET_TOL = dict(rtol=1e-4, atol=1e-4)
LOOP_TOL = dict(rtol=1e-3, atol=1e-3)
N_FUSE = 8  # ReferenceNet down embeddings of the tiny config: conv_in + 7 down sites


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


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
    k = jax.random.PRNGKey(7)
    j = dict(
        unet=_redraw(init_unet3d(jax.random.fold_in(k, 0), j_refnet_config(**TINY_UNET)), 0),
        ref=_redraw(init_referencenet(jax.random.fold_in(k, 1), JRefConfig(**TINY_REF)), 1),
        vision=_redraw(init_clip_vision(jax.random.fold_in(k, 2), JVisionConfig(**TINY_VISION)),
                       2),
        proj=_redraw(init_image_proj(jax.random.fold_in(k, 3), 16, 24, 4), 3),
    )
    ucfg, vcfg = musev_referencenet_config(**TINY_UNET), CLIPVisionConfig(**TINY_VISION)
    port = dict(
        unet=_port(UNet3D(ucfg), convert.unet3d_from_jax(j["unet"], ucfg)),
        ref=_port(ReferenceNet2D(ReferenceNetConfig(**TINY_REF)),
                  convert.referencenet_from_jax(j["ref"], ReferenceNetConfig(**TINY_REF))),
        vision=_port(CLIPVisionModel(vcfg), convert.clip_vision_from_jax(j["vision"], vcfg)),
        proj=_port(ImageProjModel(16, 24, 4), convert.image_proj_from_jax(j["proj"])),
    )
    return j, port


def test_referencenet_matches_jax(nets):
    j, port = nets
    sample, ctx = _rand(1, 2, 8, 8, 4), _rand(2, 2, 5, 24)
    want_down, want_mid, _ = j_referencenet_apply(j["ref"], JRefConfig(**TINY_REF),
                                                  jnp.asarray(sample), 0.0, jnp.asarray(ctx))
    with torch.no_grad():
        down, mid = referencenet_apply(port["ref"], _t(sample), 0.0, _t(ctx))
    assert len(down) == len(want_down) == N_FUSE
    for got, want in zip(down + [mid], list(want_down) + [want_mid]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **NET_TOL)


def test_clip_vision_and_image_proj_match_jax(nets):
    j, port = nets
    jcfg = JVisionConfig(**TINY_VISION)
    images = np.random.default_rng(3).uniform(0, 255, (2, 40, 36, 3)).astype(np.float32)
    want_pix = np.asarray(j_preprocess(jnp.asarray(images), jcfg.image_size))
    pixels = preprocess_clip_image(_t(images), jcfg.image_size)
    np.testing.assert_allclose(pixels.numpy(), want_pix, **MODULE_TOL)
    want_hidden, want_pooled = j_clip_vision_encode(j["vision"], jcfg, jnp.asarray(want_pix))
    with torch.no_grad():
        hidden, pooled = clip_vision_encode(port["vision"], _t(want_pix))
        tokens = port["proj"](pooled)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(want_hidden), **NET_TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled), **NET_TOL)
    want_tokens = j_image_proj(j["proj"], want_pooled)
    assert tokens.shape == (2, 4, 24)
    np.testing.assert_allclose(tokens.numpy(), np.asarray(want_tokens), **NET_TOL)


def test_refer_emb_fuse_matches_jax(nets):
    j, port = nets
    x, refer = _rand(4, 2 * 3, 4, 4, 16), _rand(5, 2, 1, 4, 4, 16)
    p = j["unet"]["down_blocks"][0]["refer_emb_attns"][0]
    want = jblk.refer_emb_fuse(p, jnp.asarray(x), jnp.asarray(refer), num_frames=3, heads=4)
    mod = port["unet"].down_blocks[0].refer_emb_attns[0]
    assert isinstance(mod, ReferEmbFuse)
    with torch.no_grad():
        got = mod(_t(x), _t(refer), num_frames=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)


def _unet_inputs():
    sample, cond = _rand(6, 2, 3, 8, 8, 4), _rand(7, 2, 1, 8, 8, 4)
    text, clip = _rand(8, 2, 7, 24), _rand(9, 2, 4, 24)
    sizes = [(8, 16), (8, 16), (4, 16), (4, 16), (2, 16), (2, 32), (1, 32), (1, 32)]
    refer = [_rand(10 + i, 2, 1, s, s, c) for i, (s, c) in enumerate(sizes)]
    return sample, cond, text, clip, refer, _rand(20, 2, 1, 1, 1, 32)


def _port_unet(unet, sample, cond, text, clip, refer, mid, scale=0.7):
    with torch.no_grad():
        return unet3d_apply(
            unet, _t(sample), 641.0, _t(text), condition_latents=_t(cond),
            gen_index=(1, 2, 3), cond_index=(0,), do_cfg=True,
            down_block_refer_embs=None if refer is None else [_t(e) for e in refer],
            mid_block_refer_emb=None if mid is None else _t(mid),
            vision_clip_emb=None if clip is None else _t(clip), ip_adapter_scale=scale,
        ).numpy()


@jax.jit
def _jax_unet(params, sample, text, cond, clip, refer, mid):
    return j_unet3d_apply(
        params, j_refnet_config(**TINY_UNET), sample, jnp.asarray(641.0), text,
        condition_latents=cond, gen_index=(1, 2, 3), cond_index=(0,), do_cfg=True,
        down_block_refer_embs=refer, mid_block_refer_emb=mid, vision_clip_emb=clip,
        ip_adapter_scale=0.7,
    )


def test_referencenet_unet3d_matches_jax(nets):
    j, port = nets
    sample, cond, text, clip, refer, mid = _unet_inputs()
    want = _jax_unet(j["unet"], sample, text, cond, clip, refer, mid)
    got = _port_unet(port["unet"], sample, cond, text, clip, refer, mid)
    np.testing.assert_allclose(got, np.asarray(want), **NET_TOL)


@pytest.mark.parametrize("drop", ["refer", "mid", "ip"])
def test_fuse_and_ip_branches_change_the_output(nets, drop):
    """Dropping either branch moves the UNet output by far more than NET_TOL,
    so the parity test above would catch a port that skipped it."""
    _, port = nets
    sample, cond, text, clip, refer, mid = _unet_inputs()
    full = _port_unet(port["unet"], sample, cond, text, clip, refer, mid)
    args = dict(refer=refer, mid=mid, clip=clip)
    args[{"refer": "refer", "mid": "mid", "ip": "clip"}[drop]] = None
    cut = _port_unet(port["unet"], sample, cond, text, **args)
    assert np.abs(full - cut).max() > 100 * NET_TOL["atol"]


def test_denoise_loop_with_reference_inputs_matches_jax(nets):
    """2 Euler steps, 6 frames in 2 windows of 4 overlapping by 2, one vision
    condition frame, CFG, ReferenceNet embeddings and [uncond; cond] IP
    tokens tiled per window and CFG half."""
    j, port = nets
    rng = np.random.default_rng(0)
    latents = rng.standard_normal((1, 6, 8, 8, 4), dtype=np.float32) * 14.6
    cond = rng.standard_normal((1, 1, 8, 8, 4), dtype=np.float32)
    text_c, text_uc = (rng.standard_normal((1, 7, 24), dtype=np.float32) for _ in range(2))
    clip = rng.standard_normal((2, 4, 24), dtype=np.float32)
    _, _, _, _, refer, mid = _unet_inputs()
    refer, mid = [e[:1] for e in refer], mid[:1]
    guidance = np.full((2,), 3.5, np.float32)
    jspec = jden.DenoiseSpec(unet_cfg=j_refnet_config(**TINY_UNET), scheduler=JEuler.create(2),
                             plan=j_plan(6, 4, 2), guidance=guidance, n_vision_cond=1,
                             ip_adapter_scale=0.8)
    want = jax.jit(jden.denoise_loop, static_argnames=("spec",))(
        j["unet"], jspec, jnp.asarray(latents), jnp.asarray(text_uc), jnp.asarray(text_c),
        jax.random.PRNGKey(0), condition_latents=jnp.asarray(cond),
        vision_clip_emb=jnp.asarray(clip), refer_embs=[jnp.asarray(e) for e in refer],
        mid_refer_emb=jnp.asarray(mid),
    )
    spec = denoiser.DenoiseSpec(unet_cfg=port["unet"].cfg,
                                scheduler=EulerDiscreteScheduler.create(2),
                                plan=make_window_plan(6, 4, 2), guidance=guidance,
                                n_vision_cond=1, ip_adapter_scale=0.8)
    assert spec.plan.n_windows == 2
    with torch.no_grad():
        got = denoiser.denoise_loop(port["unet"], spec, _t(latents), _t(text_uc), _t(text_c),
                                    condition_latents=_t(cond), vision_clip_emb=_t(clip),
                                    refer_embs=[_t(e) for e in refer], mid_refer_emb=_t(mid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOOP_TOL)


def _jax_keys(key_map, init, cfg):
    tree = jax.eval_shape(partial(init, jax.random.PRNGKey(0), cfg))
    return set(jsw.export_key_names(list(key_map(cfg)), tree))


def _meta_keys(module):
    with torch.device("meta"):
        return set(module().state_dict())


def test_full_width_state_dict_keys_match_reference_keys():
    """The referencenet UNet, the ReferenceNet and ViT-H CLIP vision at full
    width (meta device) carry the reference torch keys; the JAX package maps
    CLIP's patch embedding outside its key map (``convert_clip_vision``)."""
    assert _meta_keys(lambda: UNet3D(musev_referencenet_config())) == _jax_keys(
        jsw.unet3d_key_map, init_unet3d, j_refnet_config())
    assert _meta_keys(lambda: ReferenceNet2D(ReferenceNetConfig())) == _jax_keys(
        jsw.referencenet_key_map, init_referencenet, JRefConfig())
    assert _meta_keys(lambda: CLIPVisionModel(CLIPVisionConfig())) == _jax_keys(
        jsw.clip_vision_key_map, init_clip_vision, JVisionConfig()) | {
        "vision_model.embeddings.patch_embedding.weight"}


def test_ip_adapter_site_paths_name_the_attn2_modules(nets):
    _, port = nets
    cfg = port["unet"].cfg
    paths = sd_weights.ip_adapter_site_paths(cfg)
    modules = dict(port["unet"].named_modules())
    assert len(paths) == len(jsw.ip_adapter_site_paths(j_refnet_config(**TINY_UNET)))
    assert all(hasattr(modules[p], "to_k_ip") for p in paths)
    assert paths[-1].startswith("mid_block") and paths[0].startswith("down_blocks.0")


def test_referencenet_text2video_on_cpu_gives_jax_shapes(nets):
    j, port = nets
    kv = jax.random.PRNGKey(11)
    jvae = init_vae(jax.random.fold_in(kv, 0), JVAEConfig(**TINY_VAE))
    jtext = init_clip_text(jax.random.fold_in(kv, 1), JCLIPConfig(**TINY_CLIP))
    vae = _port(AutoencoderKL(VAEConfig(**TINY_VAE)),
                convert.vae_from_jax(jvae, VAEConfig(**TINY_VAE)))
    text = _port(CLIPTextModel(CLIPTextConfig(**TINY_CLIP)),
                 convert.clip_text_from_jax(jtext, CLIPTextConfig(**TINY_CLIP)))
    image = np.random.default_rng(12).uniform(0, 255, (1, 1, 32, 32, 3)).astype(np.float32)
    kw = dict(height=32, width=32, video_length=3, n_batch=2, condition_images=image,
              video_num_inference_steps=1, context_frames=3, context_overlap=1, seed=5)
    jmodels = JModels(
        unet_params=j["unet"], unet_cfg=j_refnet_config(**TINY_UNET), vae_params=jvae,
        vae_cfg=JVAEConfig(**TINY_VAE), text_params=jtext, text_cfg=JCLIPConfig(**TINY_CLIP),
        tokenizer=JHashTokenizer(vocab_size=1000), referencenet_params=j["ref"],
        referencenet_cfg=JRefConfig(**TINY_REF), clip_vision_params=j["vision"],
        clip_vision_cfg=JVisionConfig(**TINY_VISION), ip_proj_params=j["proj"],
    )
    want = JPipeline(jmodels).text2video("a cat", **kw)
    models = MusevModels(unet=port["unet"], vae=vae, text_encoder=text,
                         tokenizer=HashTokenizer(vocab_size=1000), referencenet=port["ref"],
                         clip_vision=port["vision"], ip_proj=port["proj"])
    got = MusevPipeline(models).text2video("a cat", **kw)
    assert got.videos.shape == want.videos.shape == (1, 7, 32, 32, 3)
    assert got.latents.shape == want.latents.shape
    assert np.isfinite(got.videos).all()
    assert got.videos.min() >= 0.0 and got.videos.max() <= 1.0
