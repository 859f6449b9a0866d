"""The port's denoise engine, decode and text2video against the JAX package.

Same weights on both sides (carried by ``musev_torch.models.convert``) and the
same initial latents, drawn with numpy: ``jax.random`` and
``torch.Generator`` give different numbers. Tolerance 1e-3 for two Euler
steps of the whole UNet over two windows with CFG: float32 differences of
~1e-5 per UNet call are amplified by the CFG scale and sigma_max ~ 14.6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musev_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from musev_tpu.models.clip_text import init_clip_text
from musev_tpu.models.unet3d import UNet3DConfig as JUNetConfig
from musev_tpu.models.unet3d import init_unet3d
from musev_tpu.models.vae import VAEConfig as JVAEConfig
from musev_tpu.models.vae import init_vae
from musev_tpu.models.vae import vae_decode_video as j_decode_video
from musev_tpu.ops.context import make_window_plan as j_plan
from musev_tpu.pipelines import denoiser as jden
from musev_tpu.pipelines.pipeline import MusevModels as JModels
from musev_tpu.pipelines.pipeline import MusevPipeline as JPipeline
from musev_tpu.schedulers.euler_discrete import EulerDiscreteScheduler as JEuler
from musev_tpu.utils.tokenizer import HashTokenizer as JHashTokenizer
from musev_torch.configs.model_registry import get_model_preset
from musev_torch.models import convert
from musev_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from musev_torch.models.unet3d import UNet3D, UNet3DConfig
from musev_torch.models.vae import AutoencoderKL, VAEConfig, vae_decode_video
from musev_torch.ops.context import make_window_plan
from musev_torch.pipelines import denoiser
from musev_torch.pipelines.loader import build_models
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
                 cross_attention_dim=24, attention_heads=4, norm_num_groups=8)
TINY_VAE = dict(block_out_channels=(16, 16, 32, 32), layers_per_block=1, norm_num_groups=8)
TINY_CLIP = dict(vocab_size=1000, hidden_size=24, num_layers=2, num_heads=4,
                 intermediate_size=48)
LOOP_TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def models():
    k = jax.random.PRNGKey(0)
    jp = dict(
        unet=init_unet3d(jax.random.fold_in(k, 0), JUNetConfig(**TINY_UNET)),
        vae=init_vae(jax.random.fold_in(k, 1), JVAEConfig(**TINY_VAE)),
        text=init_clip_text(jax.random.fold_in(k, 2), JCLIPConfig(**TINY_CLIP)),
    )
    unet, vae, clip = UNet3D(UNet3DConfig(**TINY_UNET)), AutoencoderKL(VAEConfig(**TINY_VAE)), \
        CLIPTextModel(CLIPTextConfig(**TINY_CLIP))
    unet.load_state_dict(convert.unet3d_from_jax(jp["unet"], unet.cfg), strict=True)
    vae.load_state_dict(convert.vae_from_jax(jp["vae"], vae.cfg), strict=True)
    clip.load_state_dict(convert.clip_text_from_jax(jp["text"], clip.cfg), strict=True)
    port = MusevModels(unet=unet.eval(), vae=vae.eval(), text_encoder=clip.eval(),
                       tokenizer=HashTokenizer(vocab_size=1000))
    return jp, port


def test_denoise_loop_and_decode_match_jax(models):
    """2 Euler steps, 6 frames in 2 windows of 4 overlapping by 2, 1 vision
    condition frame, CFG; then the segmented VAE decode."""
    jp, port = models
    rng = np.random.default_rng(0)
    latents = rng.standard_normal((1, 6, 4, 4, 4), dtype=np.float32) * 14.6
    cond = rng.standard_normal((1, 1, 4, 4, 4), dtype=np.float32)
    text_c, text_uc = (rng.standard_normal((1, 9, 24), dtype=np.float32) for _ in range(2))
    guidance = np.full((2,), 3.5, np.float32)

    jspec = jden.DenoiseSpec(unet_cfg=JUNetConfig(**TINY_UNET), scheduler=JEuler.create(2),
                             plan=j_plan(6, 4, 2), guidance=guidance, n_vision_cond=1)
    want = jden.denoise_loop(jp["unet"], jspec, jnp.asarray(latents), jnp.asarray(text_uc),
                             jnp.asarray(text_c), jax.random.PRNGKey(0),
                             condition_latents=jnp.asarray(cond))
    spec = denoiser.DenoiseSpec(unet_cfg=port.unet.cfg, scheduler=EulerDiscreteScheduler.create(2),
                                plan=make_window_plan(6, 4, 2), guidance=guidance,
                                n_vision_cond=1)
    assert spec.plan.n_windows == 2
    t = torch.from_numpy
    with torch.no_grad():
        got = denoiser.denoise_loop(port.unet, spec, t(latents), t(text_uc), t(text_c),
                                    condition_latents=t(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOOP_TOL)

    full = np.concatenate([cond, np.asarray(want)], axis=1) * 0.2
    want_vid = j_decode_video(jp["vae"], JVAEConfig(**TINY_VAE), jnp.asarray(full), segment=3)
    with torch.no_grad():
        got_vid = vae_decode_video(port.vae, t(full), segment=3)
    np.testing.assert_allclose(got_vid.numpy(), np.asarray(want_vid), rtol=1e-5, atol=1e-5)


def test_text2video_on_cpu_gives_jax_shapes(models):
    jp, port = models
    kw = dict(height=32, width=32, video_length=3, n_batch=2,
              video_num_inference_steps=1, num_inference_steps=1,
              context_frames=3, context_overlap=1, seed=5)
    jmodels = JModels(unet_params=jp["unet"], unet_cfg=JUNetConfig(**TINY_UNET),
                      vae_params=jp["vae"], vae_cfg=JVAEConfig(**TINY_VAE),
                      text_params=jp["text"], text_cfg=JCLIPConfig(**TINY_CLIP),
                      tokenizer=JHashTokenizer(vocab_size=1000))
    want = JPipeline(jmodels).text2video("a cat", **kw)
    got = MusevPipeline(port).text2video("a cat", **kw)
    assert got.videos.shape == want.videos.shape == (1, 7, 32, 32, 3)
    assert got.latents.shape == want.latents.shape
    assert np.isfinite(got.videos).all()
    assert got.videos.min() >= 0.0 and got.videos.max() <= 1.0


def test_text2video_refuses_unported_branches(models):
    """Face embeddings and control images on the ``musev`` preset, which has
    no FaceID branch, ControlNet or PoseGuider: the JAX pipeline ignores
    them, and so does the port (the clip is the one without them)."""
    jp, port = models
    kw = dict(height=32, width=32, video_length=3, n_batch=1, video_num_inference_steps=1,
              num_inference_steps=1, context_frames=3, context_overlap=1, seed=5)
    jmodels = JModels(unet_params=jp["unet"], unet_cfg=JUNetConfig(**TINY_UNET),
                      vae_params=jp["vae"], vae_cfg=JVAEConfig(**TINY_VAE),
                      text_params=jp["text"], text_cfg=JCLIPConfig(**TINY_CLIP),
                      tokenizer=JHashTokenizer(vocab_size=1000))
    options = dict(face_emb=np.ones((1, 512)), ip_adapter_face_scale=0.3,
                   control_images=np.ones((1, 4, 32, 32, 3)), controlnet_conditioning_scale=0.5)
    for pipe in (JPipeline(jmodels), MusevPipeline(port)):
        plain = pipe.text2video("a cat", **kw)
        got = pipe.text2video("a cat", **kw, **options)
        np.testing.assert_array_equal(got.latents, plain.latents)
        np.testing.assert_array_equal(got.videos, plain.videos)


def test_build_models_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_models("musev")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_models("musev_referencenet")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_models("musev_referencenet_pose")
    with pytest.raises(ValueError, match="unknown preset"):
        build_models("musev_pose", device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_models(get_model_preset("musev_referencenet", ip_adapter_model_name="IPAdapterPlus",
                                      ip_adapter_face_checkpoint="faceid.bin"))
