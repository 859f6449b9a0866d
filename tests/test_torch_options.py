"""The port's last text2video / video2video options against the JAX package.

The serial-denoise carry (``fuse_part_tensor``), histogram matching, CFG
rescale, the denoise loop's carries and recordings over two shots (one
started at ``start_step`` > 0, whose short record the next shot reads past
its end: the JAX package's index clamp), and both pipelines with every new
option on the pose slice (ControlNet and PoseGuider): text2video with
control images, the condition-image redraw, CFG rescale, histogram
matching, serial-denoise carries and per-step latents over two shots.
video2video's five are held against the JAX package in
``test_torch_controlnet.py``, beside its pose pipeline.

Both packages get the same weights (the JAX ``init_*`` trees with every leaf
redrawn as init + N(0, 0.05), carried by ``musev_torch.models.convert``)
and the same noise: each pipeline's ``make_noise`` is replaced by one
seeded numpy draw per call, in call order, since ``jax.random`` and
``torch.Generator`` give different numbers. float32 on the CPU.
Tolerances: host functions exact or 1e-6; two Euler steps of the whole
network, relative L2 1e-4 on the latents (an elementwise 1e-4 would fail
where CFG and sigma_max ~ 14.6 amplify float32 rounding).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import musev_torch.pipelines.pipeline as tpipe
import musev_tpu.pipelines.pipeline as jpipe
from musev_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from musev_tpu.models.clip_text import init_clip_text
from musev_tpu.models.controlnet import ControlNetConfig as JCNConfig
from musev_tpu.models.controlnet import init_controlnet, init_pose_guider
from musev_tpu.models.unet3d import init_unet3d
from musev_tpu.models.unet3d import musev_config as j_musev_config
from musev_tpu.models.vae import VAEConfig as JVAEConfig
from musev_tpu.models.vae import init_vae
from musev_tpu.ops.context import make_window_plan as j_plan
from musev_tpu.ops.index_ops import fuse_part_tensor as j_fuse_part_tensor
from musev_tpu.pipelines import denoiser as jden
from musev_tpu.schedulers.euler_discrete import EulerDiscreteScheduler as JEuler
from musev_tpu.utils import image_util as jimg
from musev_tpu.utils.tokenizer import HashTokenizer as JHashTokenizer
from musev_torch.models import convert
from musev_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from musev_torch.models.controlnet import ControlNet, ControlNetConfig, PoseGuider
from musev_torch.models.unet3d import UNet3D, musev_config
from musev_torch.models.vae import AutoencoderKL, VAEConfig
from musev_torch.ops.context import make_window_plan
from musev_torch.ops.index_ops import fuse_part_tensor
from musev_torch.pipelines import denoiser
from musev_torch.schedulers.euler_discrete import EulerDiscreteScheduler
from musev_torch.utils import image_util
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
TINY_CN = dict(TINY_UNET, cond_embed_channels=(4, 8, 8, 16))
TINY_VAE = dict(block_out_channels=(16, 16, 32, 32), layers_per_block=1, norm_num_groups=8)
TINY_CLIP = dict(vocab_size=1000, hidden_size=24, num_layers=2, num_heads=4,
                 intermediate_size=48)
LOOP_REL_L2 = 1e-4
HOST_TOL = dict(rtol=1e-6, atol=1e-6)


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


@pytest.mark.parametrize("overlap,weight,skip", [(2, 0.1, 0), (3, 0.01, 1), (0, 0.5, 0)])
def test_fuse_part_tensor_matches_jax(overlap, weight, skip):
    src, dst = _rand(1, 2, 5, 3, 3, 4), _rand(2, 2, 6, 3, 3, 4)
    want = j_fuse_part_tensor(jnp.asarray(src), jnp.asarray(dst), overlap, weight=weight,
                              skip_step=skip)
    got = fuse_part_tensor(_t(src), _t(dst), overlap, weight=weight, skip_step=skip)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **HOST_TOL)
    np.testing.assert_array_equal(got[:, skip + overlap:].numpy(), dst[:, skip + overlap:])


def test_rescale_noise_cfg_matches_jax():
    """Against the JAX function and float64 population stds (``jnp.std``'s;
    the rescale uses only their ratio, in which a sample std's n - 1 would
    cancel)."""
    cfg, text = _rand(3, 2, 3, 4, 4, 4) * 3.0, _rand(4, 2, 3, 4, 4, 4)
    want = np.asarray(jimg.rescale_noise_cfg(jnp.asarray(cfg), jnp.asarray(text), 0.7))
    got = image_util.rescale_noise_cfg(_t(cfg), _t(text), 0.7).numpy()
    np.testing.assert_allclose(got, want, **HOST_TOL)
    c64, t64 = cfg.astype(np.float64), text.astype(np.float64)
    ratio = t64.reshape(2, -1).std(1, ddof=0) / c64.reshape(2, -1).std(1, ddof=0)
    exact = 0.7 * c64 * ratio[:, None, None, None, None] + 0.3 * c64
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-5)


def test_hist_match_matches_jax():
    rng = np.random.default_rng(5)
    video = rng.uniform(0, 1, (3, 12, 10, 3)).astype(np.float32) ** 2
    ref = rng.uniform(0, 1, (12, 10, 3)).astype(np.float32)
    want = jimg.hist_match_video_to_frame(video, ref)
    got = image_util.hist_match_video_to_frame(video, ref)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - video).max() > 0.1


@pytest.fixture(scope="module")
def nets():
    k = jax.random.PRNGKey(9)
    jcfg = JCNConfig(**TINY_CN)
    j = dict(
        unet=_redraw(init_unet3d(jax.random.fold_in(k, 0), j_musev_config(**TINY_UNET)), 0),
        cn=_redraw(init_controlnet(jax.random.fold_in(k, 1), jcfg), 1),
        pg=_redraw(init_pose_guider(jax.random.fold_in(k, 2), jcfg), 2),
        vae=init_vae(jax.random.fold_in(k, 3), JVAEConfig(**TINY_VAE)),
        text=init_clip_text(jax.random.fold_in(k, 4), JCLIPConfig(**TINY_CLIP)),
    )
    cfg, ucfg = ControlNetConfig(**TINY_CN), musev_config(**TINY_UNET)
    port = dict(
        unet=_port(UNet3D(ucfg), convert.unet3d_from_jax(j["unet"], ucfg)),
        cn=_port(ControlNet(cfg), convert.controlnet_from_jax(j["cn"], cfg)),
        pg=_port(PoseGuider(cfg), convert.pose_guider_from_jax(j["pg"], cfg)),
        vae=_port(AutoencoderKL(VAEConfig(**TINY_VAE)),
                  convert.vae_from_jax(j["vae"], VAEConfig(**TINY_VAE))),
        text=_port(CLIPTextModel(CLIPTextConfig(**TINY_CLIP)),
                   convert.clip_text_from_jax(j["text"], CLIPTextConfig(**TINY_CLIP))),
    )
    return j, port


def test_denoise_loop_serial_carries_and_clamp_match_jax(nets):
    """One shot of 4 frames, 4 Euler steps from start_step 2, carrying a
    previous shot's record of overlap 2, recording its own carries and every
    step's latents. A shot from start_step 2 records 4 - 2 + 1 = 3 entries,
    so at step 2 (<= 4 // 2) the noise fuse reads entry 3 past that record:
    it reads entry 2, as the JAX package's dynamic index clamps, where torch
    indexing would raise."""
    j, port = nets
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((1, 4, 4, 4, 4), dtype=np.float32) * 3.0
    last = [rng.standard_normal((3, 1, 2, 4, 4, 4), dtype=np.float32) for _ in range(2)]
    text_c, text_uc = (rng.standard_normal((1, 7, 24), dtype=np.float32) for _ in range(2))
    kw = dict(guidance=np.full((4,), 3.5, np.float32), start_step=2, video_overlap=2,
              record_mid_video=True, record_step_latents=True, guidance_rescale=0.5)
    jspec = jden.DenoiseSpec(unet_cfg=j_musev_config(**TINY_UNET), scheduler=JEuler.create(4),
                             plan=j_plan(4, 4, 0), **kw)
    spec = denoiser.DenoiseSpec(unet_cfg=port["unet"].cfg,
                                scheduler=EulerDiscreteScheduler.create(4),
                                plan=make_window_plan(4, 4, 0), **kw)
    want = jax.jit(jden.denoise_loop, static_argnames=("spec",))(
        j["unet"], jspec, jnp.asarray(lat), jnp.asarray(text_uc), jnp.asarray(text_c),
        jax.random.PRNGKey(0), last_mid_latents=jnp.asarray(last[0]),
        last_mid_noises=jnp.asarray(last[1]))
    carried = dict(last_mid_latents=_t(last[0]), last_mid_noises=_t(last[1]))
    with torch.no_grad():
        got = denoiser.denoise_loop(port["unet"], spec, _t(lat), _t(text_uc), _t(text_c),
                                    **carried)
        alone = denoiser.denoise_loop(port["unet"], spec, _t(lat), _t(text_uc), _t(text_c))
    assert len(got) == len(want) == 3
    assert got[1][0].shape == want[1][0].shape == (3, 1, 2, 4, 4, 4)
    assert got[2].shape == want[2].shape == (2, 1, 4, 4, 4, 4)
    assert not got[1][1][0].any()  # the zero noise slot
    for a, b in [(got[0], want[0]), (got[1][0], want[1][0]), (got[1][1][1:], want[1][1][1:]),
                 (got[2], want[2])]:
        assert _rel_l2(a.numpy(), b) <= LOOP_REL_L2
    # the carries act
    assert _rel_l2(got[0].numpy(), alone[0].numpy()) > 100 * LOOP_REL_L2


@contextlib.contextmanager
def _same_noise(seed):
    """Both pipelines' ``make_noise`` draw, call by call, the same seeded
    N(0, 1) arrays."""
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


@pytest.fixture(scope="module")
def pipes(nets):
    j, port = nets
    jmodels = jpipe.MusevModels(
        unet_params=j["unet"], unet_cfg=j_musev_config(**TINY_UNET), vae_params=j["vae"],
        vae_cfg=JVAEConfig(**TINY_VAE), text_params=j["text"], text_cfg=JCLIPConfig(**TINY_CLIP),
        tokenizer=JHashTokenizer(vocab_size=1000), controlnet_params=j["cn"],
        controlnet_cfg=JCNConfig(**TINY_CN), pose_guider_params=j["pg"],
        pose_guider_cfg=JCNConfig(**TINY_CN),
    )
    models = tpipe.MusevModels(unet=port["unet"], vae=port["vae"], text_encoder=port["text"],
                               tokenizer=HashTokenizer(vocab_size=1000), controlnet=port["cn"],
                               pose_guider=port["pg"])
    return jpipe.MusevPipeline(jmodels), tpipe.MusevPipeline(models)


def test_text2video_options_match_jax(pipes):
    """Two shots of 4 frames (2 Euler steps) with the pose maps of 1 + 8
    frames through the ControlNet (scale 0.8) and the PoseGuider, the
    condition image redrawn at strength 0.6 of 4 steps, CFG rescale 0.7,
    histogram matching, the serial-denoise carry of 2 frames and per-step
    latents; each option moves the port's latents."""
    jp, tp = pipes
    rng = np.random.default_rng(7)
    image = rng.uniform(0, 255, (1, 1, 32, 32, 3)).astype(np.float32)
    ctrl = rng.uniform(0, 255, (1, 9, 32, 32, 3)).astype(np.float32)
    base = dict(height=32, width=32, video_length=4, n_batch=2, condition_images=image,
                video_num_inference_steps=2, num_inference_steps=4, context_frames=4,
                context_overlap=0, seed=3)
    opts = dict(control_images=ctrl, controlnet_conditioning_scale=0.8,
                redraw_condition_image=True, redraw_strength=0.6, guidance_rescale=0.7,
                need_hist_match=True, record_mid_video=True, video_overlap=2,
                need_middle_latents=True)
    with _same_noise(11) as calls:
        want = jp.text2video("a dancer", **base, **opts)
        got = tp.text2video("a dancer", **base, **opts)
    assert calls["jax"] == calls["torch"] == 3  # the redraw, then one per shot
    assert got.latents.shape == want.latents.shape == (1, 9, 4, 4, 4)
    assert _rel_l2(got.latents, want.latents) <= LOOP_REL_L2
    assert got.videos_mid.shape == want.videos_mid.shape == (2, 1, 8, 32, 32, 3)
    assert _rel_l2(got.videos_mid, want.videos_mid) <= LOOP_REL_L2
    assert got.mid_video_latents.shape == want.mid_video_latents.shape == (3, 1, 2, 4, 4, 4)
    assert _rel_l2(got.mid_video_latents, want.mid_video_latents) <= LOOP_REL_L2
    assert _rel_l2(got.mid_video_noises[1:], want.mid_video_noises[1:]) <= LOOP_REL_L2
    # histogram matching rounds each frame to uint8 first, so a value within
    # float32 rounding of a bin edge may land one bin apart
    assert got.videos.shape == want.videos.shape == (1, 9, 32, 32, 3)
    assert np.mean(np.abs(got.videos - want.videos) > 1e-4) < 1e-2
    for drop in ({"control_images": None}, {"redraw_condition_image": False},
                 {"guidance_rescale": 0.0}, {"record_mid_video": False}):
        with _same_noise(11):
            cut = tp.text2video("a dancer", **base, **dict(opts, **drop))
        assert _rel_l2(cut.latents, got.latents) > 100 * LOOP_REL_L2, drop
