"""The port's ``musev_referencenet_pose`` slice against the JAX package.

ControlNet, PoseGuider, a UNet3D call with their residuals and embedding, the
denoise engine with control images and an img2img ``start_step``, the key
names, the video2video pipeline's shapes, and video2video with its serial
denoise, per-step latents, histogram matching and CFG rescale (relative L2
1e-4 on the latents, each pipeline's noise replaced by the same seeded
draws). Both sides get the same weights: the JAX package's
``init_*`` trees with every leaf redrawn as init + N(0, 0.05), so the
zero-initialised convs (the ControlNet's zero convs, both stems' conv_out)
are not zero and the control branches show in the output;
``musev_torch.models.convert`` carries them over and ``load_state_dict``
loads them strictly. Inputs come from a seeded numpy RNG; float32 on the CPU.
Tolerances: a few convolutions 1e-5 (float32 rounding in another summation
order), a whole network 1e-4 (differences compound through its layers), two
Euler steps 1e-3 (amplified by the CFG scale and sigma_max ~ 14.6).
"""

from functools import partial

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import musev_torch.pipelines.pipeline as tpipe
import musev_tpu.pipelines.pipeline as jpipe
from musev_tpu.models import sd_weights as jsw
from musev_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from musev_tpu.models.clip_text import init_clip_text
from musev_tpu.models.controlnet import ControlNetConfig as JCNConfig
from musev_tpu.models.controlnet import controlnet_apply as j_controlnet_apply
from musev_tpu.models.controlnet import init_controlnet, init_pose_guider
from musev_tpu.models.controlnet import pose_guider_apply as j_pose_guider_apply
from musev_tpu.models.unet3d import init_unet3d
from musev_tpu.models.unet3d import musev_config as j_musev_config
from musev_tpu.models.unet3d import unet3d_apply as j_unet3d_apply
from musev_tpu.models.vae import VAEConfig as JVAEConfig
from musev_tpu.models.vae import init_vae
from musev_tpu.ops.context import make_window_plan as j_plan
from musev_tpu.pipelines import denoiser as jden
from musev_tpu.schedulers.euler_discrete import EulerDiscreteScheduler as JEuler
from musev_tpu.utils.tokenizer import HashTokenizer as JHashTokenizer
from musev_torch.models import convert, sd_weights
from musev_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from musev_torch.models.controlnet import (
    ControlNet,
    ControlNetConfig,
    PoseGuider,
    controlnet_apply,
    pose_guider_apply,
)
from musev_torch.models.unet3d import UNet3D, musev_config, unet3d_apply
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
                 cross_attention_dim=24, attention_heads=4, norm_num_groups=8)
TINY_CN = dict(TINY_UNET, cond_embed_channels=(4, 8, 8, 16))
TINY_VAE = dict(block_out_channels=(16, 16, 32, 32), layers_per_block=1, norm_num_groups=8)
TINY_CLIP = dict(vocab_size=1000, hidden_size=24, num_layers=2, num_heads=4,
                 intermediate_size=48)
MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
NET_TOL = dict(rtol=1e-4, atol=1e-4)
LOOP_TOL = dict(rtol=1e-3, atol=1e-3)
N_RES = 8  # ControlNet down residuals of the tiny config: conv_in + 4 layers + 3 downsamplers


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _images(seed, *shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


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
    k = jax.random.PRNGKey(5)
    jcfg = JCNConfig(**TINY_CN)
    j = dict(
        unet=_redraw(init_unet3d(jax.random.fold_in(k, 0), j_musev_config(**TINY_UNET)), 0),
        cn=_redraw(init_controlnet(jax.random.fold_in(k, 1), jcfg), 1),
        pg=_redraw(init_pose_guider(jax.random.fold_in(k, 2), jcfg), 2),
    )
    cfg, ucfg = ControlNetConfig(**TINY_CN), musev_config(**TINY_UNET)
    port = dict(
        unet=_port(UNet3D(ucfg), convert.unet3d_from_jax(j["unet"], ucfg)),
        cn=_port(ControlNet(cfg), convert.controlnet_from_jax(j["cn"], cfg)),
        pg=_port(PoseGuider(cfg), convert.pose_guider_from_jax(j["pg"], cfg)),
    )
    return j, port


@pytest.mark.parametrize("net", ["controlnet", "pose_guider"])
def test_control_branch_matches_jax(nets, net):
    """The ControlNet's 8 down residuals and mid residual (1e-4), the
    PoseGuider's embedding (1e-5)."""
    j, port = nets
    sample, text, cond = _rand(1, 3, 4, 4, 4), _rand(2, 3, 5, 24), _images(3, 3, 32, 32, 3)
    if net == "controlnet":
        want_down, want_mid = jax.jit(partial(j_controlnet_apply, cfg=JCNConfig(**TINY_CN),
                                              conditioning_scale=0.7))(
            j["cn"], sample=sample, timestep=641.0, encoder_hidden_states=text, cond_image=cond)
        want, tol = list(want_down) + [want_mid], NET_TOL
        with torch.no_grad():
            down, mid = controlnet_apply(port["cn"], _t(sample), 641.0, _t(text), _t(cond),
                                         conditioning_scale=0.7)
        got = down + [mid]
        assert len(got) == N_RES + 1
    else:
        want, tol = [j_pose_guider_apply(j["pg"], jnp.asarray(cond))], MODULE_TOL
        with torch.no_grad():
            got = [pose_guider_apply(port["pg"], _t(cond))]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
    assert max(np.abs(np.asarray(w)).max() for w in want) > 100 * tol["atol"]


def _control_inputs(j):
    """A spliced UNet call of 2 rows x (1 condition + 3) frames at 4x4, with
    N(0, 1) residuals and the PoseGuider's embedding of random images. An
    N(0, 1) embedding instead puts the JAX GroupNorm's one-pass variance
    E[x^2] - E[x]^2 off a float64 reference by more than NET_TOL, where the
    port's two-pass variance stays within it."""
    sample, cond, text = _rand(6, 2, 3, 4, 4, 4), _rand(7, 2, 1, 4, 4, 4), _rand(8, 2, 7, 24)
    sizes = [(4, 16), (4, 16), (2, 16), (2, 16), (1, 16), (1, 32), (1, 32), (1, 32)]
    down = [_rand(10 + i, 8, s, s, c) for i, (s, c) in enumerate(sizes)]
    pose = np.asarray(j_pose_guider_apply(j["pg"], jnp.asarray(_images(21, 8, 32, 32, 3))))
    return sample, cond, text, down, _rand(20, 8, 1, 1, 32), pose


def _port_unet(unet, sample, cond, text, down, mid, pose):
    with torch.no_grad():
        return unet3d_apply(
            unet, _t(sample), 641.0, _t(text), condition_latents=_t(cond),
            gen_index=(1, 2, 3), cond_index=(0,), do_cfg=True,
            controlnet_down_residuals=None if down is None else [_t(r) for r in down],
            controlnet_mid_residual=None if mid is None else _t(mid),
            pose_guider_emb=None if pose is None else _t(pose),
        ).numpy()


def test_unet3d_with_control_inputs_matches_jax(nets):
    j, port = nets
    sample, cond, text, down, mid, pose = _control_inputs(j)
    want = jax.jit(partial(j_unet3d_apply, cfg=j_musev_config(**TINY_UNET), gen_index=(1, 2, 3),
                           cond_index=(0,), do_cfg=True))(
        j["unet"], sample=sample, timestep=jnp.asarray(641.0), text_emb=text,
        condition_latents=cond, controlnet_down_residuals=down,
        controlnet_mid_residual=mid, pose_guider_emb=pose,
    )
    got = _port_unet(port["unet"], sample, cond, text, down, mid, pose)
    np.testing.assert_allclose(got, np.asarray(want), **NET_TOL)


@pytest.mark.parametrize("drop", ["down", "mid", "pose"])
def test_control_inputs_change_the_output(nets, drop):
    """Dropping any of the three inputs moves the UNet output by far more
    than NET_TOL, so the parity test above would catch a port that skipped it."""
    j, port = nets
    sample, cond, text, down, mid, pose = _control_inputs(j)
    full = _port_unet(port["unet"], sample, cond, text, down, mid, pose)
    args = dict(down=down, mid=mid, pose=pose)
    args[drop] = None
    cut = _port_unet(port["unet"], sample, cond, text, **args)
    assert np.abs(full - cut).max() > 100 * NET_TOL["atol"]


def test_denoise_loop_with_control_images_and_start_step_matches_jax(nets):
    """Steps 1 and 2 of a 3-step schedule (start_step 1) from noised source
    latents, 6 frames in 2 windows of 4 overlapping by 2, one vision
    condition frame, CFG, the ControlNet at scale 0.8 and the PoseGuider on
    (1 + 6) control frames gathered per window."""
    j, port = nets
    rng = np.random.default_rng(0)
    source = rng.standard_normal((1, 6, 4, 4, 4), dtype=np.float32)
    noise = rng.standard_normal((1, 6, 4, 4, 4), dtype=np.float32)
    cond = rng.standard_normal((1, 1, 4, 4, 4), dtype=np.float32)
    text_c, text_uc = (rng.standard_normal((1, 7, 24), dtype=np.float32) for _ in range(2))
    ctrl = rng.uniform(0, 1, (1, 7, 32, 32, 3)).astype(np.float32)
    guidance = np.full((3,), 3.5, np.float32)
    kw = dict(guidance=guidance, n_vision_cond=1, start_step=1, controlnet_scale=0.8)
    jsched = JEuler.create(3)
    jspec = jden.DenoiseSpec(unet_cfg=j_musev_config(**TINY_UNET), scheduler=jsched,
                             plan=j_plan(6, 4, 2), controlnet_cfg=JCNConfig(**TINY_CN),
                             pose_guider_cfg=JCNConfig(**TINY_CN), **kw)
    want = jax.jit(jden.denoise_loop, static_argnames=("spec",))(
        j["unet"], jspec, jsched.add_noise(jnp.asarray(source), jnp.asarray(noise), 1),
        jnp.asarray(text_uc), jnp.asarray(text_c), jax.random.PRNGKey(0),
        condition_latents=jnp.asarray(cond), controlnet_params=j["cn"],
        control_images=jnp.asarray(ctrl), pose_guider_params=j["pg"],
    )
    sched = EulerDiscreteScheduler.create(3)
    spec = denoiser.DenoiseSpec(unet_cfg=port["unet"].cfg, scheduler=sched,
                                plan=make_window_plan(6, 4, 2),
                                controlnet_cfg=port["cn"].cfg, pose_guider_cfg=port["pg"].cfg,
                                **kw)
    assert spec.plan.n_windows == 2
    with torch.no_grad():
        got = denoiser.denoise_loop(port["unet"], spec, sched.add_noise(_t(source), _t(noise), 1),
                                    _t(text_uc), _t(text_c), condition_latents=_t(cond),
                                    controlnet=port["cn"], control_images=_t(ctrl),
                                    pose_guider=port["pg"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOOP_TOL)


def _jax_keys(key_map, init, cfg):
    tree = jax.eval_shape(partial(init, jax.random.PRNGKey(0), cfg))
    return set(jsw.export_key_names(list(key_map(cfg)), tree))


def _meta_keys(module):
    with torch.device("meta"):
        return set(module().state_dict())


def test_full_width_state_dict_keys_match_reference_keys():
    """The ControlNet and PoseGuider at full width (meta device) carry the
    reference torch keys, and the port's key maps are the JAX package's."""
    cfg, jcfg = ControlNetConfig(), JCNConfig()
    assert _meta_keys(lambda: ControlNet(cfg)) == _jax_keys(
        jsw.controlnet_key_map, init_controlnet, jcfg)
    assert _meta_keys(lambda: PoseGuider(cfg)) == _jax_keys(
        jsw.pose_guider_key_map, init_pose_guider, jcfg)
    for mine, theirs in ((sd_weights.controlnet_key_map, jsw.controlnet_key_map),
                         (sd_weights.pose_guider_key_map, jsw.pose_guider_key_map)):
        assert list(mine(cfg)) == list(theirs(jcfg))


@pytest.fixture(scope="module")
def pipe(nets):
    j, port = nets
    kv = jax.random.PRNGKey(11)
    jvae = init_vae(jax.random.fold_in(kv, 0), JVAEConfig(**TINY_VAE))
    jtext = init_clip_text(jax.random.fold_in(kv, 1), JCLIPConfig(**TINY_CLIP))
    models = MusevModels(
        unet=port["unet"],
        vae=_port(AutoencoderKL(VAEConfig(**TINY_VAE)),
                  convert.vae_from_jax(jvae, VAEConfig(**TINY_VAE))),
        text_encoder=_port(CLIPTextModel(CLIPTextConfig(**TINY_CLIP)),
                           convert.clip_text_from_jax(jtext, CLIPTextConfig(**TINY_CLIP))),
        tokenizer=HashTokenizer(vocab_size=1000), controlnet=port["cn"], pose_guider=port["pg"],
    )
    return MusevPipeline(models)


V2V_ARGS = dict(video_is_middle=True, time_size=4, context_frames=4, context_overlap=1,
                video_num_inference_steps=2, height=32, width=32, seed=3)


def test_video2video_on_cpu_gives_jax_shapes(pipe):
    """A 6-frame pose source in shots of 4: a full window and a trailing
    window of 2, each shot conditioned on the previous shot's last frame,
    from a given condition image, with img2img strength. The JAX pipeline's
    shapes for this source are pinned by the JAX package's own test
    (``test_controlnet_v2v.py::test_video2video_partial_tail_window``: one
    condition frame + 4 + 2); running it here would cost about 18 s of
    compilation. Zeroing the pose frames changes the output."""
    rng = np.random.default_rng(12)
    video = rng.uniform(0, 255, (6, 32, 32, 3)).astype(np.uint8)
    image = rng.uniform(0, 255, (1, 1, 32, 32, 3)).astype(np.float32)
    kw = dict(V2V_ARGS, condition_images=image, need_video2video=True, video_strength=0.5)
    got = pipe.video2video("a dancer", video, **kw)
    assert got.videos.shape == (1, 7, 32, 32, 3)
    assert got.latents.shape == (1, 7, 4, 4, 4)
    assert np.isfinite(got.videos).all()
    assert got.videos.min() >= 0.0 and got.videos.max() <= 1.0
    zeroed = pipe.video2video("a dancer", np.zeros_like(video), **kw)
    assert np.abs(zeroed.latents - got.latents).max() > 1e-3


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


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


@pytest.fixture(scope="module")
def v2v_options(nets, pipe):
    """video2video with its five options, on both packages: an 8-frame pose
    source in two windows of 4 from noised source latents (strength 0.5 of 2
    steps: start_step 1, so the second window reads the first's short record
    past its end, where the JAX package clamps), CFG rescale 0.7, histogram
    matching, the serial-denoise carry of 2 frames and per-step latents."""
    j, _ = nets
    kv = jax.random.PRNGKey(11)  # the vae and text encoder of ``pipe``
    jmodels = jpipe.MusevModels(
        unet_params=j["unet"], unet_cfg=j_musev_config(**TINY_UNET),
        vae_params=init_vae(jax.random.fold_in(kv, 0), JVAEConfig(**TINY_VAE)),
        vae_cfg=JVAEConfig(**TINY_VAE),
        text_params=init_clip_text(jax.random.fold_in(kv, 1), JCLIPConfig(**TINY_CLIP)),
        text_cfg=JCLIPConfig(**TINY_CLIP), tokenizer=JHashTokenizer(vocab_size=1000),
        controlnet_params=j["cn"], controlnet_cfg=JCNConfig(**TINY_CN),
        pose_guider_params=j["pg"], pose_guider_cfg=JCNConfig(**TINY_CN),
    )
    rng = np.random.default_rng(8)
    video = rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    image = rng.uniform(0, 255, (1, 1, 32, 32, 3)).astype(np.float32)
    kw = dict(V2V_ARGS, condition_images=image, need_video2video=True, video_strength=0.5,
              guidance_rescale=0.7, need_hist_match=True, record_mid_video=True,
              video_overlap=2, need_middle_latents=True)
    with _same_noise(12) as calls:
        want = jpipe.MusevPipeline(jmodels).video2video("a dancer", video, **kw)
        got = pipe.video2video("a dancer", video, **kw)
    assert calls["jax"] == calls["torch"] == 2
    return got, want, kw, video


@pytest.mark.parametrize("option,value", [("record_mid_video", True), ("need_middle_latents", True),
                                          ("need_hist_match", True), ("guidance_rescale", 0.7)])
def test_video2video_refuses_unported_options(pipe, v2v_options, option, value):
    """Each option runs and its output matches the JAX package's (the clip
    with all five on); off again, the port's clip changes, or, for the
    recordings, the output gains them and the latents stay."""
    got, want, kw, video = v2v_options
    assert got.latents.shape == want.latents.shape == (1, 9, 4, 4, 4)
    assert _rel_l2(got.latents, want.latents) <= 1e-4
    if option == "record_mid_video":  # (steps run + 1, B, overlap, h, w, C)
        assert got.mid_video_latents.shape == want.mid_video_latents.shape == (2, 1, 2, 4, 4, 4)
        assert _rel_l2(got.mid_video_latents, want.mid_video_latents) <= 1e-4
        assert _rel_l2(got.mid_video_noises[1:], want.mid_video_noises[1:]) <= 1e-4
    elif option == "need_middle_latents":  # (steps run, B, 8 frames, H, W, 3)
        assert got.videos_mid.shape == want.videos_mid.shape == (1, 1, 8, 32, 32, 3)
        assert _rel_l2(got.videos_mid, want.videos_mid) <= 1e-4
    elif option == "need_hist_match":
        # each frame is rounded to uint8 first: a value within float32
        # rounding of a bin edge may land one bin apart
        assert got.videos.shape == want.videos.shape == (1, 9, 32, 32, 3)
        assert np.mean(np.abs(got.videos - want.videos) > 1e-4) < 1e-2
    with _same_noise(12):
        off = pipe.video2video("a dancer", video,
                               **dict(kw, **{option: False if value is True else 0.0}))
    if option == "need_middle_latents":  # a recording only
        assert off.videos_mid is None
        np.testing.assert_array_equal(off.latents, got.latents)
    elif option == "need_hist_match":
        np.testing.assert_array_equal(off.latents, got.latents)
        assert np.abs(off.videos - got.videos).max() > 1e-2
    else:  # the carry and the rescale move the latents
        assert _rel_l2(off.latents, got.latents) > 1e-2
