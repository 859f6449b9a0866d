"""The port's pipelines take every keyword of the JAX pipelines, and run it.

The JAX signatures are read from ``musev_tpu/pipelines/pipeline.py`` with
``ast``: the port's ``text2video`` and ``video2video`` have the same
keywords with the same defaults. Each text2video option then runs on a tiny
``musev`` preset against the JAX pipeline on the same weights (carried by
``musev_torch.models.convert``) and the same noise (each pipeline's
``make_noise`` replaced by one seeded numpy draw per call): an option with
a branch matches the JAX clip (relative L2 1e-4 on the latents, 2 Euler
steps); an option that the JAX pipeline reads only under another that is
off, or whose branch the preset lacks (no ControlNet, no FaceID), leaves
the clip as it is, in both packages; an unknown keyword raises
``TypeError``.
"""

import ast
import contextlib
import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import musev_torch.pipelines.pipeline as tpipe
import musev_tpu.pipelines.pipeline as jpipe
from musev_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from musev_tpu.models.clip_text import init_clip_text
from musev_tpu.models.unet3d import UNet3DConfig as JUNetConfig
from musev_tpu.models.unet3d import init_unet3d
from musev_tpu.models.vae import VAEConfig as JVAEConfig
from musev_tpu.models.vae import init_vae
from musev_tpu.utils.tokenizer import HashTokenizer as JHashTokenizer
from musev_torch.models import convert
from musev_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from musev_torch.models.unet3d import UNet3D, UNet3DConfig
from musev_torch.models.vae import AutoencoderKL, VAEConfig
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


JAX_PIPELINE = Path(__file__).resolve().parents[1] / "musev_tpu" / "pipelines" / "pipeline.py"
TINY_UNET = dict(block_out_channels=(16, 16, 32, 32), layers_per_block=1,
                 cross_attention_dim=24, attention_heads=4, norm_num_groups=8)
TINY_VAE = dict(block_out_channels=(16, 16, 32, 32), layers_per_block=1, norm_num_groups=8)
TINY_CLIP = dict(vocab_size=1000, hidden_size=24, num_layers=2, num_heads=4,
                 intermediate_size=48)
LOOP_REL_L2 = 1e-4


def _jax_defaults(method: str) -> dict:
    """Every keyword of the JAX ``MusevPipeline.<method>`` with a default."""
    tree = ast.parse(JAX_PIPELINE.read_text())
    cls = next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == "MusevPipeline")
    fn = next(n for n in cls.body if isinstance(n, ast.FunctionDef) and n.name == method)
    a = fn.args
    named = list(zip(a.args[len(a.args) - len(a.defaults):], a.defaults))
    named += [(arg, d) for arg, d in zip(a.kwonlyargs, a.kw_defaults) if d is not None]
    return {arg.arg: ast.literal_eval(d) for arg, d in named}


@pytest.mark.parametrize("method", ["text2video", "video2video"])
def test_jax_keywords_pass_at_their_defaults(method):
    jax_kw = _jax_defaults(method)
    assert len(jax_kw) > 20, "the JAX signature was not read"
    port = {name: p.default for name, p in
            inspect.signature(getattr(tpipe.MusevPipeline, method)).parameters.items()
            if p.default is not inspect.Parameter.empty}
    assert port == jax_kw


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
                   lambda gen, shape, device=None, **kw: torch.from_numpy(
                       draw("torch", shape).copy()).to(device))
        yield


IMAGE = np.random.default_rng(2).uniform(0, 255, (1, 1, 32, 32, 3)).astype(np.float32)
BASE = dict(height=32, width=32, video_length=4, n_batch=2, condition_images=IMAGE,
            video_num_inference_steps=2, num_inference_steps=4, context_frames=4,
            context_overlap=0, seed=3)


@pytest.fixture(scope="module")
def pipes():
    k = jax.random.PRNGKey(3)
    j = dict(unet=init_unet3d(jax.random.fold_in(k, 0), JUNetConfig(**TINY_UNET)),
             vae=init_vae(jax.random.fold_in(k, 1), JVAEConfig(**TINY_VAE)),
             text=init_clip_text(jax.random.fold_in(k, 2), JCLIPConfig(**TINY_CLIP)))
    jmodels = jpipe.MusevModels(
        unet_params=j["unet"], unet_cfg=JUNetConfig(**TINY_UNET), vae_params=j["vae"],
        vae_cfg=JVAEConfig(**TINY_VAE), text_params=j["text"], text_cfg=JCLIPConfig(**TINY_CLIP),
        tokenizer=JHashTokenizer(vocab_size=1000))
    unet, vae = UNet3D(UNet3DConfig(**TINY_UNET)), AutoencoderKL(VAEConfig(**TINY_VAE))
    clip = CLIPTextModel(CLIPTextConfig(**TINY_CLIP))
    unet.load_state_dict(convert.unet3d_from_jax(j["unet"], unet.cfg), strict=True)
    vae.load_state_dict(convert.vae_from_jax(j["vae"], vae.cfg), strict=True)
    clip.load_state_dict(convert.clip_text_from_jax(j["text"], clip.cfg), strict=True)
    port = tpipe.MusevModels(unet=unet.eval(), vae=vae.eval(), text_encoder=clip.eval(),
                             tokenizer=HashTokenizer(vocab_size=1000))
    jp, tp = jpipe.MusevPipeline(jmodels), tpipe.MusevPipeline(port)
    with _same_noise(4):
        default = jp.text2video("a cat", **BASE), tp.text2video("a cat", **BASE)
    assert _rel_l2(default[1].latents, default[0].latents) <= LOOP_REL_L2
    return jp, tp, default


@pytest.mark.parametrize("kw,raises", [
    # read only under a branch that is off: the clip stays as it is
    (dict(redraw_strength=0.3), None),
    (dict(controlnet_conditioning_scale=0.5), None),
    (dict(ip_adapter_face_scale=0.2), None),
    (dict(video_overlap=3), None),
    # the branch itself, with a value under it: the JAX clip, or, where the
    # preset lacks the branch (no ControlNet, no FaceID), the clip as it is
    (dict(redraw_condition_image=True, redraw_strength=0.3), "runs"),
    (dict(control_images=np.zeros((1, 9, 32, 32, 3)), controlnet_conditioning_scale=0.5), None),
    (dict(face_emb=np.ones((1, 512)), ip_adapter_face_scale=0.2), None),
    (dict(record_mid_video=True, video_overlap=3), "runs"),
    (dict(guidance_rescale=0.7), "runs"),
    (dict(no_such_option=1), TypeError),
])
def test_text2video_keywords_under_their_branches(pipes, kw, raises):
    jp, tp, (j_default, t_default) = pipes
    if raises is TypeError:
        with pytest.raises(TypeError, match="no_such_option"):
            tp.text2video("a cat", **BASE, **kw)
        return
    with _same_noise(4):
        want = jp.text2video("a cat", **BASE, **kw)
        got = tp.text2video("a cat", **BASE, **kw)
    assert _rel_l2(got.latents, want.latents) <= LOOP_REL_L2
    if raises is None:  # inert in both packages
        np.testing.assert_array_equal(want.latents, j_default.latents)
        np.testing.assert_array_equal(got.latents, t_default.latents)
        np.testing.assert_array_equal(got.videos, t_default.videos)
    else:  # the branch acts
        assert _rel_l2(got.latents, t_default.latents) > 100 * LOOP_REL_L2
    if kw.get("record_mid_video"):
        assert got.mid_video_latents.shape == want.mid_video_latents.shape == (3, 1, 3, 4, 4, 4)
        assert _rel_l2(got.mid_video_latents, want.mid_video_latents) <= LOOP_REL_L2
