"""The port's serving layer (``musev_torch.serve.app``) against the JAX package's.

The cases of tests/test_serve.py on the same weights (that file's tiny
models, carried over by ``musev_torch.models.convert``) and the same noise:
each pipeline's ``make_noise`` is replaced by the same seeded numpy draws,
call by call (``jax.random`` and ``torch.Generator`` give different numbers).
The port's uint8 frames are held against JAX's: float32 rounding in another
order, compounded over the T2I frame's 30 steps and the clip's 10 video
steps and rounded to uint8, moves a frame by a grey level or two. The guards
(``limit_shape``, ``limit_length``) and the host helpers must equal JAX's
exactly.
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
from musev_tpu.models.unet3d import UNet3DConfig as JUNetConfig
from musev_tpu.models.unet3d import init_unet3d
from musev_tpu.models.vae import VAEConfig as JVAEConfig
from musev_tpu.models.vae import init_vae
from musev_tpu.serve import app as japp
from musev_tpu.utils.tokenizer import HashTokenizer as JHashTokenizer
from musev_torch.models import convert
from musev_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from musev_torch.models.unet3d import UNet3D, UNet3DConfig
from musev_torch.models.vae import AutoencoderKL, VAEConfig
from musev_torch.serve import app
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


# tests/test_serve.py's models
TINY_UNET = dict(block_out_channels=(16, 16, 32, 32), layers_per_block=1,
                 cross_attention_dim=24, attention_heads=4, norm_num_groups=8)
TINY_VAE = dict(block_out_channels=(16, 16, 32, 32), layers_per_block=1, norm_num_groups=8)
TINY_CLIP = dict(vocab_size=500, hidden_size=24, num_layers=1, num_heads=4,
                 intermediate_size=48)
MAX_GREY, MEAN_GREY = 2, 0.05  # uint8 levels: the largest and the mean difference


@pytest.fixture(scope="module")
def servers():
    k = jax.random.PRNGKey(0)
    jp = dict(unet=init_unet3d(jax.random.fold_in(k, 0), JUNetConfig(**TINY_UNET)),
              vae=init_vae(jax.random.fold_in(k, 1), JVAEConfig(**TINY_VAE)),
              text=init_clip_text(jax.random.fold_in(k, 2), JCLIPConfig(**TINY_CLIP)))
    jmodels = jpipe.MusevModels(
        unet_params=jp["unet"], unet_cfg=JUNetConfig(**TINY_UNET), vae_params=jp["vae"],
        vae_cfg=JVAEConfig(**TINY_VAE), text_params=jp["text"], text_cfg=JCLIPConfig(**TINY_CLIP),
        tokenizer=JHashTokenizer(500))
    unet, vae = UNet3D(UNet3DConfig(**TINY_UNET)), AutoencoderKL(VAEConfig(**TINY_VAE))
    clip = CLIPTextModel(CLIPTextConfig(**TINY_CLIP))
    unet.load_state_dict(convert.unet3d_from_jax(jp["unet"], unet.cfg), strict=True)
    vae.load_state_dict(convert.vae_from_jax(jp["vae"], vae.cfg), strict=True)
    clip.load_state_dict(convert.clip_text_from_jax(jp["text"], clip.cfg), strict=True)
    models = tpipe.MusevModels(unet=unet.eval(), vae=vae.eval(), text_encoder=clip.eval(),
                               tokenizer=HashTokenizer(500))
    return (japp.OnlineInference(jpipe.MusevPipeline(jmodels), time_size=2),
            app.OnlineInference(tpipe.MusevPipeline(models), time_size=2))


@contextlib.contextmanager
def _same_noise(seed=0):
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
                   lambda gen, shape, device=None, **kw: torch.from_numpy(
                       draw("torch", shape).copy()).to(device))
        yield calls


def _both(servers, method, *args, **kwargs):
    """The method's frames from both servers under the same noise."""
    outs = []
    with _same_noise() as calls:
        for server in servers:
            outs.append(getattr(server, method)(*args, **kwargs))
    assert calls["jax"] == calls["torch"] > 0
    return outs


def _assert_frames(got, want):
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= MAX_GREY and diff.mean() <= MEAN_GREY, (diff.max(), diff.mean())


def test_online_t2v(servers):
    img = (np.random.RandomState(0).rand(40, 48, 3) * 255).astype(np.uint8)
    want, got = _both(servers, "online_t2v_inference", "a cat", img, seed=1, w=-1, h=-1,
                      video_length=2, img_edge_ratio=1.0)
    assert got.shape[1:3] == (40, 48)
    _assert_frames(got, want)


def test_online_t2v_no_image(servers):
    want, got = _both(servers, "online_t2v_inference", "a cat", None, seed=0, w=32, h=32,
                      video_length=2)
    assert got.shape[1:3] == (32, 32)
    _assert_frames(got, want)


def test_online_t2v_shot_arithmetic(servers):
    want, got = _both(servers, "online_t2v_inference", "a cat", None, seed=0, w=32, h=32,
                      video_length=3)
    assert got.shape[0] == 1 + 3  # 2 shots of 2 frames and the condition frame, trimmed
    _assert_frames(got, want)


def test_online_v2v_array_input(servers):
    video = (np.random.RandomState(1).rand(4, 32, 32, 3) * 255).astype(np.uint8)
    want, got = _both(servers, "online_v2v_inference", "a robot", None, video, seed=0, w=32,
                      h=32)
    assert got.shape[1:3] == (32, 32)
    _assert_frames(got, want)


def test_online_v2v_path_input(servers, tmp_path):
    from musev_torch.io.video import native_available, write_video

    if not native_available():
        pytest.skip("native video io unavailable")
    video = (np.random.RandomState(2).rand(4, 32, 32, 3) * 255).astype(np.uint8)
    path = str(tmp_path / "src.mp4")
    write_video(path, video, fps=4)
    want, got = _both(servers, "online_v2v_inference", "a robot", None, path, seed=0, w=32,
                      h=32)
    assert got.shape[0] >= 4
    _assert_frames(got, want)


def test_limit_shape_and_length_match_jax():
    image = np.zeros((720, 1280, 3), np.uint8)
    for w, h in ((-1, -1), (576, 576), (1920, 1080), (333, 777), (8, 8), (2000, 64)):
        for ratio in (0, 0.5, 1.0, 1.7, 3.0):
            for edge in (1280, 960):
                assert app.limit_shape(image, w, h, ratio, edge) == \
                    japp.limit_shape(image, w, h, ratio, edge)
    with pytest.raises(ValueError, match="image"):
        app.limit_shape(None, -1, -1, 1.0)
    for length in (0, 1, 5, 11.5, 12, 13, 144, 1000):
        for cap in (144, 48):
            assert app.limit_length(length, cap) == japp.limit_length(length, cap)


def test_read_video_input_forms():
    arr = np.zeros((200, 8, 8, 3), np.uint8)
    assert app.read_video_input(arr, max_frames=144).shape[0] == 144
    assert app.read_video_input([arr, None], max_frames=10).shape[0] == 10


def test_ensure_checkpoints_hook(tmp_path):
    target = tmp_path / "ckpts"
    calls = []

    def downloader(d):
        calls.append(d)
        (target / "model.bin").write_bytes(b"x")

    assert app.ensure_checkpoints(str(target), downloader) == str(target)
    app.ensure_checkpoints(str(target), downloader)
    assert calls == [str(target)]
    with pytest.raises(FileNotFoundError):
        app.ensure_checkpoints(str(tmp_path / "missing"), None)


def test_build_demo_needs_gradio(servers):
    """Without gradio both packages refuse to build the UI, alike."""
    try:
        import gradio  # noqa: F401
    except ImportError:
        pass
    else:
        pytest.skip("gradio is installed: the refusal cannot show")
    for module, server in zip((japp, app), servers):
        with pytest.raises(RuntimeError, match="gradio"):
            module.build_demo(server.pipe)
