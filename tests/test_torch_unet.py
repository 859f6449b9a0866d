"""The port's UNet blocks, UNet3D, VAE and CLIP against the JAX package.

Both sides get the same weights: a JAX param tree from the package's own
``init_*``, carried over by ``musev_torch.models.convert``. Inputs come from
a seeded numpy RNG, everything runs in float32 on the CPU. Tolerances:
module level 1e-5 relative (float32 rounding in another summation order),
whole UNet 1e-4 (the differences compound through ~60 layers).
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
from musev_tpu.models.clip_text import clip_text_encode as j_clip_encode
from musev_tpu.models.clip_text import init_clip_text
from musev_tpu.models.unet3d import UNet3DConfig as JUNetConfig
from musev_tpu.models.unet3d import init_unet3d, unet3d_apply as j_unet3d_apply
from musev_tpu.models.unet3d import musev_config as j_musev_config
from musev_tpu.models.vae import VAEConfig as JVAEConfig
from musev_tpu.models.vae import init_vae, vae_decode as j_vae_decode
from musev_tpu.models.vae import vae_encode as j_vae_encode
from musev_torch.models import convert
from musev_torch.models.clip_text import CLIPTextConfig, CLIPTextModel, clip_text_encode
from musev_torch.models.unet3d import UNet3D, UNet3DConfig, musev_config, unet3d_apply
from musev_torch.models.unet_blocks import reference_self_attention
from musev_torch.models.vae import AutoencoderKL, VAEConfig, vae_decode, vae_encode


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
MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
UNET_TOL = dict(rtol=1e-4, atol=1e-4)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _port(module_cls, cfg, state):
    m = module_cls(cfg)
    m.load_state_dict(state, strict=True)
    return m.eval()


@pytest.fixture(scope="module")
def unets():
    params = init_unet3d(jax.random.PRNGKey(0), JUNetConfig(**TINY_UNET))
    cfg = UNet3DConfig(**TINY_UNET)
    # randomize the zero-initialised sites too, so every path is exercised
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape, dtype=np.float32),
        params,
    )
    return params, _port(UNet3D, cfg, convert.unet3d_from_jax(params, cfg))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_resnet_block_matches_jax(unets):
    params, unet = unets
    x, temb = _rand(2, 3, 8, 8, 16), _rand(3, 3, 64)
    p = params["up_blocks"][3]["layers"][0]["resnet"]  # 16+16 -> 16 with shortcut
    xin = np.concatenate([x, x[..., ::-1]], axis=-1)
    want = jblk.resnet_block(p, jnp.asarray(xin), jnp.asarray(temb), groups=8)
    got = unet.up_blocks[3].resnets[0](_t(xin), _t(temb))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **MODULE_TOL)


@pytest.mark.parametrize("do_cfg", [True, False])
def test_reference_self_attention_matches_jax(unets, do_cfg):
    params, unet = unets
    t = 4
    norm_h = _rand(4, 2 * t, 16, 16)  # (B*T, HW, C), B = 2
    p = params["down_blocks"][0]["layers"][0]["attn"]["block"]["attn1"]
    want = jblk.reference_self_attention(p, jnp.asarray(norm_h), heads=4, num_frames=t,
                                         cond_index=(0,), do_cfg=do_cfg)
    attn = unet.down_blocks[0].attentions[0].transformer_blocks[0].attn1
    got = reference_self_attention(attn, _t(norm_h), num_frames=t, cond_index=(0,),
                                   do_cfg=do_cfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **MODULE_TOL)


@pytest.mark.parametrize("t", [5, 8])  # JAX pads 5 -> 8 frames and masks; the port does not
def test_temporal_transformer_matches_jax(unets, t):
    params, unet = unets
    x, femb = _rand(5, 2 * t, 4, 4, 16), _rand(6, 2, t, 64)
    p = params["down_blocks"][0]["layers"][0]["temp_attn"]
    want = jblk.temporal_transformer(p, jnp.asarray(x), jnp.asarray(femb), num_frames=t,
                                     heads=4, groups=8)
    got = unet.down_blocks[0].temp_attentions[0](_t(x), _t(femb), num_frames=t)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **MODULE_TOL)


def test_temporal_conv_layer_matches_jax(unets):
    params, unet = unets
    x = _rand(7, 2 * 5, 4, 4, 16)
    p = params["down_blocks"][0]["layers"][0]["temp_conv"]
    want = jblk.temporal_conv_layer(p, jnp.asarray(x), num_frames=5, groups=8)
    got = unet.down_blocks[0].temp_convs[0](_t(x), num_frames=5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **MODULE_TOL)


# the options the referencenet preset flips (its ReferenceNet/IP branches are
# held in test_torch_referencenet.py) plus real AdaIN; they add no
# parameters, so the same weights serve
FLAGS = dict(use_anivv1_cfg=True, resnet_skip_time_act=True, keep_vision_condition=True,
             keep_content_condition=True, adain_fix=True)


@pytest.mark.parametrize("skip_temporal,flags", [(False, {}), (True, {}), (False, FLAGS)])
def test_unet3d_apply_matches_jax(unets, skip_temporal, flags):
    params, unet = unets
    cfg = JUNetConfig(**TINY_UNET, **flags)
    if flags:
        state = unet.state_dict()
        unet = UNet3D(UNet3DConfig(**TINY_UNET, **flags)).eval()
        unet.load_state_dict(state, strict=True)
    t_gen = 1 if skip_temporal else 3
    sample = _rand(8, 2, t_gen, 8, 8, 4)
    cond = None if skip_temporal else _rand(9, 2, 1, 8, 8, 4)
    text = _rand(10, 2, 7, 24)
    kw = dict(do_cfg=True, skip_temporal=skip_temporal)
    if cond is not None:
        kw.update(gen_index=tuple(range(1, 1 + t_gen)), cond_index=(0,))
    want = j_unet3d_apply(params, cfg, jnp.asarray(sample), jnp.asarray(641.0),
                          jnp.asarray(text),
                          condition_latents=None if cond is None else jnp.asarray(cond), **kw)
    with torch.no_grad():
        got = unet3d_apply(unet, _t(sample), 641.0, _t(text),
                           condition_latents=None if cond is None else _t(cond), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **UNET_TOL)


def test_vae_matches_jax():
    jcfg, cfg = JVAEConfig(**TINY_VAE), VAEConfig(**TINY_VAE)
    params = init_vae(jax.random.PRNGKey(2), jcfg)
    vae = _port(AutoencoderKL, cfg, convert.vae_from_jax(params, cfg))
    img = np.tanh(_rand(11, 2, 16, 16, 3))
    lat = _rand(12, 2, 2, 2, 4)
    with torch.no_grad():
        enc = vae_encode(vae, _t(img)).numpy()
        dec = vae_decode(vae, _t(lat)).numpy()
    np.testing.assert_allclose(enc, np.asarray(j_vae_encode(params, jcfg, jnp.asarray(img))),
                               **MODULE_TOL)
    np.testing.assert_allclose(dec, np.asarray(j_vae_decode(params, jcfg, jnp.asarray(lat))),
                               **MODULE_TOL)


def test_clip_text_matches_jax():
    jcfg, cfg = JCLIPConfig(**TINY_CLIP), CLIPTextConfig(**TINY_CLIP)
    params = init_clip_text(jax.random.PRNGKey(3), jcfg)
    clip = _port(CLIPTextModel, cfg, convert.clip_text_from_jax(params, cfg))
    ids = np.random.default_rng(4).integers(0, 1000, (2, 77))
    want = j_clip_encode(params, jcfg, jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        got = clip_text_encode(clip, torch.as_tensor(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)


def _jax_keys(key_map, init, cfg):
    tree = jax.eval_shape(partial(init, jax.random.PRNGKey(0), cfg))
    return set(jsw.export_key_names(list(key_map(cfg)), tree))


def _meta_keys(module_cls, cfg):
    with torch.device("meta"):
        return set(module_cls(cfg).state_dict())


@pytest.mark.parametrize("full", [False, True])
def test_state_dict_keys_match_reference_keys(full):
    """The port's module names are the reference torch keys, for the tiny
    test config and the full ``musev`` preset (built on the meta device)."""
    if full:
        pairs = [(j_musev_config(), musev_config()), (JVAEConfig(), VAEConfig()),
                 (JCLIPConfig(), CLIPTextConfig())]
    else:
        pairs = [(JUNetConfig(**TINY_UNET), UNet3DConfig(**TINY_UNET)),
                 (JVAEConfig(**TINY_VAE), VAEConfig(**TINY_VAE)),
                 (JCLIPConfig(**TINY_CLIP), CLIPTextConfig(**TINY_CLIP))]
    for (jcfg, cfg), km, init, cls in zip(
        pairs,
        (jsw.unet3d_key_map, jsw.vae_key_map, jsw.clip_text_key_map),
        (init_unet3d, init_vae, init_clip_text),
        (UNet3D, AutoencoderKL, CLIPTextModel),
    ):
        assert _meta_keys(cls, cfg) == _jax_keys(km, init, jcfg)


def test_unet_config_refuses_unported_options():
    """Every option of the JAX ``UNet3DConfig`` is ported now (FaceID, the
    spatial position embedding and the sparse-causal temporal mask last),
    with the JAX defaults; what the JAX config lacks is still refused, and
    so is an unknown mask name."""
    import dataclasses

    jfields = {f.name: f.default for f in dataclasses.fields(JUNetConfig)}
    fields = {f.name: f.default for f in dataclasses.fields(UNet3DConfig)}
    assert fields == jfields
    cfg = UNet3DConfig(**TINY_UNET, need_ip_adapter_face=True, need_spatial_position_emb=True,
                       temporal_self_attn_mask="sparse_causal")
    assert cfg.need_ip_adapter_face and cfg.need_spatial_position_emb
    with pytest.raises(TypeError):
        UNet3DConfig(**TINY_UNET, no_such_option=True)
    unet = UNet3D(UNet3DConfig(**TINY_UNET, temporal_self_attn_mask="causal")).eval()
    with pytest.raises(ValueError, match="sparse_causal"):
        unet3d_apply(unet, torch.zeros(1, 2, 8, 8, 4), 1.0, torch.zeros(1, 7, 24))


@pytest.fixture(scope="module")
def spatial_unets():
    """A narrow UNet with the spatial position embedding (every temporal
    transformer's ``spatial_emb_proj`` and the UNet's
    ``spatial_position_embedding``), weights perturbed as ``unets``."""
    jcfg = JUNetConfig(**TINY_UNET, need_spatial_position_emb=True)
    params = init_unet3d(jax.random.PRNGKey(5), jcfg)
    rng = np.random.default_rng(6)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape, dtype=np.float32),
        params,
    )
    cfg = UNet3DConfig(**TINY_UNET, need_spatial_position_emb=True)
    state = convert.unet3d_from_jax(params, cfg)
    assert "spatial_position_embedding.linear_2.weight" in state
    assert "down_blocks.0.temp_attentions.0.spatial_emb_proj.weight" in state
    return params, _port(UNet3D, cfg, state)


@pytest.mark.parametrize("mask,n_near,norm_length", [
    ("sparse_causal", 1, False), ("sparse_causal_near", 2, True), (None, 1, False)])
def test_unet3d_sparse_causal_mask_and_spatial_emb_match_jax(spatial_unets, mask, n_near,
                                                             norm_length):
    """Item 11: the sparse-causal mask on both temporal attentions (the JAX
    package pads 4 frames to 8 under its mask; the port masks the 4) and
    the spatial position embedding, on converted weights."""
    params, unet = spatial_unets
    flags = dict(need_spatial_position_emb=True, temporal_self_attn_mask=mask,
                 temporal_attn_n_near=n_near, norm_spatial_length=norm_length,
                 spatial_max_length=64)
    cfg = JUNetConfig(**TINY_UNET, **flags)
    port = UNet3D(UNet3DConfig(**TINY_UNET, **flags)).eval()
    port.load_state_dict(unet.state_dict(), strict=True)
    sample, cond, text = _rand(13, 2, 3, 8, 8, 4), _rand(14, 2, 1, 8, 8, 4), _rand(15, 2, 7, 24)
    kw = dict(do_cfg=True, gen_index=(1, 2, 3), cond_index=(0,))
    want = j_unet3d_apply(params, cfg, jnp.asarray(sample), jnp.asarray(641.0),
                          jnp.asarray(text), condition_latents=jnp.asarray(cond), **kw)
    with torch.no_grad():
        got = unet3d_apply(port, _t(sample), 641.0, _t(text), condition_latents=_t(cond), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **UNET_TOL)
    if mask is not None:  # the mask changes the call (future frames are cut off)
        with torch.no_grad():
            free = unet3d_apply(unet, _t(sample), 641.0, _t(text), condition_latents=_t(cond),
                                **kw)
        assert np.abs(free.numpy() - got.numpy()).max() > 1e-4


def test_sparse_causal_mask_and_sincos_grid_are_the_jax_copies():
    from musev_tpu.models.embeddings import get_2d_sincos_pos_embed as j_grid
    from musev_tpu.ops.attention_mask import sparse_causal_mask as j_mask
    from musev_torch.models.embeddings import get_2d_sincos_pos_embed
    from musev_torch.ops.attention_mask import sparse_causal_mask

    for t, n, first in ((5, 1, True), (13, 2, False), (1, 1, True)):
        np.testing.assert_array_equal(sparse_causal_mask(t, n, first), j_mask(t, n, first))
    for args in ((32, 9, 9, False, 2048), (40, 4, 6, True, 2048), (8, 5, 3, True, 4)):
        np.testing.assert_array_equal(get_2d_sincos_pos_embed(*args), j_grid(*args))
