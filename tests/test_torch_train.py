"""The port's training (``musev_torch.train``) against the JAX package's.

Both sides get the same weights (the JAX package's ``init_*`` trees with every
leaf redrawn as init + N(0, 0.05), so zero-initialised sites and the 1e-5
temporal weights do not hide their branches, carried over by
``musev_torch.models.convert``), the same latents and text from a seeded
numpy RNG, and JAX's own timestep and noise draws (the port takes them as
``timesteps=`` and ``noise=``). JAX's grads map onto the port's params
through the same converter. The JAX side is computed once, in one
module-scoped fixture (``jax.grad`` of a UNet compiles slowly on the CPU),
without ``jax.checkpoint`` (it changes no value). float32 on the CPU.

Tolerances, each per param (relative L2, plus 1e-7 absolute for grads that
vanish, such as a self-attention's q and k over one token), set from the
gaps measured on these inputs with about a 2x margin. The loss within
relative 1e-5. Each float32 grad within 1e-3 of the port's own float64
run (5e-3 for a scalar param, a temporal weight, whose grad sums over the
whole clip and cancels): float32 rounding through the UNet and its
backward, measured up to 2.1e-4 (1.5e-3 for a scalar) at n_vision_cond 0.
Each grad within 3e-3 of ``jax.grad``'s (3e-2 for a scalar): the JAX
package's GroupNorm takes the variance in one pass, E[x^2] - E[x]^2 in
float32 (musev_tpu/models/common.py:166-174), which cancels and puts its
float32 grads up to 1.4e-3 (1.4e-2 for a scalar) from the port's. ``test_jax_grads_with_a_two_pass_group_norm_match_float64`` shows
it: with that one formula replaced by a two-pass variance for the test,
JAX's float32 grads sit within 1e-4 of the port's float64 ones per param.
The params' change over the steps against JAX's, all of a module's
together within relative L2 1e-2 and each param within its step limit:
one SGD step at 1.0, 1e-2 (measured 4.0e-3: a param that moves some 27
float32 ulps carries its rounding); two ``train_step_opt`` steps, 1e-1
(3e-2 for a scalar; measured 4.1e-2 under AdamW, whose first update is
lr * sign(g) per element, so an element whose grad is near zero in both
packages may step either way, and 3.2e-2 under SGD at 0.1, where a param
moves some 3 ulps); the super step at 1.0, 2e-2 (measured 6.3e-3). The
loss after a step within relative 1e-3. ``grad_checkpoint`` on against off:
bit for bit.

JAX compiles one ``value_and_grad`` per loss (slow on the CPU), and one
more for the two-pass GroupNorm; the JAX steps are the package's own step
bodies (``train_step``, ``train_step_opt`` with ``make_optimizer``'s optax
chain, ``super_train_step``) applied to those grads, so no step compiles
the loss again.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import musev_tpu.models.common as jcommon
import musev_tpu.models.unet3d as junet3d
import musev_tpu.models.unet_blocks as jblocks
import musev_tpu.train as jtrain
from musev_tpu.models.controlnet import ControlNetConfig as JCNConfig
from musev_tpu.models.controlnet import init_controlnet
from musev_tpu.models.ip_adapter import init_image_proj
from musev_tpu.models.referencenet import ReferenceNetConfig as JRefConfig
from musev_tpu.models.referencenet import init_referencenet
from musev_tpu.models.unet3d import UNet3DConfig as JUNetConfig
from musev_tpu.models.unet3d import init_unet3d
from musev_tpu.models.unet3d import musev_referencenet_config as j_ref_config
from musev_tpu.ops.noise import video_fusion_noise as j_video_fusion_noise
from musev_torch import train
from musev_torch.models import convert
from musev_torch.models.controlnet import ControlNet, ControlNetConfig
from musev_torch.models.ip_adapter import ImageProjModel
from musev_torch.models.referencenet import ReferenceNet2D, ReferenceNetConfig
from musev_torch.models.unet3d import UNet3D, UNet3DConfig, musev_referencenet_config


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: torch's OpenMP pool spun
    against the suite's other xdist workers. Restored after, as the setting
    is the process's and JAX shares it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# tests/test_train.py's and tests/test_super_train.py's configs
TINY = dict(block_out_channels=(16, 16, 32, 32), layers_per_block=1,
            cross_attention_dim=16, attention_heads=4, norm_num_groups=8)
SUPER = dict(block_out_channels=(8, 8, 16, 16), layers_per_block=1, cross_attention_dim=16,
             attention_heads=4, norm_num_groups=4)
SUPER_CN = dict(SUPER, cond_embed_channels=(4, 4, 4, 4))
LOSS_RTOL, STEP_LOSS_RTOL = 1e-5, 1e-3
GRAD_ATOL = 1e-7
# per param: (relative L2, relative L2 for a scalar param)
FP64_TOL, JAX_TOL, TWO_PASS_TOL = (1e-3, 5e-3), (3e-3, 3e-2), (1e-4, 1e-4)
SGD_STEP_TOL, OPT_STEP_TOL, SUPER_STEP_TOL = (1e-2, 1e-2), (1e-1, 3e-2), (2e-2, 2e-2)
STEP_REL_L2 = 1e-2  # the change of all a module's params together
SGD_LR, OPT_SGD_LR, ADAMW_LR, CLIP_NORM = 1.0, 0.1, 1e-2, 1e-2
KEY = 3


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _redraw(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a), dtype=np.float32),
        params)


def _draws(batch_shape, n_vc, key=KEY):
    """The timesteps and noise JAX's losses draw from ``key`` (train.py:59-65)."""
    b, t = batch_shape[:2]
    k_t, k_n = jax.random.split(jax.random.PRNGKey(key))
    ts = jax.random.randint(k_t, (b,), 0, 1000)
    noise = j_video_fusion_noise(k_n, (b, t - n_vc, *batch_shape[2:]), w_ind_noise=0.5,
                                 dtype=jnp.float32)
    return dict(timesteps=torch.from_numpy(np.asarray(ts)),
                noise=torch.from_numpy(np.asarray(noise)))


def _unet(params, cfg):
    unet = UNet3D(cfg)
    unet.load_state_dict(convert.unet3d_from_jax(params, cfg), strict=True)
    return unet


def _inputs():
    return _rand(1, 2, 4, 4, 4, 4), _rand(2, 2, 5, 16)


def _super_batch():
    rng = np.random.default_rng(4)
    return dict(latents=_rand(5, 2, 4, 4, 4, 4), text_emb=_rand(6, 2, 5, 16),
                refer_latents=_rand(7, 2, 4, 4, 4), clip_pooled=_rand(8, 2, 12),
                control_images=rng.uniform(0, 1, (2, 4, 32, 32, 3)).astype(np.float32))


def _two_pass_group_norm(p, x, num_groups=32, eps=1e-5):
    """The JAX package's ``group_norm`` (float32 stats over every axis but
    the first and the channels) with the variance taken in two passes,
    E[(x - E[x])^2], in place of its one-pass E[x^2] - E[x]^2."""
    n, c = x.shape[0], x.shape[-1]
    xf = x.astype(jnp.float32).reshape(n, -1, num_groups, c // num_groups)
    mean = xf.mean(axis=(1, 3), keepdims=True)
    var = jnp.square(xf - mean).mean(axis=(1, 3), keepdims=True)
    y = ((xf - mean) * jax.lax.rsqrt(var + eps)).reshape(x.shape)
    return (y * p["scale"].astype(jnp.float32) + p["bias"].astype(jnp.float32)).astype(x.dtype)


@pytest.fixture(scope="module")
def jax_side():
    """Every JAX result the file compares with, computed once: one jitted
    ``value_and_grad`` per loss (n_vision_cond 1 and 0, the super bundle's),
    and the JAX package's step bodies applied to its grads."""
    cfg = JUNetConfig(**TINY)
    params = _redraw(init_unet3d(jax.random.PRNGKey(0), cfg), 0)
    latents, text = (jnp.asarray(x) for x in _inputs())
    key = jax.random.PRNGKey(KEY)
    out = dict(params=params)
    loss_and_grads = jax.jit(jax.value_and_grad(jtrain.diffusion_loss), static_argnums=1)
    for n_vc in (0, 1):
        spec = jtrain.TrainSpec(unet_cfg=cfg, n_vision_cond=n_vc, grad_checkpoint=False)
        out[f"loss{n_vc}"], out[f"grads{n_vc}"] = loss_and_grads(params, spec, latents, text, key)
    spec = jtrain.TrainSpec(unet_cfg=cfg, grad_checkpoint=False)
    with pytest.MonkeyPatch.context() as mp:
        for module in (jcommon, jblocks, junet3d):
            mp.setattr(module, "group_norm", _two_pass_group_norm)
        _, out["grads1_two_pass"] = jax.jit(jax.value_and_grad(jtrain.diffusion_loss),
                                            static_argnums=1)(params, spec, latents, text, key)

    def grads_at(p):
        return loss_and_grads(p, spec, latents, text, key)

    # train_step (train.py:226-236): p - lr * g
    out["sgd_step"] = (jax.tree_util.tree_map(lambda p, g: p - SGD_LR * g, params,
                                              out["grads1"]), out["loss1"])
    # train_step_opt (train.py:264-279): optax's update of make_optimizer(spec)
    for name, lr in (("adamw", ADAMW_LR), ("sgd", OPT_SGD_LR)):
        ospec = jtrain.TrainSpec(unet_cfg=cfg, grad_checkpoint=False, optimizer=name,
                                 learning_rate=lr, max_grad_norm=CLIP_NORM)
        tx = jtrain.make_optimizer(ospec)
        p, state, losses = params, tx.init(params), []
        for _ in range(2):
            loss, grads = grads_at(p)
            updates, state = tx.update(grads, state, p)
            p = jax.tree_util.tree_map(lambda p_, u: p_ + u, p, updates)
            losses.append(float(loss))
        out[f"opt_{name}"] = (p, losses)

    ucfg = j_ref_config(**SUPER, ip_adapter_dim=16)
    rcfg, ccfg = JRefConfig(**SUPER), JCNConfig(**SUPER_CN)
    k = jax.random.PRNGKey(0)
    bundle = {
        "unet": _redraw(init_unet3d(jax.random.fold_in(k, 0), ucfg), 1),
        "referencenet": _redraw(init_referencenet(jax.random.fold_in(k, 1), rcfg), 2),
        "controlnet": _redraw(init_controlnet(jax.random.fold_in(k, 2), ccfg), 3),
        "ip_proj": _redraw(init_image_proj(jax.random.fold_in(k, 3), clip_dim=12, cross_dim=16,
                                           num_tokens=4), 4),
    }
    sspec = jtrain.SuperTrainSpec(unet_cfg=ucfg, referencenet_cfg=rcfg, controlnet_cfg=ccfg,
                                  learning_rate=SGD_LR)
    batch = {k_: jnp.asarray(v) for k_, v in _super_batch().items()}
    loss, grads = jax.jit(jax.value_and_grad(jtrain.super_diffusion_loss), static_argnums=1)(
        bundle, sspec, batch, key)
    out["super_bundle"] = bundle
    # super_train_step (train.py:208-215): p - lr * g over the bundle
    out["super_step"] = (jax.tree_util.tree_map(lambda p, g: p - SGD_LR * g, bundle, grads),
                         loss)
    return out


def _assert_each(got: dict, want: dict, tol) -> None:
    """Each param's tensor in ``got`` within relative L2 ``tol[0]`` (plus
    GRAD_ATOL) of ``want``'s, a scalar param's within ``tol[1]``; a missing
    grad (None) counts as zeros."""
    assert set(got) == set(want)
    bad = {}
    for name, w in want.items():
        w = w.double().numpy()
        g = np.zeros_like(w) if got[name] is None else got[name].double().numpy()
        rel = tol[0] if w.size > 1 else tol[1]
        if np.linalg.norm(g - w) > rel * np.linalg.norm(w) + GRAD_ATOL:
            bad[name] = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
    assert not bad, bad


def _jax_grads(grads, cfg) -> dict:
    return {n: torch.from_numpy(np.asarray(g)) for n, g in
            convert.unet3d_from_jax(grads, cfg).items()}


@pytest.fixture(scope="module")
def float64_grads(jax_side):
    """n_vision_cond -> the port's grads in float64 on the fixture's
    params, inputs and JAX draws, each computed once."""
    cfg = UNet3DConfig(**TINY)
    latents, text = (torch.from_numpy(x).double() for x in _inputs())

    @functools.cache
    def grads(n_vc: int) -> dict:
        unet = _unet(jax_side["params"], cfg).double()
        spec = train.TrainSpec(unet_cfg=cfg, n_vision_cond=n_vc)
        train.diffusion_loss(unet, spec, latents, text,
                             **_draws(latents.shape, n_vc)).backward()
        return {n: p.grad for n, p in unet.named_parameters()}

    return grads


def _assert_step(module, before: dict, want_after: dict, tol) -> None:
    """The params' change against JAX's: all together within STEP_REL_L2,
    and each param as ``_assert_each``."""
    got = {n: p.detach() - before[n] for n, p in module.named_parameters()}
    want = {n: want_after[n] - before[n] for n in got}
    flat_got, flat_want = (torch.cat([d[n].double().ravel() for n in got]) for d in (got, want))
    assert flat_want.norm() > 0
    err = ((flat_got - flat_want).norm() / flat_want.norm()).item()
    assert err <= STEP_REL_L2, err
    _assert_each(got, want, tol)


@pytest.mark.parametrize("n_vc", [0, 1])
def test_diffusion_loss_and_grads_match_jax(jax_side, float64_grads, n_vc):
    cfg = UNet3DConfig(**TINY)
    unet = _unet(jax_side["params"], cfg)
    latents, text = (torch.from_numpy(x) for x in _inputs())
    spec = train.TrainSpec(unet_cfg=cfg, n_vision_cond=n_vc)
    loss = train.diffusion_loss(unet, spec, latents, text, **_draws(latents.shape, n_vc))
    np.testing.assert_allclose(loss.item(), float(jax_side[f"loss{n_vc}"]), rtol=LOSS_RTOL)
    loss.backward()
    grads = {n: p.grad for n, p in unet.named_parameters()}
    _assert_each(grads, _jax_grads(jax_side[f"grads{n_vc}"], cfg), JAX_TOL)
    _assert_each(grads, float64_grads(n_vc), FP64_TOL)


def test_jax_grads_with_a_two_pass_group_norm_match_float64(jax_side, float64_grads):
    """The gap between JAX's grads and the port's is the JAX GroupNorm's
    one-pass variance: with a two-pass one, JAX's float32 grads sit within
    1e-4 of the port's float64 grads, per param (n_vision_cond 1)."""
    cfg = UNet3DConfig(**TINY)
    _assert_each(_jax_grads(jax_side["grads1_two_pass"], cfg), float64_grads(1), TWO_PASS_TOL)


def test_train_step_matches_jax(jax_side):
    cfg = UNet3DConfig(**TINY)
    unet = _unet(jax_side["params"], cfg)
    before = {n: p.detach().clone() for n, p in unet.named_parameters()}
    latents, text = (torch.from_numpy(x) for x in _inputs())
    spec = train.TrainSpec(unet_cfg=cfg, learning_rate=SGD_LR)
    loss = train.train_step(unet, spec, latents, text, **_draws(latents.shape, 1))
    want_params, want_loss = jax_side["sgd_step"]
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    _assert_step(unet, before, convert.unet3d_from_jax(want_params, cfg), SGD_STEP_TOL)


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_two_train_step_opt_steps_match_optax(jax_side, optimizer):
    """Two steps on one batch and one draw, as tests/test_train.py takes
    them; AdamW's grads clip (their global norm is far above CLIP_NORM)."""
    cfg = UNet3DConfig(**TINY)
    unet = _unet(jax_side["params"], cfg)
    before = {n: p.detach().clone() for n, p in unet.named_parameters()}
    latents, text = (torch.from_numpy(x) for x in _inputs())
    lr = ADAMW_LR if optimizer == "adamw" else OPT_SGD_LR
    spec = train.TrainSpec(unet_cfg=cfg, optimizer=optimizer, learning_rate=lr,
                           max_grad_norm=CLIP_NORM)
    opt = train.make_optimizer(spec, unet.parameters())
    draws = _draws(latents.shape, 1)
    losses = [train.train_step_opt(unet, opt, spec, latents, text, **draws).item()
              for _ in range(2)]
    grad_norm = np.sqrt(sum(float(jnp.sum(g * g)) for g in
                            jax.tree_util.tree_leaves(jax_side["grads1"])))
    assert grad_norm > 10 * CLIP_NORM
    want_params, want_losses = jax_side[f"opt_{optimizer}"]
    assert losses[0] == pytest.approx(want_losses[0], rel=LOSS_RTOL)
    assert losses[1] == pytest.approx(want_losses[1], rel=STEP_LOSS_RTOL)
    _assert_step(unet, before, convert.unet3d_from_jax(want_params, cfg), OPT_STEP_TOL)


def test_super_train_step_matches_jax(jax_side):
    j_bundle = jax_side["super_bundle"]
    ucfg = musev_referencenet_config(**SUPER, ip_adapter_dim=16)
    rcfg, ccfg = ReferenceNetConfig(**SUPER), ControlNetConfig(**SUPER_CN)
    bundle = {"unet": _unet(j_bundle["unet"], ucfg),
              "referencenet": ReferenceNet2D(rcfg), "controlnet": ControlNet(ccfg),
              "ip_proj": ImageProjModel(clip_dim=12, cross_dim=16, num_tokens=4)}
    conv = {"unet": lambda p: convert.unet3d_from_jax(p, ucfg),
            "referencenet": lambda p: convert.referencenet_from_jax(p, rcfg),
            "controlnet": lambda p: convert.controlnet_from_jax(p, ccfg),
            "ip_proj": convert.image_proj_from_jax}
    for name in ("referencenet", "controlnet", "ip_proj"):
        bundle[name].load_state_dict(conv[name](j_bundle[name]), strict=True)
    before = {name: {n: p.detach().clone() for n, p in m.named_parameters()}
              for name, m in bundle.items()}
    batch = {k: torch.from_numpy(v) for k, v in _super_batch().items()}
    spec = train.SuperTrainSpec(unet_cfg=ucfg, referencenet_cfg=rcfg, controlnet_cfg=ccfg,
                                learning_rate=SGD_LR)
    loss = train.super_train_step(bundle, spec, batch,
                                  **_draws(batch["latents"].shape, 1))
    want_bundle, want_loss = jax_side["super_step"]
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    for name, module in bundle.items():
        _assert_step(module, before[name], conv[name](want_bundle[name]), SUPER_STEP_TOL)


def test_grad_checkpoint_on_and_off_are_bit_for_bit(jax_side):
    cfg = UNet3DConfig(**TINY)
    latents, text = (torch.from_numpy(x) for x in _inputs())
    draws = _draws(latents.shape, 1)
    results = []
    for on in (True, False):
        unet = _unet(jax_side["params"], cfg)
        spec = train.TrainSpec(unet_cfg=cfg, grad_checkpoint=on)
        loss = train.diffusion_loss(unet, spec, latents, text, **draws)
        loss.backward()
        results.append((loss, {n: p.grad for n, p in unet.named_parameters()}))
    (loss_on, grads_on), (loss_off, grads_off) = results
    assert torch.equal(loss_on, loss_off)
    assert all(torch.equal(grads_on[n], grads_off[n]) for n in grads_off)


def test_train_step_opt_zero_grads_what_the_loss_misses(jax_side):
    """A param outside the loss gets a zero grad, so AdamW decays it, as
    optax does with the JAX package's zero grads (train.py:270-273)."""
    cfg = UNet3DConfig(**TINY)
    unet = _unet(jax_side["params"], cfg)
    extra = torch.nn.Parameter(torch.ones(3))
    spec = train.TrainSpec(unet_cfg=cfg, learning_rate=ADAMW_LR)
    opt = train.make_optimizer(spec, [*unet.parameters(), extra])
    latents, text = (torch.from_numpy(x) for x in _inputs())
    train.train_step_opt(unet, opt, spec, latents, text, torch.Generator().manual_seed(0))
    assert torch.equal(extra.grad, torch.zeros(3))
    np.testing.assert_allclose(extra.detach().numpy(), 1.0 - ADAMW_LR * spec.weight_decay,
                               rtol=1e-7)


def test_refusals():
    cfg = UNet3DConfig(**TINY)
    unet = UNet3D(cfg)
    latents, text = (torch.from_numpy(x) for x in _inputs())
    # frame parallelism needs an ambient mesh carrying its axis, as in JAX
    with pytest.raises(ValueError, match="ambient mesh"):
        train.diffusion_loss(unet, train.TrainSpec(unet_cfg=cfg, fp_axis="fp"), latents, text,
                             torch.Generator())
    with pytest.raises(ValueError, match="fp_axis excludes dp_axis"):
        train.diffusion_loss(unet, train.TrainSpec(unet_cfg=cfg, fp_axis="fp", dp_axis="dp"),
                             latents, text, torch.Generator())
    with pytest.raises(ValueError, match="torch.Generator"):
        train.diffusion_loss(unet, train.TrainSpec(unet_cfg=cfg), latents, text)
    with pytest.raises(ValueError, match="unknown optimizer"):
        train.make_optimizer(train.TrainSpec(unet_cfg=cfg, optimizer="lion"), unet.parameters())
    other = UNet3DConfig(**dict(TINY, attention_heads=2))
    with pytest.raises(ValueError, match="unet_cfg"):
        train.diffusion_loss(unet, train.TrainSpec(unet_cfg=other), latents, text,
                             torch.Generator())
