"""The port's ring attention, tensor parallelism, window data parallelism,
sharded VAE decode and CLI topology on real gloo process groups of 2 and 4
ranks, against the JAX package.

JAX sides: ``ring_attention`` under ``shard_map`` on a mesh of the same
size; the unsharded ``predict_noise`` for the dp and dp x tp denoise steps
(the JAX package's tests hold its sharded steps to it); ``_tp_spec`` for
every leaf's split dim. Weights are the JAX package's ``init_*`` trees
redrawn as init + N(0, 0.05) and carried over by
``musev_torch.models.convert``; inputs from a seeded numpy RNG; float32 on
the CPU. Tolerances: attention 1e-5 (float32 rounding of another summation
order), a denoise step 2e-4 (atol; rtol 1e-3 as JAX's own dp x tp test),
the sharded VAE decode bit for bit.

Each world size is spawned once for the module (``file://`` rendezvous in a
temporary directory, one torch thread per rank), every case runs in it and
rank 0 saves the results; each test asserts one case. The ranks import this
module, so its top-level imports are torch, numpy and ``musev_torch`` only.
"""

import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from musev_torch.models.common import GroupNorm
from musev_torch.models.unet3d import UNet3D, UNet3DConfig
from musev_torch.models.vae import AutoencoderKL, VAEConfig, vae_decode_video
from musev_torch.ops import attention
from musev_torch.ops.context import make_window_plan
from musev_torch.parallel import ring_attention as ring
from musev_torch.parallel import sharding
from musev_torch.parallel.context import sharding_ctx
from musev_torch.parallel.mesh import axis_group, cli_topology, make_mesh, set_mesh
from musev_torch.pipelines import denoiser
from musev_torch.schedulers.euler_discrete import EulerDiscreteScheduler

WORLDS = (2, 4)
ATTN_TOL = dict(atol=1e-5, rtol=1e-5)
STEP_TOL = dict(atol=2e-4, rtol=1e-3)
# tests/test_tp_sharding.py's config
TP_CFG = dict(block_out_channels=(16, 16, 32, 32), layers_per_block=1, cross_attention_dim=16,
              attention_heads=4, norm_num_groups=8)
TINY_VAE = dict(block_out_channels=(16, 16, 32, 32), layers_per_block=1, norm_num_groups=8)
RING_SHAPE = (2, 64, 2, 8)  # (B, S, H, D)
SCALES = (None, 0.3)
# (name, q length, k length, bias): the sdpa sites whose sp routing is compared
SP_SITES = (("self 512", 512, 512, False), ("self 256", 256, 256, False),
            ("cross 512x77", 512, 77, False), ("self 512 with bias", 512, 512, True),
            ("self 515", 515, 515, False), ("self 1024", 1024, 1024, False))
STEPS, FRAMES, WINDOW, OVERLAP = 2, 10, 4, 2  # 3 windows, x2 CFG: 6 rows


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs; restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _spawn(fn, n, *args):
    """Run ``fn(rank, n, out_dir, *args)`` on n gloo ranks; returns what
    rank 0 saved. A rank that raises fails the spawn."""
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_entry, args=(fn, n, d, args), nprocs=n, join=True)
        return torch.load(Path(d) / "rank0.pt", weights_only=False)


def _entry(rank, fn, n, d, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/init", rank=rank, world_size=n)
    try:
        torch.save(fn(rank, n, d, *args), f"{d}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _topology_rank(rank, n, d):
    out = {}
    for topology in ("none", "fp", "dp"):
        ctx, kwargs = cli_topology(topology, device="cpu")
        with ctx:
            mesh = kwargs.get("mesh")
            out[topology] = [] if not kwargs else dict(
                keys=sorted(kwargs), axis=kwargs[f"{topology}_axis"],
                dims=list(mesh.mesh_dim_names), shape=list(mesh.mesh.shape),
                ambient=axis_group(topology) is mesh.get_group(topology))
    return out


def cli_topology_world_2(tmp_path):
    """``cli_topology`` on 2 gloo ranks (for tests/test_torch_cli.py)."""
    return _spawn(_topology_rank, 2)


def _denoise_spec(cfg, **axes):
    return denoiser.DenoiseSpec(
        unet_cfg=cfg, scheduler=EulerDiscreteScheduler.create(STEPS),
        plan=make_window_plan(FRAMES, WINDOW, context_overlap=OVERLAP),
        guidance=np.full((STEPS,), 3.5, np.float32), n_vision_cond=1, **axes)


def _step_inputs():
    return dict(latents=_rand(4, 1, FRAMES, 4, 4, 4) * 14.6, cond=_rand(5, 1, 1, 4, 4, 4),
                text_uc=_rand(6, 1, 5, 16), text_c=_rand(7, 1, 5, 16))


def _predict(unet, spec, x):
    with torch.no_grad():
        return denoiser.predict_noise(unet, spec, _t(x["latents"]), 0, _t(x["text_uc"]),
                                      _t(x["text_c"]), condition_latents=_t(x["cond"])).numpy()


def _main_rank(rank, n, d, payload):
    """Every case of this module on one rank."""
    got = {}
    # ring attention on local shards, and sp_sdpa (replicated in and out)
    q, k, v = (_t(payload["qkv"][i]) for i in range(3))
    s_l = q.shape[1] // n
    sl = slice(rank * s_l, (rank + 1) * s_l)
    group = dist.group.WORLD
    for scale in SCALES:
        local = ring.ring_attention(q[:, sl], k[:, sl], v[:, sl], group, scale=scale)
        got[f"ring {scale}"] = torch.cat([*_gather(local, group)], dim=1).numpy()
    sp_mesh = make_mesh((n,), ("sp",))
    with set_mesh(sp_mesh):
        for scale in SCALES:
            got[f"sp_sdpa {scale}"] = ring.sp_sdpa(q, k, v, axis="sp", scale=scale).numpy()
        routed = []
        real = ring.sp_sdpa

        def recording(*a, **kw):
            routed.append(True)
            return real(*a, **kw)

        ring.sp_sdpa = recording
        try:
            with sharding_ctx(sp="sp"):
                for _, sq, sk, with_bias in SP_SITES:
                    routed.clear()
                    qq = torch.randn(1, sq, 2, 8, generator=torch.Generator().manual_seed(0))
                    kk = torch.randn(1, sk, 2, 8, generator=torch.Generator().manual_seed(1))
                    bias = torch.zeros(1, 1, sq, sk) if with_bias else None
                    attention.sdpa(qq, kk, kk, bias=bias)
                    got.setdefault("sp routes", []).append(bool(routed))
        finally:
            ring.sp_sdpa = real

    # window data parallelism: a denoise step with the rows over dp
    x = payload["step"]
    mesh = make_mesh((n,), ("dp",))
    unet = UNet3D(UNet3DConfig(**TP_CFG))
    unet.load_state_dict(payload["unet"], strict=True)
    with set_mesh(mesh):
        got["dp step"] = _predict(unet, _denoise_spec(unet.cfg, dp_axis="dp"), x)
        # the sharded VAE decode against the unsharded one on the same rank
        vae = AutoencoderKL(VAEConfig(**TINY_VAE))
        vae.load_state_dict(payload["vae"], strict=True)
        lat = _t(payload["vae_latents"])
        with torch.no_grad():
            got["vae sharded"] = vae_decode_video(vae, lat, 2, mesh=mesh, axis="dp").numpy()
            got["vae unsharded"] = vae_decode_video(vae, lat, 2).numpy()

    if n == 4:
        # dp x tp = 2 x 2: the UNet split over tp, the rows over dp
        mesh2 = make_mesh((2, 2), ("dp", "tp"))
        tp_unet = UNet3D(UNet3DConfig(**TP_CFG))
        tp_unet.load_state_dict(payload["unet"], strict=True)
        with set_mesh(mesh2):
            sharding.shard_params_tp(tp_unet, mesh2, "tp")
            got["heads"] = sorted({m.heads for m in tp_unet.modules() if hasattr(m, "heads")})
            got["dp x tp step"] = _predict(tp_unet, _denoise_spec(
                tp_unet.cfg, dp_axis="dp", tp_axis="tp"), x)
        # GroupNorm over 4 channel slices that split its groups (C 16, G 2)
        tp4 = make_mesh((4,), ("tp",))
        norm = GroupNorm(2, 16)
        with torch.no_grad():
            norm.weight.copy_(_t(payload["gn_weight"]))
            norm.bias.copy_(_t(payload["gn_bias"]))
            tpn = sharding.TPGroupNorm(norm, rank * 4, 4, tp4.get_group("tp"))
            xs = _t(payload["gn_x"])
            part = tpn(xs[..., rank * 4:(rank + 1) * 4])
            got["gn split groups"] = torch.cat(_gather(part, group), dim=-1).numpy()
            got["gn whole"] = norm(xs).numpy()
            got["gn split groups whole"] = not tpn.whole
    return got


def _gather(x, group):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def _redraw(params, seed):
    import jax

    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a), dtype=np.float32),
        params)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX references and the payload the ranks take."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from musev_torch.models import convert
    from musev_tpu.models.unet3d import UNet3DConfig as JUNetConfig
    from musev_tpu.models.unet3d import init_unet3d
    from musev_tpu.models.vae import VAEConfig as JVAEConfig
    from musev_tpu.models.vae import init_vae
    from musev_tpu.ops.context import make_window_plan as j_plan
    from musev_tpu.parallel.mesh import make_mesh as j_make_mesh
    from musev_tpu.parallel.ring_attention import ring_attention as j_ring
    from musev_tpu.pipelines import denoiser as jden
    from musev_tpu.schedulers.euler_discrete import EulerDiscreteScheduler as JEuler

    qkv = _rand(8, 3, *RING_SHAPE)
    want = {}
    for n in WORLDS:
        mesh = j_make_mesh((n,), ("sp",), devices=jax.devices()[:n])
        spec = P(None, "sp", None, None)
        for scale in SCALES:
            fn = jax.jit(jax.shard_map(partial(j_ring, axis_name="sp", scale=scale),
                                       mesh=mesh, in_specs=(spec,) * 3, out_specs=spec))
            want[(n, f"ring {scale}")] = np.asarray(fn(*(jnp.asarray(a) for a in qkv)))
    # which sdpa sites JAX's dispatcher sends to sp_sdpa under an sp mesh
    import musev_tpu.parallel.ring_attention as j_ring_mod
    from musev_tpu.ops.attention import sdpa as j_sdpa
    from musev_tpu.parallel.context import sharding_ctx as j_sharding_ctx

    real = j_ring_mod.sp_sdpa
    for n in WORLDS:
        routes = []
        j_ring_mod.sp_sdpa = lambda q, *a, **k: routes.append(True) or jnp.zeros_like(q)
        try:
            with jax.set_mesh(j_make_mesh((n,), ("sp",), devices=jax.devices()[:n])):
                with j_sharding_ctx(sp="sp"):
                    for _, sq, sk, with_bias in SP_SITES:
                        before = len(routes)
                        q = jnp.zeros((1, sq, 2, 8))
                        k = jnp.zeros((1, sk, 2, 8))
                        j_sdpa(q, k, k, bias=jnp.zeros((1, 1, sq, sk)) if with_bias else None)
                        want.setdefault((n, "sp routes"), []).append(len(routes) > before)
        finally:
            j_ring_mod.sp_sdpa = real

    jcfg = JUNetConfig(**TP_CFG)
    params = _redraw(init_unet3d(jax.random.PRNGKey(0), jcfg), 0)
    x = _step_inputs()
    jspec = jden.DenoiseSpec(unet_cfg=jcfg, scheduler=JEuler.create(STEPS),
                             plan=j_plan(FRAMES, WINDOW, context_overlap=OVERLAP),
                             guidance=np.full((STEPS,), 3.5, np.float32), n_vision_cond=1)
    want["step"] = np.asarray(jden.predict_noise(
        params, jspec, jnp.asarray(x["latents"]), 0, jnp.asarray(x["text_uc"]),
        jnp.asarray(x["text_c"]), condition_latents=jnp.asarray(x["cond"])))
    vae_params = _redraw(init_vae(jax.random.PRNGKey(1), JVAEConfig(**TINY_VAE)), 1)
    cfg = UNet3DConfig(**TP_CFG)
    payload = dict(qkv=qkv, step=x, unet=convert.unet3d_from_jax(params, cfg),
                   vae=convert.vae_from_jax(vae_params, VAEConfig(**TINY_VAE)),
                   vae_latents=_rand(9, 1, 6, 4, 4, 4) * 0.2,
                   gn_x=_rand(10, 3, 4, 4, 16) * 2.0 + 1.0, gn_weight=_rand(11, 16),
                   gn_bias=_rand(12, 16))
    return want, payload, params, jcfg


@pytest.fixture(scope="module")
def spawned(jax_side):
    _, payload, _, _ = jax_side
    return {n: _spawn(_main_rank, n, payload) for n in WORLDS}


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("scale", SCALES)
def test_ring_attention_matches_jax(jax_side, spawned, n, scale):
    """K/V shards around the ring, one stats launch per step (the plain
    version here), merged: equal to JAX's ring attention under shard_map."""
    want = jax_side[0]
    np.testing.assert_allclose(spawned[n][f"ring {scale}"], want[(n, f"ring {scale}")],
                               **ATTN_TOL)
    np.testing.assert_allclose(spawned[n][f"sp_sdpa {scale}"], want[(n, f"ring {scale}")],
                               **ATTN_TOL)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("scale", SCALES)
def test_local_ring_matches_jax_ring(jax_side, n, scale):
    """``ring_attention_local`` (every rank's K/V shards on one device, the
    card's check of the ring's loop and merges): each rank's output shard,
    concatenated, equals JAX's ring attention under shard_map."""
    want = jax_side[0][(n, f"ring {scale}")]
    q, k, v = (_t(a) for a in _rand(8, 3, *RING_SHAPE))
    ks, vs = k.chunk(n, dim=1), v.chunk(n, dim=1)
    got = torch.cat([ring.ring_attention_local(q.chunk(n, dim=1)[r], ks, vs, r, scale=scale)
                     for r in range(n)], dim=1)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)


@pytest.mark.parametrize("n", WORLDS)
def test_sdpa_takes_the_sp_route_where_jax_does(jax_side, spawned, n):
    want = jax_side[0][(n, "sp routes")]
    assert spawned[n]["sp routes"] == want
    assert any(want) and not all(want)


@pytest.mark.parametrize("n", WORLDS)
def test_dp_denoise_step_matches_jax(jax_side, spawned, n):
    """The 6 window x CFG rows over 2 and 4 ranks (padded to 8 on 4):
    equal to JAX's unsharded predict_noise."""
    np.testing.assert_allclose(spawned[n]["dp step"], jax_side[0]["step"], **STEP_TOL)


def test_dp_x_tp_denoise_step_matches_jax(jax_side, spawned):
    """dp x tp = 2 x 2 on 4 ranks: column/row-split UNet (2 local heads of
    the same head dim) and the rows over dp, by value."""
    assert spawned[4]["heads"] == [2]
    np.testing.assert_allclose(spawned[4]["dp x tp step"], jax_side[0]["step"], **STEP_TOL)


def test_tp_group_norm_over_split_groups_is_exact(spawned):
    """A GroupNorm whose groups span ranks (16 channels, 2 groups, 4 ranks)
    all-reduces the groups' partial sums: equal to the unsharded norm."""
    got = spawned[4]
    assert got["gn split groups whole"]
    np.testing.assert_allclose(got["gn split groups"], got["gn whole"], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_vae_decode_is_bit_for_bit(spawned, n):
    """Each rank decodes its padded contiguous frame shard in 2-frame
    chunks; the gathered pixels equal the unsharded decode bit for bit."""
    got = spawned[n]
    np.testing.assert_array_equal(got["vae sharded"], got["vae unsharded"])


def _jax_dim(spec):
    """The port's (out, in, ...) dim of a JAX PartitionSpec on a (..., in,
    out) kernel, or None for P()."""
    axes = list(spec)
    if "tp" not in axes:
        return None
    return {1: 0, 2: 1}[len(axes) - axes.index("tp")]  # out -> 0, in -> 1


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("over", [{}, dict(ip_adapter_cross_attn=True, ip_adapter_dim=16,
                                           need_ip_adapter_face=True, ip_adapter_face_dim=16)],
                         ids=["tp_config", "ip_faceid"])
def test_tp_split_dims_equal_jax_tp_spec(size, over):
    """For every weight and bias of the tiny UNet, the dim the port splits
    (in its (out, in, ...) layout) is the one JAX's ``_tp_spec`` shards."""
    import jax

    from musev_torch.models import sd_weights
    from musev_tpu.models.unet3d import UNet3DConfig as JUNetConfig
    from musev_tpu.models.unet3d import init_unet3d
    from musev_tpu.parallel.sharding import _tp_spec

    cfg = UNet3DConfig(**TP_CFG, **over)
    params = init_unet3d(jax.random.PRNGKey(0), JUNetConfig(**TP_CFG, **over))
    dims = sharding.tp_split_dims(UNet3D(cfg), size)
    checked = split = 0
    for tk, path, kind in sd_weights.unet3d_key_map(cfg):
        node = sd_weights._get(params, path)
        if not isinstance(node, dict) or "kernel" not in node:
            continue
        for leaf in ("kernel", "bias"):
            if leaf not in node:
                continue
            spec = _tp_spec(tuple(path) + (leaf,), node[leaf], size)
            want = _jax_dim(spec) if leaf == "kernel" else (0 if "tp" in spec else None)
            key = f"{tk}.{'weight' if leaf == 'kernel' else 'bias'}"
            assert dims[key] == want, (key, spec)
            checked += 1
            split += want is not None
    assert checked > 100 and split > 30
