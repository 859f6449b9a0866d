"""The port's frame-parallel UNet (``musev_torch.parallel.frame_parallel``)
on real gloo process groups of 2 and 4 ranks against the JAX package.

Each case's JAX side is the package's UNSHARDED ``unet3d_apply`` (its own
tests hold that equal to its shard_map program at atol/rtol 2e-4); one
case is also held to JAX's ``unet3d_apply_fp`` on a 2-device mesh, and one
to its single-device stub mode. Both sides get the same weights: the JAX
package's ``init_*`` trees with every leaf redrawn as init + N(0, 0.05), so
zero-initialised branches and the 1e-5 temporal weights do not hide,
carried over by ``musev_torch.models.convert``; inputs from a seeded numpy
RNG; float32 on the CPU; atol/rtol 2e-4.

Each world size is spawned once for the module (``torch.multiprocessing``,
``file://`` rendezvous under the test's temporary directory, one torch
thread per rank): the ranks run every case and save what they got, and
each test asserts one case. A rank that fails fails the spawn. The module's
top-level imports are torch, numpy and ``musev_torch`` only, because the
ranks import it; JAX and ``musev_tpu`` are imported inside the parent's
fixtures.
"""

import dataclasses
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from musev_torch.models.controlnet import ControlNet, ControlNetConfig
from musev_torch.models.unet3d import UNet3D, UNet3DConfig
from musev_torch.parallel import frame_parallel as fp
from musev_torch.parallel.mesh import make_mesh, set_mesh

TOL = dict(atol=2e-4, rtol=2e-4)
WORLDS = (2, 4)
# tests/test_frame_parallel.py's tiny config and ControlNet
BASE = dict(block_out_channels=(16, 32), down_block_types=("CrossAttnDownBlock3D", "DownBlock3D"),
            up_block_types=("UpBlock3D", "CrossAttnUpBlock3D"), layers_per_block=1,
            norm_num_groups=4, attention_heads=2, cross_attention_dim=16,
            keep_vision_condition=True, keep_content_condition=True)
REFNET = dict(need_transformer_in=False, use_anivv1_cfg=True, resnet_skip_time_act=True,
              need_refer_emb=True, ip_adapter_cross_attn=True, ip_adapter_dim=16)
CN = dict(block_out_channels=(16, 32), cond_embed_channels=(8, 8, 8, 16), layers_per_block=1,
          cross_attention_dim=16, attention_heads=2, norm_num_groups=4)
# case: (config overrides, batch, frames (condition frame included), latent
# side, CFG, extras). Under CFG the batch is [uncond; cond] window rows.
# Shapes repeat where they can: JAX's eager ops compile once per shape.
CASES = {
    "cfg_groups": ({}, 6, 5, 8, True, ()),
    "no_cfg": ({}, 6, 5, 8, False, ()),
    # groups of 15 rows pad to 16; 3 x 3 latents at the second level pad
    # their 9 pixels to 10 (n = 2) and 12 (n = 4)
    "row_and_pixel_padding": ({}, 6, 5, 6, True, ()),
    "referencenet": (REFNET, 6, 5, 8, True, ("refer",)),
    "controlnet_in_program": ({}, 6, 5, 8, True, ("controlnet",)),
    "ip_adapter_faceid": (dict(ip_adapter_cross_attn=True, ip_adapter_dim=16,
                               need_ip_adapter_face=True, ip_adapter_face_dim=16),
                          6, 5, 8, True, ("ip", "face")),
    "sparse_causal_mask": (dict(temporal_self_attn_mask="sparse_causal",
                                temporal_attn_n_near=1), 6, 5, 8, True, ()),
    "spatial_position_emb": (dict(need_spatial_position_emb=True), 6, 5, 6, True, ()),
}
TIMESTEP = 7.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite's xdist workers
    share the cores); restored after, as the setting is the process's."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rng_arrays(seed, **shapes):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s, dtype=np.float32) for k, s in shapes.items()}


def _inputs(name):
    """The case's numpy inputs and keyword arrays, shared by both sides."""
    over, b, t, h, do_cfg, extras = CASES[name]
    c16 = 16
    arrs = _rng_arrays(len(name), sample=(b, t - 1, h, h, 4), cond=(b, 1, h, h, 4),
                       text=(b, 7, c16))
    kw = {}
    if "refer" in extras:
        r = _rng_arrays(100, stem=(b, 1, h, h, 16), l0=(b, 1, h, h, 16),
                        down=(b, 1, h // 2, h // 2, 16), l1=(b, 1, h // 2, h // 2, 32),
                        mid=(b, 1, h // 2, h // 2, 32), s0=(b, 12, 16), s1=(b, 12, 32),
                        s2=(b, 12, 16), s3=(b, 12, 16), clip=(b, 4, 16))
        kw.update(down_block_refer_embs=[r["stem"], r["l0"], r["down"], r["l1"]],
                  mid_block_refer_emb=r["mid"],
                  refer_self_attn_embs=[r["s0"], r["s1"], r["s2"], r["s3"]],
                  refer_self_attn_mode="read", vision_clip_emb=r["clip"], ip_adapter_scale=0.7)
    if "ip" in extras:
        r = _rng_arrays(101, clip=(b, 4, 16), face=(b, 4, 16))
        kw.update(vision_clip_emb=r["clip"], ip_adapter_scale=0.7,
                  ip_adapter_face_emb=r["face"], ip_adapter_face_scale=0.6)
    images = None
    if "controlnet" in extras:
        images = np.random.default_rng(102).uniform(0, 1, (b * t, 8 * h, 8 * h, 3)).astype(
            np.float32)
    return over, arrs, kw, images, do_cfg, t


def _redraw(params, seed):
    import jax

    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a), dtype=np.float32),
        params)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _torch_kw(kw):
    return {k: [_t(e) for e in v] if isinstance(v, list) else
            (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """Per case: the JAX unsharded output, the port's weights and inputs
    (written to one payload file the ranks read); JAX's own fp program on
    a 2-device mesh and its stub at n = 4, on the cfg_groups case."""
    import jax
    import jax.numpy as jnp

    from musev_torch.models import convert
    from musev_tpu.models.controlnet import ControlNetConfig as JCNConfig
    from musev_tpu.models.controlnet import controlnet_apply as j_controlnet_apply
    from musev_tpu.models.controlnet import init_controlnet
    from musev_tpu.models.unet3d import UNet3DConfig as JUNetConfig
    from musev_tpu.models.unet3d import init_unet3d, unet3d_apply as j_unet3d_apply
    from musev_tpu.parallel.frame_parallel import unet3d_apply_fp as j_unet3d_apply_fp
    from musev_tpu.parallel.mesh import make_mesh as j_make_mesh

    payload, want = {}, {}
    for i, name in enumerate(CASES):
        over, arrs, kw, images, do_cfg, t = _inputs(name)
        jcfg = JUNetConfig(**BASE, **over)
        params = _redraw(init_unet3d(jax.random.PRNGKey(i), jcfg), i)
        cfg = UNet3DConfig(**BASE, **over)
        common = dict(condition_latents=arrs["cond"], gen_index=tuple(range(1, t)),
                      cond_index=(0,), do_cfg=do_cfg)
        jkw = dict(common, **{k: [jnp.asarray(e) for e in v] if isinstance(v, list) else v
                              for k, v in kw.items()})
        entry = dict(cfg=dataclasses.asdict(cfg), unet=convert.unet3d_from_jax(params, cfg),
                     sample=arrs["sample"], text=arrs["text"], kw=dict(common, **kw))
        if images is not None:
            jcn = JCNConfig(**CN)
            cn_params = _redraw(init_controlnet(jax.random.PRNGKey(50), jcn), 50)
            b = arrs["sample"].shape[0]
            rows = np.concatenate([arrs["cond"], arrs["sample"]], axis=1).reshape(-1, *arrs[
                "sample"].shape[2:])
            d, m = j_controlnet_apply(cn_params, jcn, jnp.asarray(rows), TIMESTEP,
                                      jnp.repeat(jnp.asarray(arrs["text"]), t, axis=0),
                                      jnp.asarray(images))
            jkw.update(controlnet_down_residuals=d, controlnet_mid_residual=m)
            entry.update(cn=convert.controlnet_from_jax(cn_params, ControlNetConfig(**CN)),
                         images=images)
            assert b * t == images.shape[0]
        want[name] = np.asarray(j_unet3d_apply(params, jcfg, arrs["sample"],
                                               jnp.asarray(TIMESTEP), arrs["text"], **jkw))
        payload[name] = entry
        if name == "cfg_groups":
            mesh = j_make_mesh((2,), ("fp",), devices=jax.devices()[:2])
            # under jit: eager shard_map runs op by op, some 15 times slower
            fn = jax.jit(lambda p, s, x: j_unet3d_apply_fp(
                p, jcfg, s, jnp.asarray(TIMESTEP), x, axis="fp", **jkw))
            with jax.set_mesh(mesh):
                want["jax_fp_mesh"] = np.asarray(fn(params, arrs["sample"], arrs["text"]))
            want["jax_stub4"] = np.asarray(j_unet3d_apply_fp(
                params, jcfg, arrs["sample"], jnp.asarray(TIMESTEP), arrs["text"],
                stub_devices=4, **jkw))
    path = tmp_path_factory.mktemp("fp_payload") / "payload.pt"
    torch.save(payload, path)
    return path, want


def _build(entry):
    unet = UNet3D(UNet3DConfig(**entry["cfg"]))
    unet.load_state_dict(entry["unet"], strict=True)
    cn = None
    if "cn" in entry:
        cn = ControlNet(ControlNetConfig(**CN))
        cn.load_state_dict(entry["cn"], strict=True)
    return unet.eval(), cn


def _call(entry, unet, cn, **extra):
    kw = _torch_kw(entry["kw"])
    if cn is not None:
        kw["controlnet"] = dict(nets=[cn], scales=[1.0], images=[_t(entry["images"])],
                                timestep=TIMESTEP)
    with torch.no_grad():
        return fp.unet3d_apply_fp(unet, _t(entry["sample"]), TIMESTEP, _t(entry["text"]),
                                  **kw, **extra).numpy()


class CountingComm:
    """A comm that counts its calls by collective kind."""

    KINDS = dict(ppermute="collective_permute", psum="all_reduce", all_to_all="all_to_all",
                 all_gather="all_gather")

    def __init__(self, comm):
        self.comm, self.n = comm, comm.n
        self.counts = {k: 0 for k in self.KINDS.values()}

    def __getattr__(self, name):
        fn = getattr(self.comm, name)
        if name not in self.KINDS:
            return fn

        def counted(*a, **k):
            self.counts[self.KINDS[name]] += 1
            return fn(*a, **k)

        return counted


def _fp_rank(rank, n, path, out_dir):
    """One rank: every case under the ambient fp mesh; at rank 0 the
    outputs (and, at n = 2, the counted collectives of cfg_groups)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/init", rank=rank,
                            world_size=n)
    try:
        payload = torch.load(path, weights_only=False)
        mesh = make_mesh((n,), ("fp",))
        got = {}
        with set_mesh(mesh):
            for name, entry in payload.items():
                unet, cn = _build(entry)
                got[name] = _call(entry, unet, cn, axis="fp")
            unet, cn = _build(payload["cfg_groups"])
            comm = CountingComm(fp.RealComm(mesh.get_group("fp")))
            _call(payload["cfg_groups"], unet, cn, comm=comm)
            got["counts"] = comm.counts
        torch.save(got, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def spawned(jax_side):
    path, _ = jax_side
    results = {}
    for n in WORLDS:
        with tempfile.TemporaryDirectory() as d:
            mp.spawn(_fp_rank, args=(n, str(path), d), nprocs=n, join=True)
            results[n] = [torch.load(Path(d) / f"rank{r}.pt", weights_only=False)
                          for r in range(n)]
    return results


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_fp_matches_jax_unsharded(jax_side, spawned, case, n):
    """Every rank ends with the full output, equal to JAX's unsharded UNet."""
    _, want = jax_side
    for got in spawned[n]:
        np.testing.assert_allclose(got[case], want[case], **TOL)


def test_fp_matches_jax_fp_program_on_a_2_device_mesh(jax_side, spawned):
    _, want = jax_side
    np.testing.assert_allclose(spawned[2][0]["cfg_groups"], want["jax_fp_mesh"], **TOL)


def test_stub_program_matches_jax_stub(jax_side):
    """One rank's program at n = 4 with StubComm equals JAX's
    ``stub_devices=4`` output (values fake at the collective points)."""
    path, want = jax_side
    entry = torch.load(path, weights_only=False)["cfg_groups"]
    unet, cn = _build(entry)
    got = _call(entry, unet, cn, comm=fp.StubComm(4))
    assert got.shape == want["jax_stub4"].shape
    np.testing.assert_allclose(got, want["jax_stub4"], **TOL)


def test_collective_counts_equal_the_model(spawned):
    """The port's calls per kind in one fp UNet call equal
    ``fp_collective_model``'s counts (the port's form of
    test_fp_collective_counts_match_lowering; the all-gather is the port's
    one explicit gather of the output rows)."""
    _, b, t, h, do_cfg, _ = CASES["cfg_groups"]
    model = fp.fp_collective_model(UNet3DConfig(**BASE), t=t, h0=h, w0=h, n=2,
                                   n_windows=b // 2, do_cfg=do_cfg, n_vc=1)
    assert spawned[2][0]["counts"] == model["counts_by_kind"]
    assert sum(model["counts_by_kind"].values()) == model["collectives_per_step"]


@pytest.mark.parametrize("plan", [dict(n_windows=3, t=13, n=8, h0=72, w0=72),
                                  dict(n_windows=3, t=5, n=2, h0=8, w0=8, do_cfg=False),
                                  dict(n_windows=1, t=25, n=4, h0=9, w0=7, n_vc=2,
                                       itemsize=4)])
def test_collective_model_equals_jax(plan):
    from musev_tpu.models.unet3d import musev_config as j_musev_config
    from musev_tpu.parallel.frame_parallel import fp_collective_model as j_model
    from musev_torch.models.unet3d import musev_config

    assert fp.fp_collective_model(musev_config(), **plan) == j_model(j_musev_config(), **plan)


@pytest.mark.parametrize("n_batch,t,n,use_ref", [(3, 13, 8, True), (1, 4, 8, False),
                                                 (3, 5, 2, True), (2, 3, 4, False)])
def test_row_metadata_equals_jax(n_batch, t, n, use_ref):
    from musev_tpu.parallel import frame_parallel as jfp

    g, jg = fp.GroupMeta(n_batch, t, n, use_ref), jfp.GroupMeta(n_batch, t, n, use_ref)
    for field in ("rows", "rows_pad", "local", "pad"):
        assert getattr(g, field) == getattr(jg, field)
    np.testing.assert_array_equal(g.pad_index(), jg.pad_index())
    ids, jids = fp._row_ids(g, 3), jfp._row_ids(jg, 3)
    assert ids.keys() == jids.keys()
    for k in ids:
        np.testing.assert_array_equal(ids[k], jids[k])
    meta = fp.FPMeta(n, (g, g), (0,))
    jmeta = jfp.FPMeta(n, (jg, jg), (0,))
    assert meta.local_total == jmeta.local_total
    assert meta.block_starts() == jmeta.block_starts()
    assert meta.batch_starts() == jmeta.batch_starts()


@pytest.mark.parametrize("what", ["adain_fix", "write"])
def test_unsupported_modes_raise_as_jax(jax_side, what):
    import jax
    import jax.numpy as jnp

    from musev_tpu.models.unet3d import UNet3DConfig as JUNetConfig
    from musev_tpu.models.unet3d import init_unet3d
    from musev_tpu.parallel.frame_parallel import unet3d_apply_fp as j_unet3d_apply_fp

    path, _ = jax_side
    entry = torch.load(path, weights_only=False)["cfg_groups"]
    over = dict(adain_fix=True) if what == "adain_fix" else {}
    kw = dict(refer_self_attn_embs=[], refer_self_attn_mode="write") if what == "write" else {}
    unet = UNet3D(UNet3DConfig(**BASE, **over))
    jcfg = JUNetConfig(**BASE, **over)
    params = init_unet3d(jax.random.PRNGKey(0), jcfg)
    match = "adain_fix" if what == "adain_fix" else "write mode"
    with pytest.raises(NotImplementedError, match=match):
        fp.unet3d_apply_fp(unet, _t(entry["sample"]), TIMESTEP, _t(entry["text"]),
                           comm=fp.StubComm(2), **kw)
    with pytest.raises(NotImplementedError, match=match):
        j_unet3d_apply_fp(params, jcfg, jnp.asarray(entry["sample"]), jnp.asarray(TIMESTEP),
                          jnp.asarray(entry["text"]), stub_devices=2, **kw)


def test_fp_without_a_mesh_raises():
    """As JAX's fp needs an ambient mesh carrying its axis."""
    unet = UNet3D(UNet3DConfig(**BASE))
    with pytest.raises(ValueError, match="ambient mesh"):
        fp.unet3d_apply_fp(unet, torch.zeros(2, 4, 8, 8, 4), 1.0, torch.zeros(2, 7, 16))
