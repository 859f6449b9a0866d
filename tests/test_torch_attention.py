"""The port's attention kernels' plain versions against the JAX package.

Inputs come from a seeded numpy RNG and go through both packages in float32.
The JAX side runs its Pallas kernels in interpret mode where they have one
(``_flash_carry``, ``_flash_stream``, ``short_attention_packed``);
``_unroll_kernel`` has none, so ``ops.attention._xla_sdpa`` is its plain
reference, also for the split-merge route. Tolerance 2e-5 absolute and
relative: float32 softmax attention at these sizes, summed in another order
by each framework.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musev_tpu.ops.attention import _xla_sdpa
from musev_tpu.ops.pallas import flash_attention as jfa
from musev_tpu.ops.pallas.short_attention import short_attention_packed as j_short
from musev_torch.ops import attention as tattn
from musev_torch.ops.kernels import _build
from musev_torch.ops.kernels.flash_attention import (
    LOG2E,
    flash_attention,
    flash_attention_parts,
    flash_attention_plain,
    flash_attention_stats_plain,
    layout_error,
)
from musev_torch.ops.kernels.flash_stream import flash_stream
from musev_torch.ops.kernels.short_attention import (
    layout_error as short_layout_error,
)
from musev_torch.ops.kernels.short_attention import (
    short_attention_packed,
    short_attention_plain,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: torch's OpenMP pool spun
    against the suite's other xdist workers. Restored after, as the setting
    is the process's and JAX shares it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(seed, q_shape, kv_shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(q_shape, dtype=np.float32),
            rng.standard_normal(kv_shape, dtype=np.float32),
            rng.standard_normal(kv_shape, dtype=np.float32))


def _jax_carry(q, k, v, scale, part):
    """Drive the Pallas carry kernel (interpret mode) with KV parts of
    ``part`` rows, so sk beyond ``part`` spans several carried parts."""
    b, sq, h, d = q.shape
    sk = k.shape[1]

    def to_bh(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, x.shape[1], d)

    n_parts = -(-sk // part)
    bq = -(-sq // 8) * 8
    out = jfa._flash_carry(
        jfa._pad_rows(to_bh(q), bq), jfa._pad_rows(to_bh(k), n_parts * part),
        jfa._pad_rows(to_bh(v), n_parts * part), float(scale), bq, part // 2, part,
        sk, n_qsub=1, interpret=True,
    )
    return np.asarray(out[:, :sq]).reshape(b, h, sq, d).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("sk", [200, 1100])  # inside one 512-row KV part / across three
@pytest.mark.parametrize("d", [40, 64])
def test_flash_plain_matches_pallas_carry(sk, d):
    q, k, v = _qkv(sk + d, (1, 48, 2, d), (1, sk, 2, d))
    scale = d**-0.5
    want = _jax_carry(q, k, v, scale, part=512)
    got = flash_attention_plain(*map(torch.from_numpy, (q, k, v)), scale)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("sq,sk,h,d", [(16, 77, 4, 40), (100, 100, 2, 80), (9, 300, 1, 160)])
def test_flash_plain_matches_xla_sdpa(sq, sk, h, d):
    q, k, v = _qkv(sq * sk, (2, sq, h, d), (2, sk, h, d))
    want = np.asarray(_xla_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)))  # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_sdpa_bias_path_matches_xla_sdpa():
    q, k, v = _qkv(7, (2, 12, 3, 8), (2, 12, 3, 8))
    causal = np.triu(np.full((12, 12), -np.inf, np.float32), k=1)[None, None]
    want = np.asarray(_xla_sdpa(*map(jnp.asarray, (q, k, v)), bias=jnp.asarray(causal)))
    got = tattn.sdpa(*map(torch.from_numpy, (q, k, v)), bias=torch.from_numpy(causal))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("n,t,c,heads,kv_len", [
    (6, 13, 64, 8, None),
    (4, 16, 48, 4, 13),  # T padded to 16 with 13 valid keys, as the JAX path pads
    (3, 25, 40, 2, None),
])
def test_short_plain_matches_pallas(n, t, c, heads, kv_len):
    q, k, v = _qkv(n * t * c, (n, t, c), (n, t, c))
    want = np.asarray(j_short(*map(jnp.asarray, (q, k, v)), heads, interpret=True,
                              kv_len=kv_len))
    got = short_attention_packed(*map(torch.from_numpy, (q, k, v)), heads, kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("sk,d,parts", [
    (5300, 40, [4096]),  # past the resident-KV test: parts of 4096 + 1204 rows
    (1400, 512, [1296]),  # the VAE head dim: 1296 + 104
    (1000, 40, []),  # passes the test: one kernel over the whole KV, no split
])
def test_split_route_matches_xla_sdpa(monkeypatch, sk, d, parts):
    """``sdpa`` under MUSEV_FLASH_LONGKV=split splits where the JAX dispatcher
    splits, with its part size, and merges to the exact attention."""
    q, k, v = _qkv(sk + d, (1, 24, 1, d), (1, sk, 1, d))
    want = np.asarray(_xla_sdpa(*map(jnp.asarray, (q, k, v))))
    calls = []

    def spy(*args, **kw):
        calls.append(kw["part"])
        return flash_attention_parts(*args, **kw)

    monkeypatch.setattr(tattn, "flash_attention_parts", spy)
    monkeypatch.setenv("MUSEV_FLASH_LONGKV", "split")
    got = tattn.sdpa(*map(torch.from_numpy, (q, k, v)))
    assert calls == parts
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    monkeypatch.setenv("MUSEV_FLASH_LONGKV", "stream")
    with pytest.raises(ValueError, match="MUSEV_FLASH_LONGKV"):
        tattn.sdpa(*map(torch.from_numpy, (q, k, v)))


def test_stats_plain_match_numpy_formula():
    q, k, v = _qkv(11, (2, 5, 3, 8), (2, 9, 3, 8))
    scale = 0.3
    o, m, l = flash_attention_stats_plain(*map(torch.from_numpy, (q, k, v)), scale)
    s = np.einsum("bqhd,bkhd->bqhk", q.astype(np.float64), k) * scale * LOG2E
    want_m = s.max(-1)
    want_l = np.exp2(s - want_m[..., None]).sum(-1)
    np.testing.assert_allclose(m.numpy(), want_m, **TOL)
    np.testing.assert_allclose(l.numpy(), want_l, **TOL)
    np.testing.assert_allclose(o.numpy(), flash_attention_plain(
        *map(torch.from_numpy, (q, k, v)), scale).numpy(), **TOL)


def test_flash_stream_plain_matches_pallas_stream():
    """Drives ``_flash_stream`` (interpret mode) as tests/test_flash_attention.py
    does: a ragged KV tail (1100 keys in 256-row sub-blocks), 2 heads."""
    q, k, v = _qkv(5, (1, 64, 2, 40), (1, 1100, 2, 40))
    scale = 40**-0.5

    def to_bh(x, rows):
        x = jnp.asarray(x).transpose(0, 2, 1, 3).reshape(2, x.shape[1], 40)
        return jfa._pad_rows(x, rows)

    out = jfa._flash_stream(to_bh(q, 64), to_bh(k, 1280), to_bh(v, 1280), float(scale),
                            64, 256, 1100, 32, interpret=True)
    want = np.asarray(out[:, :, :40]).reshape(1, 2, 64, 40).transpose(0, 2, 1, 3)
    got = flash_stream(*map(torch.from_numpy, (q, k, v)), scale)  # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_short_attention_takes_fused_projection_views():
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((5, 13, 3 * 32), dtype=np.float32))
    q, k, v = qkv.chunk(3, dim=-1)
    want = short_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(), 4)
    torch.testing.assert_close(short_attention_packed(q, k, v, 4), want)


def test_wrappers_count_only_kernel_launches():
    x = torch.zeros(1, 4, 1, 8)
    wrappers = (flash_attention, flash_attention_parts, flash_stream, short_attention_packed)
    before = [w.launches for w in wrappers]
    flash_attention(x, x, x)
    flash_attention_parts(x, x, x, part=3)
    flash_stream(x, x, x)
    short_attention_packed(x[:, :, 0], x[:, :, 0], x[:, :, 0], 1)
    assert [w.launches for w in wrappers] == before


def test_wrappers_reject_misuse():
    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError):
        flash_attention(x, x[:, :, :1], x[:, :, :1])
    with pytest.raises(ValueError):
        short_attention_packed(torch.zeros(2, 65, 8), torch.zeros(2, 65, 8),
                               torch.zeros(2, 65, 8), 2)
    with pytest.raises(ValueError):
        short_attention_packed(x[:, :, 0], x[:, :, 0], x[:, :, 0], 1, kv_len=0)
    meta = torch.zeros(1, 4, 2, 8, device="meta")
    for wrapper in (flash_attention, flash_attention_parts, flash_stream):
        with pytest.raises(ValueError, match="unsupported device"):
            wrapper(meta, meta, meta)
    with pytest.raises(ValueError):
        flash_attention_parts(x, x, x, part=0)


def test_kernel_library_name_tracks_source():
    a = _build.library_path("flash_attention")
    b = _build.library_path("short_attention")
    c = _build.library_path("flash_stream")
    assert a.parent == b.parent == c.parent == _build.BUILD_DIR
    assert a.name.startswith("libflash_attention-") and len({a, b, c}) == 3


def test_kernel_library_name_tracks_included_headers(tmp_path, monkeypatch):
    """An edit of flash_common.cuh renames both flash libraries (so a stale
    one is never loaded) and leaves a source that does not include it alone."""
    for src in _build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    names = ("flash_attention", "flash_stream", "pivot")
    before = {n: _build.library_path(n) for n in names}
    with open(tmp_path / "flash_common.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build.library_path(n) for n in names}
    assert after["flash_attention"] != before["flash_attention"]
    assert after["flash_stream"] != before["flash_stream"]
    assert after["pivot"] == before["pivot"]


@pytest.mark.parametrize("d", [8, 40, 48, 64, 72, 80, 96, 160, 168, 512])
def test_flash_broadcast_refused_only_on_the_tma_kernel(d):
    """``flash_attention`` and ``flash_stream`` read q/k/v through TMA at
    every head dim, and TMA cannot step a broadcast (stride-0) batch, so
    every head dim refuses one (the last kernel that took one, K2 on
    cp.async, became a TMA kernel)."""
    k = torch.zeros(1, 16, 2, d, dtype=torch.bfloat16).expand(3, 16, 2, d)
    assert layout_error(k.contiguous()) is None
    assert "stride 0" in layout_error(k)


def _projection_views(proj, b, h, sq, sk, d):
    """bf16 (B, S, H, D) views laid out as the paths' projections lay them
    out (``chip_smoke.py``'s FLASH_SITES): one fused q|k|v product, q beside
    a fused k|v product, or three separate products."""
    c = h * d
    if proj == "qkv":
        return tuple(t.unflatten(-1, (h, d))
                     for t in torch.zeros(b, sq, 3 * c, dtype=torch.bfloat16).chunk(3, -1))
    if proj == "q|kv":
        k, v = torch.zeros(b, sk, 2 * c, dtype=torch.bfloat16).chunk(2, -1)
        q = torch.zeros(b, sq, c, dtype=torch.bfloat16)
    else:
        q, k, v = (torch.zeros(b, s, c, dtype=torch.bfloat16) for s in (sq, sk, sk))
    return tuple(t.unflatten(-1, (h, d)) for t in (q, k, v))


@pytest.mark.parametrize("proj,b,h,sq,sk,d", [
    ("q|kv", 3, 8, 20, 40, 40), ("qkv", 3, 8, 20, 20, 40), ("q|kv", 6, 8, 20, 77, 40),
    ("q|kv", 3, 8, 12, 24, 80), ("q|kv", 3, 8, 6, 12, 160), ("q|k|v", 2, 1, 30, 30, 512),
    ("q|k|v", 6, 8, 20, 4, 40), ("q|k|v", 1, 16, 17, 17, 80), ("q|k|v", 1, 1, 5, 5, 40),
])
def test_tma_layout_accepts_every_path_layout(proj, b, h, sq, sk, d):
    """Every projection layout of the flash sites, at small sizes, is one
    that TMA tensor maps can describe as it is (no copies)."""
    for x in _projection_views(proj, b, h, sq, sk, d):
        assert layout_error(x) is None


def test_tma_layout_refuses_what_tma_cannot_address():
    """A broadcast (stride-0) dim of extent above 1 is refused; one of
    extent 1 is never stepped, so its stride 0 is taken."""
    q, k, v = _projection_views("qkv", 2, 2, 16, 16, 40)
    assert "stride 0" in layout_error(q[:1].expand(2, 16, 2, 40))  # batch
    assert "stride 0" in layout_error(q[:, :1].expand(2, 16, 2, 40))  # sequence
    one = torch.zeros(16, 2, 40, dtype=torch.bfloat16).as_strided((1, 16, 2, 40),
                                                                  (0, 80, 40, 1))
    assert layout_error(one) is None


@pytest.mark.parametrize("bad,why", [
    ("base", "aligned"), ("rows", "8-element-aligned"), ("head", "contiguous head dim"),
])
def test_kernel_layout_refuses_misaligned_views(bad, why):
    """A base 8 bytes off 16, 84-element (168-byte) rows or a transposed head
    dim is refused by every flash kernel."""
    if bad == "base":
        x = torch.zeros(2, 16, 88, dtype=torch.bfloat16)[..., 4:84].unflatten(-1, (2, 40))
    elif bad == "rows":
        x = torch.zeros(2, 16, 84, dtype=torch.bfloat16)[..., :80].unflatten(-1, (2, 40))
    else:
        x = torch.zeros(2, 16, 40, 40, dtype=torch.bfloat16).transpose(2, 3)
    assert why in layout_error(x)




def _short_views(n, t, c, width=None, offset=0):
    """q, k, v as column views of one fused (N, T, width) projection."""
    qkv = torch.zeros(n, t, width or 3 * c, dtype=torch.bfloat16)[..., offset:]
    return qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:3 * c]


@pytest.mark.parametrize("case,heads,why", [
    ((31, 13, 320), 8, None),  # L0 temporal: D = 40
    ((9, 13, 640), 8, None),  # L1: D = 80
    ((4, 13, 1280), 8, None),  # L2 and L3: D = 160
    ((3, 64, 256), 1, None),  # T = 64, D = 256
    ((5, 13, 288), 8, "head dim 36 must be a multiple of 8 up to 256"),
    ((5, 13, 264), 1, "head dim 264 must be a multiple of 8 up to 256"),
    ("ld", 8, "a multiple of 8"),  # rows of 3C + 4 elements
    ("base", 8, "not 16-byte aligned"),  # the views start 4 elements in
    ("strides", 8, "one ld for q, k and v"),  # k a view of another product
])
def test_short_kernel_layout_error(case, heads, why):
    """What the short kernel refuses on the card, and why: it copies and
    writes 16-byte vectors, so the head dim, the row stride and the bases
    must allow them; the paths' fused projections at every temporal site
    pass."""
    if case == "ld":
        q, k, v = _short_views(4, 13, 320, width=3 * 320 + 4)
    elif case == "base":
        q, k, v = _short_views(4, 13, 320, width=3 * 320 + 8, offset=4)
    elif case == "strides":
        q, _, v = _short_views(4, 13, 320)
        k = torch.zeros(4, 13, 2 * 320, dtype=torch.bfloat16)[..., :320]
    else:
        q, k, v = _short_views(*case)
    got = short_layout_error(q, k, v, heads)
    assert got is None if why is None else why in got
