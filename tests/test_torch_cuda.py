"""The port's CUDA kernels against their plain versions, on the card.

Imports nothing of JAX, so it runs where JAX is absent:
``python -m pytest --noconftest -p no:randomly -m cuda tests/test_torch_cuda.py``.
Without a CUDA device every test skips. The attention inputs are column
views of one fused projection, as ``Attention.project`` makes them.
Tolerances are scaled to what is compared: the attention kernels round P and
the output to bf16 (relative rounding error up to 2^-9 per element), the
plain versions keep float32 throughout, so the relative L2 error must stay
under 1e-2 and the largest error under 2e-2 of the largest output. The
pivots move bits and must match exactly; the fused GroupNorm apply rounds
its float32 product separately where the plain version may fuse it with the
add, so it may differ by one bf16 ulp of the output plus one float32 ulp of
the product. The norm kernels (K8, K9) are held against their composition
run in float64 on the same input: within one ulp of the output type at the
exact result, which covers the one rounding of their store, plus 2^-16 of
the magnitude of the terms summed (x * scale, the bias and mean * scale:
their float32 statistics and affine).
"""

import pytest
import torch

from musev_torch.ops.attention import MemEfficientAttention, mem_efficient_sdpa, natural_lse
from musev_torch.ops.kernels.flash_attention import (
    _launch,
    flash_attention,
    flash_attention_parts,
    flash_attention_plain,
    flash_attention_stats_plain,
)
from musev_torch.ops.kernels.flash_stream import flash_stream
from musev_torch.ops.kernels.flash_stream import plan as stream_plan
from musev_torch.ops.kernels.norm import (
    group_norm,
    group_norm_plain,
    group_norm_scale_shift,
    group_norm_scale_shift_plain,
    layer_norm,
    layer_norm_plain,
)
from musev_torch.ops.kernels.pivot import (
    pivot_rows,
    pivot_rows_plain,
    unpivot_rows,
    unpivot_rows_plain,
)
from musev_torch.ops.kernels.short_attention import (
    short_attention_packed,
    short_attention_plain,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def assert_close_scaled(got: torch.Tensor, want: torch.Tensor) -> None:
    want = want.float()
    diff = got.float() - want
    rel_l2 = (diff.norm() / want.norm()).item()
    ratio = (diff.abs().max() / want.abs().max()).item()
    assert rel_l2 <= 1e-2 and ratio <= 2e-2, (rel_l2, ratio)


@pytest.mark.cuda
def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    x32 = torch.zeros(1, 64, 2, 40, device=cuda)
    with pytest.raises(TypeError):
        flash_attention(x32, x32, x32)
    odd = torch.zeros(1, 64, 2, 36, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention(odd, odd, odd)
    x = torch.zeros(2, 64, 2, 40, device=cuda, dtype=torch.bfloat16)
    wide = torch.zeros(2, 64, 2 * 40 + 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):  # base 8 bytes off 16
        flash_attention(x, wide[..., 4:84].unflatten(-1, (2, 40)), x)
    with pytest.raises(ValueError, match="stride 0"):  # a broadcast batch
        flash_attention(x, x[:1].expand(2, 64, 2, 40), x)
    wide = torch.zeros(2, 64, 1, 512, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="stride 0"):  # also at d = 512, read through TMA
        flash_attention(wide, wide[:1].expand(2, 64, 1, 512), wide)
    p = torch.zeros(4, 13, 48, device=cuda)
    with pytest.raises(TypeError):
        short_attention_packed(p, p, p, 4)
    p = p.bfloat16()
    with pytest.raises(ValueError, match="multiple of 8"):  # D = 12
        short_attention_packed(p, p, p, 4)
    qkv = torch.zeros(4, 13, 3 * 48 + 8, device=cuda, dtype=torch.bfloat16)[..., 4:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        short_attention_packed(*qkv[..., :144].chunk(3, dim=-1), 2)


@pytest.mark.cuda
@pytest.mark.parametrize("fused,sq,sk,d", [
    (2, 100, 77, 40), (2, 130, 1000, 80), (3, 200, 200, 40), (1, 33, 300, 512),
    (1, 33, 4, 40),  # sq < 64, sk below one tile (the IP branch's 4 tokens)
    (2, 257, 1500, 40),  # a ragged KV tail after three laps of the 4-stage ring
    (3, 130, 130, 64), (2, 70, 600, 64), (2, 100, 300, 48),  # d = 48: padded to 64
    (3, 90, 90, 72),  # d = 72: padded to 80
    (1, 257, 257, 80), (3, 64, 64, 80),
    (3, 81, 81, 160), (2, 200, 300, 160),  # d = 160: 64-key tiles, a 2-stage ring
    (1, 5, 3, 512),
    # d = 512 (the wide kernel: 64 query rows, 64-key tiles): sq and sk
    # ragged against both, sk below one tile, many tiles
    (1, 100, 130, 512), (1, 70, 33, 512), (1, 64, 64, 512), (1, 129, 700, 512),
    (1, 40, 100, 264),  # d = 264: slabs 5-7 of Q, K and V lie wholly past d
])
def test_cuda_flash_matches_plain(cuda, fused, sq, sk, d):
    """``fused`` projections share one product: 3 = q|k|v (self-attention),
    2 = k|v beside q (ReferenceOnly, cross-attention), 1 = none (VAE). Head
    dims 40, 64, 80 and 160 run the wgmma kernel's four instances (192-row
    query blocks at d = 40, 128 above; 128-key tiles, 64 at d = 160), 48 and
    72 pad inside an instance, 264 and 512 run the wide kernel; sq and sk cover
    tiles cut short, below one tile and over several laps of the K/V ring."""
    g = torch.Generator(device=cuda).manual_seed(0)
    heads = 2

    def rand(s, n):
        x = torch.randn(2, s, n * heads * d, device=cuda, generator=g).bfloat16()
        return [t.unflatten(-1, (heads, d)) for t in x.chunk(n, dim=-1)]

    if fused == 3:
        q, k, v = rand(sq, 3)
    elif fused == 2:
        (q,), (k, v) = rand(sq, 1), rand(sk, 2)
    else:
        (q,), (k,), (v,) = rand(sq, 1), rand(sk, 1), rand(sk, 1)
    assert_close_scaled(flash_attention(q, k, v), flash_attention_plain(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,d", [(1000, 300, 40), (1000, 77, 40), (700, 300, 80),
                                     (400, 130, 160), (300, 200, 512)])
def test_cuda_flash_blocks_walk_many_items(cuda, sq, sk, d):
    """6 x 8 (b, h) pairs of several query tiles each: more work items than
    the card has SMs, so each persistent block takes several items in turn,
    reusing its Q buffers and carrying its K/V ring from item to item."""
    q, k, v = _views(cuda, sq, sk, d, heads=8, batch=6)
    assert_close_scaled(flash_attention(q, k, v), flash_attention_plain(q, k, v))


def _views(cuda, sq, sk, d, heads=2, batch=2):
    """q beside a fused k|v product, as the ReferenceNet fuse and the
    ReferenceOnly cond half lay them out."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(batch, sq, heads * d, device=cuda, generator=g).bfloat16()
    kv = torch.randn(batch, sk, 2 * heads * d, device=cuda, generator=g).bfloat16()
    k, v = kv.chunk(2, dim=-1)
    return tuple(t.unflatten(-1, (heads, d)) for t in (q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,d", [(100, 300, 40), (70, 129, 80), (33, 200, 512),
                                     (200, 1100, 40), (40, 77, 64), (81, 162, 160),
                                     (130, 70, 512), (65, 20, 512)])
def test_cuda_flash_stats_match_plain(cuda, sq, sk, d):
    """The kernel's (m, l) outputs: m in log2 units to 1e-2 absolute (bf16
    logits), l to 1e-2 relative."""
    q, k, v = _views(cuda, sq, sk, d)
    o, m, l = _launch(q, k, v, None, with_stats=True)
    want_o, want_m, want_l = flash_attention_stats_plain(q, k, v)
    assert_close_scaled(o, want_o)
    assert (m - want_m).abs().max().item() <= 1e-2
    assert ((l - want_l).abs() / want_l).max().item() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("sk,d,part", [(1100, 40, 512), (600, 512, 256), (300, 80, 4096),
                                       (700, 160, 100), (1000, 64, 300),
                                       (2600, 512, 1296)])  # the split route's VAE parts
def test_cuda_parts_match_plain(cuda, sk, d, part):
    """Every part but the first two of each case ends inside a KV tile."""
    q, k, v = _views(cuda, 77, sk, d)
    before = flash_attention_parts.launches
    got = flash_attention_parts(q, k, v, part=part)
    assert flash_attention_parts.launches - before == -(-sk // part)
    assert_close_scaled(got, flash_attention_plain(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 160, 512])
def test_cuda_flash_without_keys_yields_zero(cuda, d):
    """sk = 0: every row's keys are masked, so the output is 0 and the stats
    are m = -inf, l = 0, as the Pallas kernel's safe_l gives."""
    q, k, v = _views(cuda, 70, 0, d)
    o, m, l = _launch(q, k, v, None, with_stats=True)
    assert torch.equal(o, torch.zeros_like(o))
    assert bool(torch.isneginf(m).all()) and torch.equal(l, torch.zeros_like(l))


# the cluster's edges at each path head dim: sq not a multiple of the
# cluster's rows (1296, 81, 5), sq below one CTA's rows (whole CTAs of a
# cluster without rows), no keys, and a ragged KV tail
STREAM_EDGES = [(sq, sk, d) for d in (40, 80, 160)
                for sq, sk in ((1296, 300), (81, 300), (5, 300), (150, 1000), (70, 0),
                               (81, 10368 + 13))]


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,d", [(100, 1100, 40), (257, 257, 80), (130, 70, 160), (5, 3, 40),
                                     *STREAM_EDGES])
def test_cuda_flash_stream_matches_plain(cuda, sq, sk, d):
    q, k, v = _views(cuda, sq, sk, d)
    before = flash_stream.launches
    got = flash_stream(q, k, v)
    assert flash_stream.launches - before == 1
    if sk == 0:  # every key masked: rows of 0
        assert torch.equal(got, torch.zeros_like(got))
    else:
        assert_close_scaled(got, flash_attention_plain(q, k, v))
    with pytest.raises(ValueError):
        flash_stream(*(torch.zeros(1, 8, 1, 512, device=cuda, dtype=torch.bfloat16),) * 3)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 64, 80, 160])
def test_cuda_flash_stream_plans_match_plain(cuda, d):
    """Each head-dim instance's cluster plan, with 6 x 8 (b, h) pairs of a
    ragged query extent: more cluster work items than the card holds
    clusters, so each cluster walks several in turn, with CTAs that hold no
    rows in the last chunk of each (b, h)."""
    q, k, v = _views(cuda, 1296 + 5, 700 + 13, d, heads=8, batch=6)
    assert_close_scaled(flash_stream(q, k, v), flash_attention_plain(q, k, v))
    info = stream_plan(d)
    assert info["cluster_size"] == (3 if d > 80 else 2)
    assert info["active_clusters"] * info["cluster_size"] <= (
        torch.cuda.get_device_properties(0).multi_processor_count)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_len", [None, 10])
def test_cuda_short_matches_plain(cuda, kv_len):
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(50, 13, 3 * 320, device=cuda, generator=g).bfloat16()
    q, k, v = qkv.chunk(3, dim=-1)
    got = short_attention_packed(q, k, v, 8, kv_len=kv_len)
    assert_close_scaled(got, short_attention_plain(q, k, v, 8, kv_len=kv_len))


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,d,kv_len", [
    (37, 1, 40, None), (37, 13, 40, 10), (37, 16, 80, None), (37, 17, 80, 5),
    (37, 33, 160, None), (37, 64, 40, 64), (37, 64, 160, 50), (37, 13, 160, 1),
])
def test_cuda_short_edge_cases(cuda, n, t, d, kv_len):
    """T across the 16/32/64 paddings, masked keys, the paths' head dims,
    and N = 37 pixel rows: no multiple of the blocks' work units, so the last
    lap of the persistent blocks is partial."""
    g = torch.Generator(device=cuda).manual_seed(t * d)
    qkv = torch.randn(n, t, 3 * 8 * d, device=cuda, generator=g).bfloat16()
    q, k, v = qkv.chunk(3, dim=-1)
    got = short_attention_packed(q, k, v, 8, kv_len=kv_len)
    assert_close_scaled(got, short_attention_plain(q, k, v, 8, kv_len=kv_len))


@pytest.mark.cuda
@pytest.mark.parametrize("separate", [False, True])
def test_cuda_short_at_the_l0_site(cuda, separate):
    """The L0 temporal site (N 31104, T 13, C 320, 8 heads) on the fused
    projection's views, and on three separate contiguous tensors (ld = C)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    qkv = torch.randn(6 * 72 * 72, 13, 3 * 320, device=cuda, generator=g).bfloat16()
    q, k, v = qkv.chunk(3, dim=-1)
    if separate:
        q, k, v = (x.contiguous() for x in (q, k, v))
    before = short_attention_packed.launches
    got = short_attention_packed(q, k, v, 8)
    assert short_attention_packed.launches == before + 1
    assert_close_scaled(got, short_attention_plain(q, k, v, 8))


def _ulp(x: torch.Tensor, mantissa_bits: int) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - mantissa_bits)


def assert_gn_apply_close(got, want, x, scale):
    """Within one bf16 ulp of the output plus one float32 ulp of x * scale."""
    product = (x.float() * scale[:, :, None]).transpose(1, 2)
    bound = _ulp(want.float(), 7) + _ulp(product, 23)
    assert ((got.float() - want.float()).abs() <= bound).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,hw,c", [(6, 13, 5184, 320), (6, 13, 1296, 640), (6, 13, 324, 1280),
                                      (6, 13, 81, 1280), (2, 13, 5184, 320), (1, 5, 7, 8)])
def test_cuda_pivots_match_plain(cuda, b, t, hw, c):
    """K5 and K7 bit for bit, K6 within its rounding bound, at the temporal
    sites of the paths (HW 5184 and 81 are not multiples of 128) and at a
    ragged small shape; x is a strided view (a pixel slice of a wider video)
    and scale/shift are broadcast over T, as the temporal transformer gives
    them."""
    g = torch.Generator(device=cuda).manual_seed(0)
    wide = torch.randn(b, t, hw + 8, c, device=cuda, generator=g).bfloat16()
    x = wide[:, :, 4:hw + 4]
    scale, shift = (torch.randn(b, 1, c, device=cuda, generator=g).expand(b, t, c)
                    for _ in range(2))
    counts = (pivot_rows.launches, pivot_rows.gn_launches, unpivot_rows.launches)
    assert torch.equal(pivot_rows(x), pivot_rows_plain(x))
    assert_gn_apply_close(pivot_rows(x, scale, shift), pivot_rows_plain(x, scale, shift), x, scale)
    y = torch.randn(b, hw, t, c, device=cuda, generator=g).bfloat16()
    assert torch.equal(unpivot_rows(y), unpivot_rows_plain(y))
    assert (pivot_rows.launches, pivot_rows.gn_launches, unpivot_rows.launches) == tuple(
        n + 1 for n in counts)


@pytest.mark.cuda
def test_cuda_pivots_take_float32(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 3, 50, 16, device=cuda, generator=g)
    scale, shift = (torch.randn(2, 3, 16, device=cuda, generator=g) for _ in range(2))
    assert torch.equal(pivot_rows(x), pivot_rows_plain(x))
    want = pivot_rows_plain(x, scale, shift)
    bound = _ulp(want, 23) + _ulp((x * scale[:, :, None]).transpose(1, 2), 23)
    assert ((pivot_rows(x, scale, shift) - want).abs() <= bound).all()
    assert torch.equal(unpivot_rows(x), unpivot_rows_plain(x))


@pytest.mark.cuda
def test_cuda_pivots_raise_instead_of_falling_back(cuda):
    odd = torch.zeros(2, 13, 81, 12, device=cuda, dtype=torch.bfloat16)  # C not a multiple of 8
    with pytest.raises(ValueError, match="multiple of 8"):
        pivot_rows(odd)
    with pytest.raises(ValueError, match="multiple of 8"):
        unpivot_rows(odd)
    with pytest.raises(TypeError):
        pivot_rows(torch.zeros(2, 13, 81, 16, device=cuda, dtype=torch.float16))
    x = torch.zeros(2, 13, 81, 24, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        pivot_rows(x[..., 4:20])  # rows not 16-byte aligned


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,d,part", [
    (1100, 1100, 40, None), (1100, 2200, 40, None), (600, 77, 40, None), (700, 1400, 80, None),
    (520, 300, 160, None),
    (324, 77, 160, None), (81, 81, 160, None),  # L2 / L3 sites: fewer rows than a chunk
    (1100, 2200, 40, 1024),  # the split-merge route's parts
])
def test_cuda_training_attention_grads_match_plain(cuda, sq, sk, d, part):
    """The training route (``mem_efficient_sdpa``: the flash kernel with
    stats forward, whole or over KV parts, the chunked float32 backward)
    against autograd through the plain attention in float32, at the training
    path's head dims and at query lengths below one chunk; the kernel's stats
    give the natural-log lse."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(2, sq, 2 * d, device=cuda, generator=g, dtype=torch.bfloat16)
    kv = torch.randn(2, sk, 4 * d, device=cuda, generator=g, dtype=torch.bfloat16)
    do = torch.randn(2, sq, 2, d, device=cuda, generator=g)
    q.requires_grad_()
    kv.requires_grad_()
    k, v = (t.unflatten(-1, (2, d)) for t in kv.chunk(2, dim=-1))
    before = (MemEfficientAttention.launches, flash_attention_parts.launches)
    if part is None:
        out = flash_attention(q.unflatten(-1, (2, d)), k, v)
    else:
        out = flash_attention_parts(q.unflatten(-1, (2, d)), k, v, part=part)
    assert type(out.grad_fn).__name__ == "MemEfficientAttentionBackward"
    launched = (MemEfficientAttention.launches - before[0],
                flash_attention_parts.launches - before[1])
    assert launched == ((1, 0) if part is None else (0, -(-sk // part)))
    out.backward(do.bfloat16())
    got = (out, q.grad, kv.grad)
    q32, kv32 = (t.detach().float().requires_grad_() for t in (q, kv))
    k32, v32 = (t.unflatten(-1, (2, d)) for t in kv32.chunk(2, dim=-1))
    want = flash_attention_plain(q32.unflatten(-1, (2, d)), k32, v32)
    want.backward(do.bfloat16().float())
    for a, b in zip(got, (want, q32.grad, kv32.grad)):
        assert_close_scaled(a, b)
    _, m, l = _launch(q.detach().unflatten(-1, (2, d)), k.detach(), v.detach(), None,
                      with_stats=True)
    logits = torch.einsum("bqhd,bkhd->bqhk", q32.unflatten(-1, (2, d)), k32) * d**-0.5
    lse = torch.logsumexp(logits, dim=-1)
    assert ((natural_lse(m, l) - lse).abs() / lse.abs().clamp_min(1)).max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,kv_len", [(5184, 320, None), (1296, 640, None), (81, 1280, 10)])
def test_cuda_short_attention_grads_match_plain(cuda, n, c, kv_len):
    """K4 under autograd at the temporal transformers' sites (T = 13, 8
    heads; views of one fused projection): the kernel's forward, the float32
    recompute's backward, against autograd through the plain version in
    float32."""
    g = torch.Generator(device=cuda).manual_seed(10)
    qkv = torch.randn(n, 13, 3 * c, device=cuda, generator=g, dtype=torch.bfloat16)
    do = torch.randn(n, 13, c, device=cuda, generator=g).bfloat16()
    qkv.requires_grad_()
    before = short_attention_packed.launches
    out = short_attention_packed(*qkv.chunk(3, dim=-1), 8, kv_len=kv_len)
    assert short_attention_packed.launches == before + 1
    assert type(out.grad_fn).__name__ == "_ShortAttentionBackward"
    out.backward(do)
    qkv32 = qkv.detach().float().requires_grad_()
    want = short_attention_plain(*qkv32.chunk(3, dim=-1), 8, kv_len=kv_len)
    want.backward(do.float())
    assert_close_scaled(out, want)
    assert_close_scaled(qkv.grad, qkv32.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pivot", "unpivot", "pivot_gn"])
def test_cuda_pivot_grads_match_plain(cuda, kind):
    """The pivots under autograd on the card (K5's backward is K7 and K7's
    is K5, K6's backward K7 and float32 sums) against autograd through the
    plain versions: the moves and dx bit for bit, the sums to float32
    rounding in another order."""
    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(2, 13, 1296, 320, device=cuda, generator=g, dtype=torch.bfloat16)
    if kind == "unpivot":
        x = x.transpose(1, 2).contiguous()
    scale, shift = (torch.randn(2, 1, 320, device=cuda, generator=g) for _ in range(2))

    def run(plain):
        xs = x.clone().requires_grad_()
        ss, hs = scale.clone().requires_grad_(), shift.clone().requires_grad_()
        if kind == "pivot":
            y = pivot_rows_plain(xs) if plain else pivot_rows(xs)
        elif kind == "unpivot":
            y = unpivot_rows_plain(xs) if plain else unpivot_rows(xs)
        else:
            y = (pivot_rows_plain if plain else pivot_rows)(
                xs, ss.expand(2, 13, 320), hs.expand(2, 13, 320))
        gy = torch.randn(y.shape, device=cuda, generator=torch.Generator(
            device=cuda).manual_seed(9), dtype=torch.bfloat16)
        y.backward(gy)
        return xs.grad, ss.grad, hs.grad

    counts = (pivot_rows.launches, unpivot_rows.launches)
    dx, dscale, dshift = run(plain=False)
    launched = (pivot_rows.launches - counts[0], unpivot_rows.launches - counts[1])
    # (K5, K7) launches: forward and backward, K6's forward counted apart
    assert launched == {"pivot": (1, 1), "unpivot": (1, 1), "pivot_gn": (0, 1)}[kind]
    dx_want, dscale_want, dshift_want = run(plain=True)
    assert torch.equal(dx, dx_want)
    if kind == "pivot_gn":
        for a, b in ((dscale, dscale_want), (dshift, dshift_want)):
            assert ((a - b).norm() / b.norm()).item() <= 1e-5


@pytest.mark.cuda
def test_cuda_wrappers_under_autograd_carry_grad_fn(cuda):
    """No kernel wrapper returns an output without grad_fn to a call that
    autograd records, and each launches its own kernel: flash whole and in
    parts under ``MemEfficientAttention``, K4 under ``_ShortAttention``;
    ``flash_stream``, whose kernel writes no stats, raises."""
    qkv = torch.randn(2, 600, 3 * 80, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    q, k, v = (t.unflatten(-1, (2, 40)) for t in qkv.chunk(3, dim=-1))
    short = torch.randn(64, 13, 3 * 320, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    counters = (MemEfficientAttention, flash_attention_parts, short_attention_packed,
                flash_attention, flash_stream)
    before = [c.launches for c in counters]
    outs = [flash_attention(q, k, v), flash_attention_parts(q, k, v, part=256),
            short_attention_packed(*short.chunk(3, dim=-1), 8)]
    assert all(o.grad_fn is not None for o in outs)
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 3, 1, 0, 0]
    with pytest.raises(NotImplementedError, match="no backward"):
        flash_stream(q, k, v)


# GroupNorm sites (n, m, c, groups) of the paths: the UNet's frame rows at
# L0-L3 and its up blocks' concatenated widths (960 at 72^2, 1920 at 36^2,
# 2560 at 18^2), the temporal conv's video GroupNorm (6 window rows, 13
# frames), the T2I calls' 2 rows, the VAE decode's 16-frame segment, and the
# tensor-parallel slices of 80 and 40 channels (groups of 10)
GN_SITES = [(78, 5184, 320, 32), (78, 1296, 640, 32), (78, 324, 1280, 32), (78, 81, 1280, 32),
            (78, 5184, 960, 32), (78, 1296, 1920, 32), (78, 324, 2560, 32),
            (6, 13 * 5184, 320, 32), (2, 5184, 320, 32), (2, 81, 1280, 32),
            (16, 576 * 576, 128, 32), (78, 5184, 80, 8), (78, 5184, 40, 4)]
# LayerNorm sites (rows, c): the UNet's transformers at 320 / 640 / 1280, CLIP
# text (2 x 77 at 768), CLIP vision ViT-H (257 at 1280) and 1024 wide rows
LN_SITES = [(78 * 5184, 320), (78 * 1296, 640), (78 * 324, 1280), (2 * 77, 768), (257, 1280),
            (2 * 257, 1024)]
NORM_SLACK = 2.0**-16


def _norm_params(c, device, dtype, gen):
    w = (1 + 0.5 * torch.randn(c, device=device, generator=gen)).to(dtype)
    b = (0.5 * torch.randn(c, device=device, generator=gen)).to(dtype)
    return w, b


def assert_norm_close(got, want, mag):
    """Within one bf16 ulp at the float64 result plus NORM_SLACK of ``mag``,
    the magnitude of the terms summed."""
    bound = _ulp(want, 7) + NORM_SLACK * mag
    err = (got.double() - want).abs()
    bad = (~(err <= bound)).nonzero()[:5]
    assert len(bad) == 0, [(tuple(i), got[tuple(i)].item(), want[tuple(i)].item(),
                            bound[tuple(i)].item()) for i in bad.tolist()]


def group_norm_scale_shift_f64(x, w, b, groups):
    """GroupNorm's (N, C) scale and shift in float64."""
    n, c = x.shape[0], x.shape[-1]
    xd = x.reshape(n, -1, groups, c // groups).double()
    var, mean = torch.var_mean(xd, dim=(1, 3), correction=0, keepdim=True)
    scale = torch.rsqrt(var + 1e-5) * w.double().view(1, 1, groups, -1)
    shift = b.double().view(1, 1, groups, -1) - mean * scale
    return scale.reshape(n, c), shift.reshape(n, c)


def check_group_norm(x, w, b, groups, silu):
    """K8 against its composition in float64, twice, bit for bit between the
    two runs."""
    n, c = x.shape[0], x.shape[-1]
    got = group_norm(x, w, b, groups, 1e-5, silu=silu)
    assert torch.equal(got, group_norm(x, w, b, groups, 1e-5, silu=silu))
    xd = x.reshape(n, -1, c).double()
    scale, shift = group_norm_scale_shift_f64(x, w, b, groups)
    want = (xd * scale[:, None] + shift[:, None]).reshape(x.shape)
    # the terms summed: x * scale, and the bias and mean * scale that make the shift
    terms = b.double().abs() + (b.double() - shift).abs()
    mag = (xd.abs() * scale[:, None].abs() + terms[:, None]).reshape(x.shape)
    del xd
    if silu:
        want = torch.nn.functional.silu(want)
    assert_norm_close(got, want, mag)


@pytest.mark.cuda
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("n,m,c,groups", GN_SITES)
def test_cuda_group_norm_matches_plain(cuda, n, m, c, groups, silu):
    """K8 at every GroupNorm shape the cells launch, with SiLU on and off:
    the exact result's bf16 rounding, the same bits on every run, one
    launch counted and no plain call."""
    g = torch.Generator(device=cuda).manual_seed(n * m + c)
    x = (0.3 + torch.randn(n, m, c, device=cuda, generator=g)).bfloat16()
    w, b = _norm_params(c, cuda, torch.bfloat16, g)
    counter = "silu_launches" if silu else "launches"
    before = (getattr(group_norm, counter), group_norm.plain_calls)
    check_group_norm(x, w, b, groups, silu)
    assert (getattr(group_norm, counter), group_norm.plain_calls) == (before[0] + 2, before[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["strided video", "float32 weights"])
def test_cuda_group_norm_layouts_and_dtypes(cuda, case):
    """K8 on a strided 5-D view (the window batch's rows of a wider video),
    and with float32 weights (a float32 master under autocast)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    if case == "strided video":
        wide = torch.randn(6, 14, 18, 18, 320, device=cuda, generator=g).bfloat16()
        x, wdtype = wide[:, 1:], torch.bfloat16
    else:
        x = torch.randn(6, 13, 36, 36, 640, device=cuda, generator=g).bfloat16()
        wdtype = torch.float32
    w, b = _norm_params(x.shape[-1], cuda, wdtype, g)
    for silu in (False, True):
        check_group_norm(x, w, b, 32, silu)


@pytest.mark.cuda
@pytest.mark.parametrize("silu", [False, True])
def test_cuda_group_norm_is_stable_where_the_mean_dwarfs_the_spread(cuda, silu):
    """Mean 1024 and spread about 1 (1.5 % of the elements 8 off the mean,
    bf16's spacing at 1024): K8 against float64 within the rounding of its
    store. A one-pass float32 variance misses by several percent here."""
    g = torch.Generator(device=cuda).manual_seed(4)
    n, m, c = 4, 5184, 320
    flip = torch.rand(n, m, c, device=cuda, generator=g) < 0.015
    sign = torch.randint(0, 2, (n, m, c), device=cuda, generator=g) * 2 - 1
    x = (1024.0 + 8.0 * flip * sign).bfloat16()
    w, b = _norm_params(c, cuda, torch.bfloat16, g)
    check_group_norm(x, w, b, 32, silu)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,c,groups", [(6, 13 * 5184, 320, 32), (2, 81, 1280, 32),
                                          (78, 5184, 80, 8)])
def test_cuda_group_norm_scale_shift_matches_plain(cuda, n, m, c, groups):
    """K8's statistics alone (the temporal transformer's scale and shift for
    K6) against float64, within NORM_SLACK."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(n, 13, m // 13, c, device=cuda, generator=g).bfloat16() if m % 13 == 0 \
        else torch.randn(n, m, c, device=cuda, generator=g).bfloat16()
    w, b = _norm_params(c, cuda, torch.bfloat16, g)
    before = group_norm_scale_shift.launches
    scale, shift = group_norm_scale_shift(x, w, b, groups, 1e-5)
    assert group_norm_scale_shift.launches == before + 1
    want_scale, want_shift = group_norm_scale_shift_f64(x, w, b, groups)
    assert scale.dtype == shift.dtype == torch.float32 and scale.shape == (n, c)
    assert ((scale - want_scale).abs() <= NORM_SLACK * want_scale.abs()).all()
    mag = b.double().abs() + (b.double() - want_shift).abs()
    assert ((shift - want_shift).abs() <= NORM_SLACK * mag).all()


def check_layer_norm(x, w, b):
    """K9 against LayerNorm in float64."""
    c = x.shape[-1]
    got = layer_norm(x, w, b, 1e-5)
    xd = x.double()
    var, mean = torch.var_mean(xd, dim=-1, correction=0, keepdim=True)
    rstd = torch.rsqrt(var + 1e-5)
    mag = (xd.abs() + mean.abs()) * rstd * w.double().abs() + b.double().abs()
    want = torch.nn.functional.layer_norm(xd, (c,), w.double(), b.double(), 1e-5)
    assert got.shape == x.shape and got.dtype == x.dtype
    assert_norm_close(got, want, mag)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c", LN_SITES)
def test_cuda_layer_norm_matches_plain(cuda, rows, c):
    """K9 at the UNet's, CLIP's and the wide rows' LayerNorm widths: one
    launch counted, no plain call, the exact result's bf16 rounding."""
    g = torch.Generator(device=cuda).manual_seed(rows + c)
    x = (0.3 + torch.randn(rows, c, device=cuda, generator=g)).bfloat16()
    w, b = _norm_params(c, cuda, torch.bfloat16, g)
    before = (layer_norm.launches, layer_norm.plain_calls)
    check_layer_norm(x, w, b)
    assert (layer_norm.launches, layer_norm.plain_calls) == (before[0] + 1, before[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["strided rows", "float32 weights", "C = 2048", "large mean"])
def test_cuda_layer_norm_layouts_dtypes_and_a_large_mean(cuda, case):
    """K9 on a view with a row stride (one half of a fused projection), with
    float32 weights (a float32 master under autocast), at its widest C (8
    vectors a lane), and on rows of mean 1024 with a spread of about 1."""
    g = torch.Generator(device=cuda).manual_seed(6)
    wdtype = torch.bfloat16
    if case == "strided rows":
        x = torch.randn(4, 300, 2 * 640, device=cuda, generator=g).bfloat16()[..., 640:]
    elif case == "float32 weights":
        x, wdtype = torch.randn(1000, 1280, device=cuda, generator=g).bfloat16(), torch.float32
    elif case == "C = 2048":
        x = torch.randn(1000, 2048, device=cuda, generator=g).bfloat16()
    else:
        flip = torch.rand(2000, 320, device=cuda, generator=g) < 0.015
        sign = torch.randint(0, 2, (2000, 320), device=cuda, generator=g) * 2 - 1
        x = (1024.0 + 8.0 * flip * sign).bfloat16()
    w, b = _norm_params(x.shape[-1], cuda, wdtype, g)
    check_layer_norm(x, w, b)


@pytest.mark.cuda
def test_cuda_norms_raise_instead_of_falling_back(cuda):
    """A dtype or C the kernels do not take raises on CUDA (x other than
    bf16, float32 x included); so do mismatched weights, unaligned rows and
    the statistics of an empty x."""
    w, b = (torch.ones(320, device=cuda, dtype=torch.bfloat16) for _ in range(2))
    for dtype in (torch.float16, torch.float32):
        bad = torch.zeros(2, 10, 320, device=cuda, dtype=dtype)
        with pytest.raises(TypeError, match="bfloat16"):
            group_norm(bad, w, b, 32, 1e-5)
        with pytest.raises(TypeError, match="bfloat16"):
            group_norm_scale_shift(bad, w, b, 32, 1e-5)
        with pytest.raises(TypeError, match="bfloat16"):
            layer_norm(bad, w, b)
    empty = torch.zeros(2, 0, 320, device=cuda, dtype=torch.bfloat16)
    assert group_norm(empty, w, b, 32, 1e-5, silu=True).shape == empty.shape
    with pytest.raises(ValueError, match="empty"):
        group_norm_scale_shift(empty, w, b, 32, 1e-5)
    odd = torch.zeros(2, 10, 12, device=cuda, dtype=torch.bfloat16)
    w12, b12 = (torch.ones(12, device=cuda, dtype=torch.bfloat16) for _ in range(2))
    with pytest.raises(ValueError, match="multiple of 8"):
        group_norm(odd, w12, b12, 4, 1e-5, silu=True)
    with pytest.raises(ValueError, match="multiple of 8"):
        layer_norm(odd, w12, b12)
    x = torch.zeros(2, 10, 320, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not divisible"):
        group_norm(x, w, b, 24, 1e-5)
    with pytest.raises(ValueError, match="weight"):
        group_norm(x, w[:160], b, 32, 1e-5)
    with pytest.raises(ValueError, match="bias"):
        layer_norm(x, w, b.float())
    wide = torch.zeros(2, 10, 2056, device=cuda, dtype=torch.bfloat16)
    w_wide = torch.ones(2056, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="more than 2048"):
        layer_norm(wide, w_wide, w_wide)
    with pytest.raises(ValueError, match="aligned"):
        layer_norm(torch.zeros(2, 10, 336, device=cuda, dtype=torch.bfloat16)[..., 4:324], w, b)


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.bfloat16, torch.float32])
def test_cuda_norms_under_autograd_launch_and_backpropagate(cuda, wdtype):
    """Under autograd on CUDA each norm launches its kernel (counted, no
    plain call) inside its ``autograd.Function``: the output has a grad_fn,
    equals the launch without autograd bit for bit, and gives x, weight and
    bias autograd's gradients through the plain composition, on bf16 weights
    and on float32 ones (training's masters under autocast)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(2, 64, 320, device=cuda, generator=g).bfloat16().requires_grad_(True)
    w, b = (p.to(wdtype).requires_grad_(True) for p in _norm_params(320, cuda, torch.float32, g))
    calls = [
        ((group_norm, "silu_launches"), lambda *a: group_norm(*a, 32, 1e-5, silu=True),
         lambda *a: group_norm_plain(*a, 32, 1e-5, silu=True)),
        ((group_norm_scale_shift, "launches"), lambda *a: group_norm_scale_shift(*a, 32, 1e-5),
         lambda *a: group_norm_scale_shift_plain(*a, 32, 1e-5)),
        ((layer_norm, "launches"), lambda *a: layer_norm(*a, 1e-5),
         lambda *a: layer_norm_plain(*a, 1e-5)),
    ]
    for (fn, counter), call, plain in calls:
        before = (getattr(fn, counter), fn.plain_calls)
        out = call(x, w, b)
        assert (getattr(fn, counter), fn.plain_calls) == (before[0] + 1, before[1])
        outs = out if isinstance(out, tuple) else (out,)
        with torch.no_grad():
            again = call(x, w, b)
        for o, a in zip(outs, again if isinstance(again, tuple) else (again,)):
            assert o.grad_fn is not None and torch.equal(o, a)
        ups = [torch.randn(o.shape, device=cuda, generator=g).to(o.dtype) for o in outs]
        got = torch.autograd.grad(outs, (x, w, b), ups)
        want = plain(x, w, b)
        want = torch.autograd.grad(want if isinstance(want, tuple) else (want,), (x, w, b), ups)
        for got_, want_ in zip(got, want):
            assert got_.dtype == want_.dtype
            torch.testing.assert_close(got_, want_)
