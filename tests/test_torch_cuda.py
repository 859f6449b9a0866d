"""The port's CUDA kernels against their plain versions, on the card.

Imports nothing of JAX, so it runs where JAX is absent:
``python -m pytest --noconftest -p no:randomly -m cuda tests/test_torch_cuda.py``.
Without a CUDA device every test skips. The inputs are column views of one
fused projection, as ``Attention.project`` makes them. Tolerances are scaled
to what is compared: the kernels round P and the output to bf16 (relative
rounding error up to 2^-9 per element), the plain versions keep float32
throughout, so the relative L2 error must stay under 1e-2 and the largest
error under 2e-2 of the largest output.
"""

import pytest
import torch

from musev_torch.ops.kernels.flash_attention import (
    _launch,
    flash_attention,
    flash_attention_parts,
    flash_attention_plain,
    flash_attention_stats_plain,
)
from musev_torch.ops.kernels.flash_stream import flash_stream
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
    p = torch.zeros(4, 13, 48, device=cuda)
    with pytest.raises(TypeError):
        short_attention_packed(p, p, p, 4)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "fused,sq,sk,d", [(2, 100, 77, 40), (2, 130, 1000, 80), (3, 200, 200, 40), (1, 33, 300, 512)]
)
def test_cuda_flash_matches_plain(cuda, fused, sq, sk, d):
    """``fused`` projections share one product: 3 = q|k|v (self-attention),
    2 = k|v beside q (ReferenceOnly, cross-attention), 1 = none (VAE)."""
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


def _views(cuda, sq, sk, d, heads=2):
    """q beside a fused k|v product, as the ReferenceNet fuse and the
    ReferenceOnly cond half lay them out."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(2, sq, heads * d, device=cuda, generator=g).bfloat16()
    kv = torch.randn(2, sk, 2 * heads * d, device=cuda, generator=g).bfloat16()
    k, v = kv.chunk(2, dim=-1)
    return tuple(t.unflatten(-1, (heads, d)) for t in (q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,d", [(100, 300, 40), (70, 129, 80), (33, 200, 512)])
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
@pytest.mark.parametrize("sk,d,part", [(1100, 40, 512), (600, 512, 256), (300, 80, 4096)])
def test_cuda_parts_match_plain(cuda, sk, d, part):
    q, k, v = _views(cuda, 77, sk, d)
    before = flash_attention_parts.launches
    got = flash_attention_parts(q, k, v, part=part)
    assert flash_attention_parts.launches - before == -(-sk // part)
    assert_close_scaled(got, flash_attention_plain(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,d", [(100, 1100, 40), (257, 257, 80), (130, 70, 160), (5, 3, 40)])
def test_cuda_flash_stream_matches_plain(cuda, sq, sk, d):
    q, k, v = _views(cuda, sq, sk, d)
    assert_close_scaled(flash_stream(q, k, v), flash_attention_plain(q, k, v))
    with pytest.raises(ValueError):
        flash_stream(*(torch.zeros(1, 8, 1, 512, device=cuda, dtype=torch.bfloat16),) * 3)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_len", [None, 10])
def test_cuda_short_matches_plain(cuda, kv_len):
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(50, 13, 3 * 320, device=cuda, generator=g).bfloat16()
    q, k, v = qkv.chunk(3, dim=-1)
    got = short_attention_packed(q, k, v, 8, kv_len=kv_len)
    assert_close_scaled(got, short_attention_plain(q, k, v, 8, kv_len=kv_len))
