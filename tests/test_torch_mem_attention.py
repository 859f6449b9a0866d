"""The port's training routes through its kernels, against autograd and JAX.

``MemEfficientAttention`` (the counterpart of ``_mem_efficient_sdpa``) against
autograd through the plain attention and against ``jax.grad`` of the JAX
package's ``_xla_chunked_sdpa``, at query lengths that are not a multiple of
the chunk, whole and over KV parts; ``sdpa``'s route by the autograd state;
every kernel wrapper's output carries a ``grad_fn`` when autograd records the
call; the packed short attention's ``_ShortAttention`` and the pivots' grads
against autograd through their plain versions. Inputs come from a
seeded numpy RNG; float32 on the CPU (the bf16 rows are the pivots', which
compute nothing in bf16 but the cast). Tolerance 1e-5 for the attention
(float32 rounding in another summation order), bit for bit for the pivots
and their x-gradient, 1e-6 relative for the GroupNorm apply's float32 sums
over the pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import musev_tpu.ops.attention as JA
import musev_torch.ops.attention as A
from musev_torch.ops.kernels import records
from musev_torch.ops.kernels.flash_attention import (
    flash_attention,
    flash_attention_parts,
    flash_attention_plain,
)
from musev_torch.ops.kernels.flash_stream import flash_stream
from musev_torch.ops.kernels.pivot import pivot_rows, pivot_rows_plain, unpivot_rows
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


TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _leaves(*arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


# (sq, sk, chunk): one whole chunk plus 8 rows at the JAX package's 512; and
# two whole chunks plus a ragged 4 at a chunk of 8
CASES = [(520, 40, 512), (20, 13, 8)]


@pytest.mark.parametrize("sq,sk,chunk", CASES, ids=["chunk512", "chunk8"])
def test_mem_efficient_grads_match_autograd_and_jax(monkeypatch, sq, sk, chunk):
    monkeypatch.setattr(A, "TRAIN_CHUNK", chunk)
    monkeypatch.setattr(JA, "_TRAIN_CHUNK", chunk)
    b, h, d = 2, 2, 8
    q, k, v = _rand(0, b, sq, h, d), _rand(1, b, sk, h, d), _rand(2, b, sk, h, d)
    co = _rand(3, b, sq, h, d)

    def j_loss(q_, k_, v_):
        return jnp.sum(JA._xla_chunked_sdpa(q_, k_, v_) * co)

    j_out = np.asarray(JA._xla_chunked_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    j_grads = jax.grad(j_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    got = _leaves(q, k, v)
    out = A.mem_efficient_sdpa(*got)
    assert type(out.grad_fn).__name__ == "MemEfficientAttentionBackward"
    (out * torch.from_numpy(co)).sum().backward()
    plain = _leaves(q, k, v)
    want = flash_attention_plain(*plain)
    (want * torch.from_numpy(co)).sum().backward()

    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(), **TOL)
    np.testing.assert_allclose(out.detach().numpy(), j_out, **TOL)
    for g, p, j in zip(got, plain, j_grads):
        np.testing.assert_allclose(g.grad.numpy(), p.grad.numpy(), **TOL)
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(j), **TOL)


def test_mem_efficient_ignores_autocast():
    """Forward and backward in float32 under a bf16 autocast too, as a
    training step that calls backward inside autocast runs them."""
    q, k, v = _leaves(_rand(0, 1, 20, 2, 8), _rand(1, 1, 13, 2, 8), _rand(2, 1, 13, 2, 8))
    co = torch.from_numpy(_rand(3, 1, 20, 2, 8))
    results = []
    for enabled in (False, True):
        with torch.autocast("cpu", torch.bfloat16, enabled=enabled):
            out = A.mem_efficient_sdpa(q, k, v)
            grads = torch.autograd.grad((out * co).sum(), (q, k, v))
        results.append((out, *grads))
    for a, b in zip(*results):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def test_chunk_fwd_lse_is_the_natural_log_sum_exp():
    q, k, v = (torch.from_numpy(_rand(i, 1, 30, 2, 8)) for i in range(3))
    out, lse = A._chunk_fwd(q, k, v, 0.3)
    logits = torch.einsum("bqhd,bkhd->bqhk", q, k) * 0.3
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(logits, -1).numpy(), **TOL)
    np.testing.assert_allclose(out.numpy(), flash_attention_plain(q, k, v, 0.3).numpy(), **TOL)


@pytest.mark.parametrize("sq,bias,chunked", [
    (520, False, True),  # the JAX package's _xla_chunked_sdpa
    (300, False, True),  # fewer rows than a chunk: the kernels' route all the same
    (520, True, False),  # a bias: the plain path (_xla_sdpa)
], ids=["chunked", "short_q", "bias"])
def test_sdpa_routes_by_autograd_state(sq, bias, chunked):
    q, k, v = _leaves(_rand(0, 1, sq, 2, 8), _rand(1, 1, 16, 2, 8), _rand(2, 1, 16, 2, 8))
    b = torch.zeros(1, 1, 1, 16) if bias else None
    out = A.sdpa(q, k, v, bias=b)
    assert out.grad_fn is not None
    assert (type(out.grad_fn).__name__ == "MemEfficientAttentionBackward") == chunked
    with torch.no_grad():
        assert A.sdpa(q, k, v, bias=b).grad_fn is None
        assert not records(q)
    frozen = [x.detach() for x in (q, k, v)]
    assert A.sdpa(*frozen, bias=b).grad_fn is None  # nothing requires grad


@pytest.mark.parametrize("sq,sk,part", [(20, 13, 5), (520, 40, 16)])
def test_parts_route_grads_match_autograd(sq, sk, part):
    """``flash_attention_parts`` under autograd: the parts' stats merged into
    the lse that the chunked backward takes, against the plain attention."""
    q, k, v = _rand(0, 2, sq, 2, 8), _rand(1, 2, sk, 2, 8), _rand(2, 2, sk, 2, 8)
    co = torch.from_numpy(_rand(3, 2, sq, 2, 8))
    got = _leaves(q, k, v)
    out = flash_attention_parts(*got, part=part)
    assert type(out.grad_fn).__name__ == "MemEfficientAttentionBackward"
    (out * co).sum().backward()
    plain = _leaves(q, k, v)
    want = flash_attention_plain(*plain)
    (want * co).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(), **TOL)
    for g, p in zip(got, plain):
        np.testing.assert_allclose(g.grad.numpy(), p.grad.numpy(), **TOL)


@pytest.mark.parametrize("kv_len", [None, 5])
def test_short_attention_grads_equal_autograd_through_the_plain_version(kv_len):
    """``_ShortAttention``'s float32 recompute against autograd through
    ``short_attention_plain`` on the fused projection's views: bit for bit."""
    qkv = _rand(0, 6, 13, 3 * 16)
    co = torch.from_numpy(_rand(1, 6, 13, 16))

    def run(fn):
        x = torch.from_numpy(qkv).requires_grad_()
        out = fn(*x.chunk(3, dim=-1), 2, kv_len=kv_len)
        (out * co).sum().backward()
        return out, x.grad

    out, grad = run(short_attention_packed)
    assert type(out.grad_fn).__name__ == "_ShortAttentionBackward"
    want, want_grad = run(short_attention_plain)
    assert torch.equal(out, want)
    assert torch.equal(grad, want_grad)


def _kernel_calls():
    qkv = _rand(0, 2, 12, 3 * 16)
    x = _rand(1, 2, 3, 5, 8)
    scale, shift = _rand(2, 2, 1, 8), _rand(3, 2, 1, 8)

    def attn(fn, **kw):
        def call():
            q, k, v = (t.unflatten(-1, (2, 8)) for t in
                       torch.from_numpy(qkv).requires_grad_().chunk(3, dim=-1))
            return fn(q, k, v, **kw)
        return call

    def short():
        q, k, v = torch.from_numpy(qkv).requires_grad_().chunk(3, dim=-1)
        return short_attention_packed(q, k, v, 2)

    def gn():
        s = torch.from_numpy(scale).requires_grad_()
        return pivot_rows(torch.from_numpy(x), s.expand(2, 3, 8),
                          torch.from_numpy(shift).expand(2, 3, 8))

    return {
        "flash_attention": attn(flash_attention),
        "flash_attention_parts": attn(flash_attention_parts, part=5),
        "flash_stream": attn(flash_stream),
        "short_attention_packed": short,
        "pivot_rows": lambda: pivot_rows(torch.from_numpy(x).requires_grad_()),
        "pivot_rows_gn (scale requires grad)": gn,
        "unpivot_rows": lambda: unpivot_rows(torch.from_numpy(x).requires_grad_()),
    }


@pytest.mark.parametrize("name", list(_kernel_calls()))
def test_kernel_wrappers_carry_grad_fn(name):
    call = _kernel_calls()[name]
    out = call()
    assert out.requires_grad and out.grad_fn is not None
    out.float().square().sum().backward()
    with torch.no_grad():
        assert call().grad_fn is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["pivot", "unpivot", "pivot_gn"])
def test_pivot_grads_equal_autograd_through_the_plain_version(kind, dtype):
    """K5 (backward K7), K7 (backward K5) and K6 (backward K7 and the
    float32 sums) against autograd through ``pivot_rows_plain``."""
    x = torch.from_numpy(_rand(0, 2, 3, 10, 8)).to(dtype)
    scale, shift = (torch.from_numpy(_rand(i, 2, 1, 8)) for i in (2, 3))
    if kind == "unpivot":  # (b, HW, T, C) -> (b, T, HW, C)
        x = x.transpose(1, 2).contiguous()

    def run(plain):
        xs = x.clone().requires_grad_()
        ss, hs = scale.clone().requires_grad_(), shift.clone().requires_grad_()
        if kind == "pivot":
            y = pivot_rows_plain(xs) if plain else pivot_rows(xs)
        elif kind == "unpivot":
            y = xs.transpose(1, 2).contiguous() if plain else unpivot_rows(xs)
        else:
            fn = pivot_rows_plain if plain else pivot_rows
            y = fn(xs, ss.expand(2, 3, 8), hs.expand(2, 3, 8))
        g = torch.from_numpy(_rand(1, *y.shape)).to(dtype)
        (y * g).sum().backward()
        return y, xs.grad, ss.grad, hs.grad

    y, dx, dscale, dshift = run(plain=False)
    y_want, dx_want, dscale_want, dshift_want = run(plain=True)
    names = {"pivot": "_PivotBackward", "unpivot": "_UnpivotBackward",
             "pivot_gn": "_PivotGNBackward"}
    assert type(y.grad_fn).__name__ == names[kind]
    assert torch.equal(y, y_want)
    assert torch.equal(dx, dx_want)
    if kind == "pivot_gn":
        np.testing.assert_allclose(dscale.numpy(), dscale_want.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(dshift.numpy(), dshift_want.numpy(), rtol=1e-6, atol=1e-6)
