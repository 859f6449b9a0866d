"""The port's norm dispatch (K8 GroupNorm(+SiLU), K9 LayerNorm) on the CPU.

CPU tensors, recorded by autograd or not, take the plain float32
composition (``ops/kernels/norm.py``); the CUDA kernels are held against it
on the card in ``tests/test_torch_cuda.py``. Here: the route and its
counters, the backward of a recorded kernel call (autograd's through the
plain version, recomputed), the fused-SiLU entry of the plain route against
the SiLU of the GroupNorm, the statistics' stability against float64 where
the mean is a thousand times the spread (a one-pass E[x^2] - E[x]^2 in
float32 misses by more than 1 there), and the kernels' launch plan at the
paths' shapes.
"""

import pytest
import torch
import torch.nn.functional as F

from musev_torch.models.common import GroupNorm, LayerNorm
from musev_torch.ops.kernels import norm

# float32 statistics of a float32 input against float64: the two-pass
# variance of the plain route misses by under 4e-4 at unit scale (outputs
# scaled by weights up to ~3); a one-pass variance misses by over 1
STABLE_ATOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: torch's OpenMP pool spun
    against the suite's other xdist workers. Restored after, as the setting
    is the process's and JAX shares it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(shape, seed=0, mean=0.0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    c = shape[-1]
    x = (mean + torch.randn(*shape, generator=g, dtype=torch.float64)).to(dtype)
    w = torch.randn(c, generator=g).to(dtype)
    b = torch.randn(c, generator=g).to(dtype)
    return x, w, b


def _counts():
    return dict(gn=norm.group_norm.launches, gn_silu=norm.group_norm.silu_launches,
                gn_plain=norm.group_norm.plain_calls,
                ss=norm.group_norm_scale_shift.launches,
                ss_plain=norm.group_norm_scale_shift.plain_calls,
                ln=norm.layer_norm.launches, ln_plain=norm.layer_norm.plain_calls)


# kind: (call, its plain version, the plain version's extra arguments, the
# counter of its plain calls)
CALLS = {
    "group_norm": (lambda x, w, b: norm.group_norm(x, w, b, 4, 1e-6),
                   norm.group_norm_plain, (4, 1e-6, False), "gn_plain"),
    "group_norm_silu": (lambda x, w, b: norm.group_norm(x, w, b, 4, 1e-6, silu=True),
                        norm.group_norm_plain, (4, 1e-6, True), "gn_plain"),
    "group_norm_scale_shift": (lambda x, w, b: norm.group_norm_scale_shift(x, w, b, 4, 1e-6),
                               norm.group_norm_scale_shift_plain, (4, 1e-6), "ss_plain"),
    "layer_norm": (lambda x, w, b: norm.layer_norm(x, w, b, 1e-5),
                   norm.layer_norm_plain, (1e-5,), "ln_plain"),
}


@pytest.mark.parametrize("route", ["cpu", "records"])
@pytest.mark.parametrize("kind", list(CALLS))
def test_cpu_calls_take_the_plain_route(kind, route):
    """A CPU tensor, recorded by autograd or not, runs the plain version
    (the same numbers bit for bit) and counts one plain call and no launch;
    the recorded call's output carries its grad_fn and back-propagates."""
    call, plain_fn, args, counter = CALLS[kind]
    plain = lambda x, w, b: plain_fn(x, w, b, *args)  # noqa: E731
    x, w, b = _inputs((2, 3, 5, 16))
    if route == "records":
        w.requires_grad_(True)
    before = _counts()
    got = call(x, w, b)
    after = _counts()
    want = plain(x, w, b)
    for g_, w_ in zip(got if isinstance(got, tuple) else (got,),
                      want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g_, w_)
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == counter) for k in after}
    if route == "records":
        out = got[0] if isinstance(got, tuple) else got
        assert out.grad_fn is not None
        out.square().sum().backward()
        assert w.grad is not None and torch.isfinite(w.grad).all()


@pytest.mark.parametrize("wdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", list(CALLS))
def test_recorded_launch_backpropagates_through_the_plain_version(kind, wdtype):
    """A kernel call that autograd records (``_Recorded``, the CUDA route
    under autograd; here with the plain version standing in for the launch,
    which like a kernel's output leaves no history) gives x, weight and bias
    the gradients of autograd through the plain version, bit for bit, on bf16
    x with bf16 weights or float32 ones (training's masters under
    autocast), also inside an autocast region; an input that needs no grad
    gets none."""
    _, plain, args, _ = CALLS[kind]
    x, w, b = _inputs((2, 3, 5, 16), seed=3, dtype=torch.bfloat16)
    w, b = w.to(wdtype), b.to(wdtype)
    for t in (x, w):
        t.requires_grad_(True)
    g = torch.Generator().manual_seed(4)

    def loss(out):
        outs = out if isinstance(out, tuple) else (out,)
        return sum((o.float() * torch.randn(o.shape, generator=g)).sum() for o in outs)

    g.manual_seed(4)
    want = torch.autograd.grad(loss(plain(x, w, b, *args)), (x, w))
    g.manual_seed(4)
    with torch.autocast("cpu", torch.bfloat16):
        out = norm._Recorded.apply(plain, plain, x, w, b, *args)
    assert all(o.grad_fn is not None for o in (out if isinstance(out, tuple) else (out,)))
    got = torch.autograd.grad(loss(out), (x, w))
    for got_, want_ in zip(got, want):
        assert got_.dtype == want_.dtype and torch.equal(got_, want_)
    assert b.grad is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", [((2, 4, 4, 32), 8), ((3, 2, 5, 5, 40), 4),
                                          ((1, 7, 12), 3)])
def test_fused_silu_entry_equals_silu_of_the_group_norm(shape, groups, dtype):
    """``group_norm(..., silu=True)`` and ``GroupNorm(x, silu=True)`` on the
    plain route are ``F.silu`` of the GroupNorm, bit for bit, in the
    activation dtype (the SiLU applies to the cast-back output)."""
    x, w, b = _inputs(shape, seed=1, dtype=dtype)
    want = F.silu(norm.group_norm(x, w, b, groups, 1e-5))
    assert torch.equal(norm.group_norm(x, w, b, groups, 1e-5, silu=True), want)
    mod = GroupNorm(groups, shape[-1]).to(dtype)
    with torch.no_grad():
        mod.weight.copy_(w)
        mod.bias.copy_(b)
        assert torch.equal(mod(x, silu=True), F.silu(mod(x)))
        assert torch.equal(mod(x, silu=True), want)


def _group_norm_f64(x, w, b, groups, eps):
    n, c = x.shape[0], x.shape[-1]
    xf = x.double().reshape(n, -1, groups, c // groups)
    var, mean = torch.var_mean(xf, dim=(1, 3), correction=0, keepdim=True)
    y = ((xf - mean) / torch.sqrt(var + eps)).reshape(n, -1, c)
    return (y * w.double() + b.double()).reshape(x.shape)


@pytest.mark.parametrize("kind", ["group_norm", "group_norm_silu", "layer_norm"])
@pytest.mark.parametrize("shape,groups", [((2, 64, 8, 32), 8), ((3, 500, 40), 4)])
def test_norms_are_stable_where_the_mean_dwarfs_the_spread(kind, shape, groups):
    """Inputs of mean 1e3 and unit spread (float32 holds them to 6e-5):
    the plain route's float32 statistics against float64 within
    STABLE_ATOL."""
    x, w, b = _inputs(shape, seed=2, mean=1e3)
    if kind == "layer_norm":
        got = LayerNorm(shape[-1])
        with torch.no_grad():
            got.weight.copy_(w)
            got.bias.copy_(b)
            got = got(x)
        want = F.layer_norm(x.double(), (shape[-1],), w.double(), b.double(), 1e-5)
    else:
        silu = kind == "group_norm_silu"
        got = norm.group_norm(x, w, b, groups, 1e-5, silu=silu)
        want = _group_norm_f64(x, w, b, groups, 1e-5)
        want = F.silu(want) if silu else want
    err = (got.double() - want).abs().max().item()
    assert err <= STABLE_ATOL, err


# (n, m, c): the paths' GroupNorm sites: the UNet's frame rows at L0 and L3,
# its up blocks' widest concatenation, the temporal conv's video, a T2I call,
# the VAE decode's 16-frame segment and the encode's one image, a TP slice
SITES = [(78, 5184, 320), (78, 81, 1280), (78, 81, 2560), (6, 13 * 5184, 320), (2, 5184, 320),
         (2, 81, 1280), (16, 576 * 576, 128), (1, 576 * 576, 128), (78, 5184, 80)]


@pytest.mark.parametrize("n,m,c", SITES)
def test_group_norm_plan_fills_the_card_and_bounds_the_merge(n, m, c):
    """On 132 SMs: every block's rows are whole steps of its threads' rows;
    a sample's statistics blocks are at most MAX_SPLITS; the apply launch
    has at least as many blocks as SMs wherever the rows allow."""
    sms = 132
    r, rows_stats, rows_apply = norm.plan_rows(n, m, c, sms)
    assert r >= 1 and r * c <= norm.BLOCK_ELEMS and (r + 1) * c > norm.BLOCK_ELEMS
    assert rows_apply % r == 0 and rows_stats >= rows_apply
    assert -(-m // rows_stats) <= norm.MAX_SPLITS
    assert n * -(-m // rows_apply) >= min(sms, n * -(-m // r))


def test_norms_check_their_arguments():
    x, w, b = _inputs((2, 3, 12))
    with pytest.raises(ValueError, match="not divisible"):
        norm.group_norm(x, w, b, 5, 1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        norm.group_norm_scale_shift(x, w, b, 5, 1e-5)
    for bad in (x, x.half()):  # the kernels take bf16 x alone
        with pytest.raises(TypeError, match="bfloat16"):
            norm._check_x("group_norm", bad, norm.BLOCK_ELEMS)
    with pytest.raises(ValueError, match="more than 2048"):
        norm._check_x("layer_norm", torch.zeros(2, 2056, dtype=torch.bfloat16),
                      norm.MAX_LN_CHANNELS)
    meta = x.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        norm.group_norm(meta, w, b, 4, 1e-5)
    with pytest.raises(ValueError, match="unsupported device"):
        norm.layer_norm(meta, w, b)


def test_first_load_builds_every_source_at_once(monkeypatch):
    """The first load of any kernel library starts nvcc for every source not
    built yet, together, so the norms' source compiles alongside the others
    and a cold start waits for the slowest one."""
    from musev_torch.ops.kernels import _build

    asked = []

    def build(names):
        asked.append(tuple(names))
        raise RuntimeError("stop before loading")

    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="stop before loading"):
        _build.load("norm")
    assert asked == [_build.SOURCES]
    assert set(_build.SOURCES) == {"flash_attention", "flash_stream", "norm", "pivot",
                                   "short_attention"}
