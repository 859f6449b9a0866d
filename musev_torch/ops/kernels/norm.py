"""GroupNorm (optionally fused with SiLU) and LayerNorm: the CUDA kernels and their plain versions.

The kernels (``csrc/norm.cu``) replace no TPU kernel: the JAX package leaves
its norms to XLA. They take the port's bf16 activations through one read
(LayerNorm) or two (GroupNorm: statistics, then the apply) and one write,
with the statistics and the affine in float32 registers, where the plain
versions make a float32 copy, take ``var_mean``, apply the affine in float32,
cast back and run SiLU as a pass of its own. K8 is GroupNorm (+SiLU), K9
LayerNorm. They take bf16 x, and bf16 weights or float32 ones (the float32
masters of training under autocast).

``group_norm``, ``group_norm_scale_shift`` and ``layer_norm`` take CPU
tensors to the plain versions and CUDA tensors to the kernels; on CUDA they
launch or raise, never fall back. A CUDA call that autograd records
(``records``: the training path) launches the kernel inside an
``autograd.Function`` whose backward recomputes the plain version and takes
autograd's gradients through it. ``group_norm.launches`` and
``group_norm.silu_launches`` count K8 calls without and with SiLU,
``group_norm_scale_shift.launches`` its statistics alone (the temporal
transformer's scale and shift for K6), ``layer_norm.launches`` K9 calls, and
each function's ``plain_calls`` the calls that took the plain version (CPU
tensors only).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import VEC_BYTES, _build, check_rows, records

# x elements a GroupNorm block's threads hold at once (r rows of C), and so
# GroupNorm's largest C; norm.cu refuses a plan beyond it
BLOCK_ELEMS = 4096
MAX_LN_CHANNELS = 2048  # LayerNorm's C: a warp holds the row in registers
MAX_SPLITS = 1024  # partials per (sample, group) that one warp merges
WAVE_BLOCKS = 32  # blocks per SM a GroupNorm launch aims at, for an even tail
MAX_ROW_STEPS = 16  # row steps per thread in one apply block
STATS_STEPS = 2  # a statistics block takes this many apply blocks' rows
LN_BLOCKS_PER_SM = 16  # LayerNorm's blocks of 8 warps walk the rows in a grid stride


def group_norm_scale_shift_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                                 num_groups: int, eps: float):
    """The float32 (N, C) ``scale`` and ``shift`` of GroupNorm over the last
    (channel) axis of a channels-last tensor: the normalised ``x`` is
    ``x * scale + shift`` per (n, c), statistics taken over each sample."""
    n, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"group_norm: channels {c} not divisible by groups {num_groups}")
    xf = x.reshape(n, -1, num_groups, c // num_groups).float()
    var, mean = torch.var_mean(xf, dim=(1, 3), correction=0, keepdim=True)
    scale = torch.rsqrt(var + eps) * weight.float().view(1, 1, num_groups, -1)
    shift = bias.float().view(1, 1, num_groups, -1) - mean * scale
    return scale.reshape(n, c), shift.reshape(n, c)


def group_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int,
                     eps: float, silu: bool = False) -> torch.Tensor:
    """GroupNorm over the last (channel) axis of a channels-last tensor, in
    float32, cast back to x's dtype; with ``silu`` then SiLU in that dtype."""
    n, c = x.shape[0], x.shape[-1]
    xf = x.reshape(n, -1, c).float()
    scale, shift = group_norm_scale_shift_plain(xf, weight, bias, num_groups, eps)
    y = torch.addcmul(shift[:, None], xf, scale[:, None]).reshape(x.shape).to(x.dtype)
    return F.silu(y) if silu else y


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps)
    return y.to(x.dtype)


def plan_rows(n: int, m: int, c: int, sms: int):
    """(thread rows r, rows per statistics block, rows per apply block) of
    GroupNorm over an (n, m, c) view: a block is r rows of c // 8 threads,
    which hold ``BLOCK_ELEMS`` elements at once; the apply launch aims at
    ``WAVE_BLOCKS`` blocks per SM (many short blocks leave an even tail),
    however few the samples; a statistics block takes ``STATS_STEPS`` times
    as many rows, to spread its merge over more of them, and one sample's
    are at most ``MAX_SPLITS``, so their merge stays short."""
    r = max(1, BLOCK_ELEMS // c)
    steps = min(MAX_ROW_STEPS, max(1, -(-n * m // (r * WAVE_BLOCKS * sms))))
    rows = r * steps
    return r, max(STATS_STEPS * rows, -(-m // MAX_SPLITS)), rows


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_x(name: str, x: torch.Tensor, max_c: int) -> None:
    """bf16 x, ``check_rows``, and C at most ``max_c``."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} kernel takes bfloat16 x, got {x.dtype}")
    check_rows(name, x)
    if x.shape[-1] > max_c:
        raise ValueError(f"{name} kernel: C={x.shape[-1]} is more than {max_c}")


def _check_params(name: str, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> int:
    """1 for bf16 weights, 0 for float32 (training's masters under autocast);
    raises on anything else."""
    c = x.shape[-1]
    for what, p in (("weight", weight), ("bias", bias)):
        if (p.shape != (c,) or p.dtype not in (torch.bfloat16, torch.float32)
                or p.dtype != weight.dtype or p.device != x.device or p.stride(0) != 1
                or p.data_ptr() % VEC_BYTES):
            raise ValueError(
                f"{name}: {what} must be a contiguous, aligned bfloat16 or float32 ({c},) on "
                f"{x.device} like the weight, got {p.dtype} {tuple(p.shape)} on {p.device}"
            )
    return int(weight.dtype == torch.bfloat16)


def _check_device(name: str, x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


class _Recorded(torch.autograd.Function):
    """A norm kernel's launch that autograd records: the forward is the
    kernel (``launch``), and the backward recomputes the plain version
    (``plain``, float32, autocast off) from the saved x, weight and bias and
    returns autograd's gradients through it, as ``MemEfficientAttention``'s
    backward is plain PyTorch."""

    @staticmethod
    def forward(ctx, launch, plain, x, weight, bias, *args):
        ctx.plain, ctx.args = plain, args
        ctx.save_for_backward(x, weight, bias)
        return launch(x, weight, bias, *args)

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[2:5]
        inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad(), torch.autocast(inputs[0].device.type, enabled=False):
            out = ctx.plain(*inputs, *ctx.args)
        wanted = [t for t in inputs if t.requires_grad]
        got = iter(torch.autograd.grad(out, wanted, grads))
        return (None, None, *(next(got) if need else None for need in needs),
                *(None for _ in ctx.args))


def _dispatch(launch, plain, counted, x, weight, bias, *args):
    """``plain`` on a CPU tensor (one of ``counted.plain_calls``), ``launch``
    on a CUDA one, inside ``_Recorded`` where autograd records the call."""
    if x.device.type == "cpu":
        counted.plain_calls += 1
        return plain(x, weight, bias, *args)
    if records(x, weight, bias):
        return _Recorded.apply(launch, plain, x, weight, bias, *args)
    return launch(x, weight, bias, *args)


def _gn_launch(x: torch.Tensor, weight, bias, num_groups: int, eps: float, out, silu: bool):
    """K8 on a CUDA tensor: the statistics, their merge into float32 (N, C)
    scale and shift, and (where ``out`` is given) the apply into ``out``.
    Without ``out``, returns scale and shift."""
    n, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"group_norm: channels {c} not divisible by groups {num_groups}")
    x3 = x.reshape(n, -1, c)
    _check_x("group_norm", x3, BLOCK_ELEMS)
    w_bf16 = _check_params("group_norm", x, weight, bias)
    m = x3.shape[1]
    if n > 65535:
        raise ValueError(f"group_norm kernel: {n} samples are more than one launch takes")
    if x3.numel() == 0:
        raise ValueError(f"group_norm kernel: no statistics of an empty {tuple(x.shape)}")
    r, rows_stats, rows_apply = plan_rows(n, m, c, _sms(x.device))
    splits = -(-m // rows_stats)
    # float32 scale (n, c), shift (n, c), then the blocks' (mean, M2) partials
    scratch = torch.empty(2 * n * c + n * splits * num_groups * 2, dtype=torch.float32,
                          device=x.device)
    base = scratch.data_ptr()
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        common = (w_bf16, base + 8 * n * c, base, base + 4 * n * c, n, m, c, num_groups,
                  x3.stride(0), x3.stride(1), r, rows_stats)
        if out is None:
            err = lib.musev_group_norm_scale_shift(x3.data_ptr(), weight.data_ptr(),
                                                   bias.data_ptr(), *common, eps, stream)
        else:
            err = lib.musev_group_norm(x3.data_ptr(), out.data_ptr(), weight.data_ptr(),
                                       bias.data_ptr(), *common, rows_apply, eps, int(silu),
                                       stream)
    _build.check(lib, err, "group_norm")
    return None if out is not None else (scratch[:n * c].view(n, c),
                                         scratch[n * c:2 * n * c].view(n, c))


def _group_norm_kernel(x, weight, bias, num_groups, eps, silu):
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    _gn_launch(x, weight, bias, num_groups, eps, out, silu)
    if silu:
        group_norm.silu_launches += 1
    else:
        group_norm.launches += 1
    return out


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int,
               eps: float, silu: bool = False) -> torch.Tensor:
    """GroupNorm over the last (channel) axis of a channels-last tensor,
    statistics over each sample, then SiLU where ``silu``: K8 on a CUDA
    tensor (x's dtype out, one rounding), the plain version on a CPU
    tensor."""
    _check_device("group_norm", x)
    return _dispatch(_group_norm_kernel, group_norm_plain, group_norm, x, weight, bias,
                     num_groups, eps, silu)


group_norm.launches = 0
group_norm.silu_launches = 0
group_norm.plain_calls = 0


def _scale_shift_kernel(x, weight, bias, num_groups, eps):
    scale, shift = _gn_launch(x, weight, bias, num_groups, eps, None, False)
    group_norm_scale_shift.launches += 1
    return scale, shift


def group_norm_scale_shift(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                           num_groups: int, eps: float):
    """GroupNorm's float32 (N, C) ``scale`` and ``shift`` (``x * scale +
    shift`` is the normalised x): K8's statistics on a CUDA tensor (which
    must not be empty), the plain version on a CPU tensor."""
    _check_device("group_norm_scale_shift", x)
    return _dispatch(_scale_shift_kernel, group_norm_scale_shift_plain, group_norm_scale_shift,
                     x, weight, bias, num_groups, eps)


group_norm_scale_shift.launches = 0
group_norm_scale_shift.plain_calls = 0


def _layer_norm_kernel(x, weight, bias, eps):
    c = x.shape[-1]
    x2 = x.reshape(-1, c)
    _check_x("layer_norm", x2, MAX_LN_CHANNELS)
    w_bf16 = _check_params("layer_norm", x, weight, bias)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rows = x2.shape[0]
    if rows == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.musev_layer_norm(x2.data_ptr(), out.data_ptr(), weight.data_ptr(),
                                   bias.data_ptr(), w_bf16, rows, c, x2.stride(0), eps,
                                   _sms(x.device) * LN_BLOCKS_PER_SM, stream)
    _build.check(lib, err, "layer_norm")
    layer_norm.launches += 1
    return out


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis: K9 on a CUDA tensor (x's dtype out,
    statistics in float32), the plain version on a CPU tensor."""
    _check_device("layer_norm", x)
    return _dispatch(_layer_norm_kernel, layer_norm_plain, layer_norm, x, weight, bias, eps)


layer_norm.launches = 0
layer_norm.plain_calls = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("norm")
    if lib.musev_group_norm.argtypes is None:
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        # x, (y,) w, b, w_bf16, part, scale, shift, N, M, C, G, s_n, s_m, r, rows_stats
        common = [p, p, i, p, p, p, i, i, i, i, ll, ll, i, i]
        lib.musev_group_norm_scale_shift.argtypes = [p, *common, f, p]
        lib.musev_group_norm_scale_shift.restype = ctypes.c_int
        lib.musev_group_norm.argtypes = [p, p, *common, i, f, i, p]
        lib.musev_group_norm.restype = ctypes.c_int
        lib.musev_layer_norm.argtypes = [p, p, p, p, i, ll, i, ll, f, i, p]
        lib.musev_layer_norm.restype = ctypes.c_int
    return lib
