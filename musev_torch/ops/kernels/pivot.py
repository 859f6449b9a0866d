"""The temporal-rows pivot and its inverse: the CUDA kernels and their plain versions.

The kernels (``csrc/pivot.cu``) replace the Pallas TPU kernels of
``scripts/bench_fused_transpose.py``: ``_t_kernel`` (K5, the pivot
(b, T, HW, C) -> (b, HW, T, C)), ``_t_gn_kernel`` (K6, the same pivot with a
fused fp32 per-(b, t, c) scale and shift: the temporal transformer's
GroupNorm apply) and ``_inv_kernel`` (K7, the way back). They make the
pixel-major rows the packed temporal attention runs on, and bring its output
back to frame-major.

``pivot_rows`` and ``unpivot_rows`` take CPU tensors to the plain versions and
CUDA tensors to the kernels; on CUDA they launch or raise, never fall back.
``pivot_rows.launches`` counts K5 launches, ``pivot_rows.gn_launches`` K6
launches, ``unpivot_rows.launches`` K7 launches.

Under autograd (``records``) each call runs as an ``autograd.Function`` on
any device: a pivot is a permutation, so the backward of K5 is K7 and that
of K7 is K5, exactly; the backward of K6 unpivots the gradient (K7) and
takes ``dx = g * scale`` and the float32 sums over the pixels
``dscale = sum g * x``, ``dshift = sum g``, because the temporal
transformer's scale and shift depend on x through the GroupNorm statistics.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, check_rows, records


def pivot_rows_plain(
    x: torch.Tensor, scale: Optional[torch.Tensor] = None, shift: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """(b, T, HW, C) -> contiguous (b, HW, T, C); with fp32 ``scale`` and
    ``shift`` of (b, T, C) the elements are first mapped to
    ``x.dtype(fp32(x) * scale + shift)``."""
    if scale is not None:
        x = torch.addcmul(shift[:, :, None], x.float(), scale[:, :, None]).to(x.dtype)
    return x.transpose(1, 2).contiguous()


def unpivot_rows_plain(y: torch.Tensor) -> torch.Tensor:
    """(b, HW, T, C) -> contiguous (b, T, HW, C)."""
    return y.transpose(1, 2).contiguous()


def pivot_rows(
    x: torch.Tensor, scale: Optional[torch.Tensor] = None, shift: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """(b, T, HW, C) -> contiguous (b, HW, T, C) (K5); with fp32 ``scale`` and
    ``shift`` of (b, T, C) it applies ``fp32(x) * scale + shift`` on the way
    (K6). ``x`` may be a view with any outer strides; so may scale and shift
    (a scale broadcast over T is an expanded view)."""
    if x.ndim != 4:
        raise ValueError(f"pivot_rows takes (b, T, HW, C), got {tuple(x.shape)}")
    if (scale is None) != (shift is None):
        raise ValueError("pivot_rows takes scale and shift together")
    b, t, hw, c = x.shape
    if scale is not None:
        for name, s in (("scale", scale), ("shift", shift)):
            if s.shape != (b, t, c) or s.dtype != torch.float32 or s.device != x.device:
                raise ValueError(
                    f"pivot_rows: {name} must be float32 {(b, t, c)} on {x.device}, got "
                    f"{s.dtype} {tuple(s.shape)} on {s.device}"
                )
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pivot_rows: unsupported device {x.device}")
    if records(x, scale, shift):
        return _Pivot.apply(x) if scale is None else _PivotGN.apply(x, scale, shift)
    return _pivot(x, scale, shift)


def _pivot(x: torch.Tensor, scale: Optional[torch.Tensor], shift: Optional[torch.Tensor]):
    """K5 or K6 on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return pivot_rows_plain(x, scale, shift)
    b, t, hw, c = x.shape
    elem = check_rows("pivot_rows", x)
    if scale is not None:
        for name, s in (("scale", scale), ("shift", shift)):
            if s.stride(-1) != 1 or s.stride(0) % 4 or s.stride(1) % 4 or s.data_ptr() % 16:
                raise ValueError(f"pivot_rows kernel: {name} strides {s.stride()} unaligned")
    out = torch.empty((b, hw, t, c), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.musev_pivot_rows(
            x.data_ptr(), out.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if shift is None else shift.data_ptr(),
            elem, b, t, hw, c, x.stride(0), x.stride(1), x.stride(2),
            0 if scale is None else scale.stride(0), 0 if scale is None else scale.stride(1),
            stream,
        )
    _build.check(lib, err, "pivot_rows")
    if scale is None:
        pivot_rows.launches += 1
    else:
        pivot_rows.gn_launches += 1
    return out


pivot_rows.launches = 0
pivot_rows.gn_launches = 0


def unpivot_rows(y: torch.Tensor) -> torch.Tensor:
    """(b, HW, T, C) -> contiguous (b, T, HW, C) (K7); ``y`` may be a view
    with any outer strides."""
    if y.ndim != 4:
        raise ValueError(f"unpivot_rows takes (b, HW, T, C), got {tuple(y.shape)}")
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unpivot_rows: unsupported device {y.device}")
    if records(y):
        return _Unpivot.apply(y)
    return _unpivot(y)


def _unpivot(y: torch.Tensor) -> torch.Tensor:
    """K7 on a CUDA tensor, the plain version on a CPU tensor."""
    if y.device.type == "cpu":
        return unpivot_rows_plain(y)
    elem = check_rows("unpivot_rows", y)
    b, hw, t, c = y.shape
    out = torch.empty((b, t, hw, c), dtype=y.dtype, device=y.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.musev_unpivot_rows(
            y.data_ptr(), out.data_ptr(), elem, b, hw, t, c,
            y.stride(0), y.stride(1), y.stride(2), stream,
        )
    _build.check(lib, err, "unpivot_rows")
    unpivot_rows.launches += 1
    return out


unpivot_rows.launches = 0


class _Pivot(torch.autograd.Function):
    """K5 under autograd; its backward is K7."""

    @staticmethod
    def forward(ctx, x):
        return _pivot(x, None, None)

    @staticmethod
    def backward(ctx, g):
        return unpivot_rows(g.contiguous())


class _Unpivot(torch.autograd.Function):
    """K7 under autograd; its backward is K5."""

    @staticmethod
    def forward(ctx, y):
        return _unpivot(y)

    @staticmethod
    def backward(ctx, g):
        return pivot_rows(g.contiguous())


class _PivotGN(torch.autograd.Function):
    """K6 under autograd: ``y = pivot(x.dtype(fp32(x) * scale + shift))``.
    The backward unpivots the gradient with K7, then ``dx = g * scale`` in
    x's dtype and ``dscale``, ``dshift`` as float32 sums over the pixels."""

    @staticmethod
    def forward(ctx, x, scale, shift):
        ctx.save_for_backward(x, scale)
        return _pivot(x, scale, shift)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        g = unpivot_rows(g.contiguous()).float()  # (b, T, HW, C)
        dx = dscale = dshift = None
        if ctx.needs_input_grad[0]:
            dx = (g * scale[:, :, None]).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dscale = (g * x.float()).sum(dim=2)
        if ctx.needs_input_grad[2]:
            dshift = g.sum(dim=2)
        return dx, dscale, dshift


def _lib() -> ctypes.CDLL:
    lib = _build.load("pivot")
    if lib.musev_pivot_rows.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.musev_pivot_rows.argtypes = [p, p, p, p, i, i, i, i, i, ll, ll, ll, ll, ll, p]
        lib.musev_pivot_rows.restype = ctypes.c_int
        lib.musev_unpivot_rows.argtypes = [p, p, i, i, i, i, i, ll, ll, ll, p]
        lib.musev_unpivot_rows.restype = ctypes.c_int
    return lib
