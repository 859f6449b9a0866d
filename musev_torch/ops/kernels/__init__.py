"""The port's hand-written CUDA kernels, their wrappers and plain versions."""

from __future__ import annotations

import torch


def records(*tensors) -> bool:
    """Whether autograd records a call on ``tensors``: grad mode is on and
    one of them (None entries skipped) requires grad. A kernel writes into
    an output that has no ``grad_fn``, so a wrapper never returns one for
    such a call: it runs its launch inside an ``autograd.Function``, or
    raises where its kernel has no backward."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


ELEM_BYTES = {torch.bfloat16: 2, torch.float32: 4}  # the dtypes the kernels take
VEC_BYTES = 16  # a thread moves one 16-byte vector of a row


def check_rows(name: str, x: torch.Tensor) -> int:
    """The element size of ``x``, rows of its last axis C; raises on what the
    kernels do not take: another dtype, C not a whole number of 16-byte
    vectors, C not contiguous or rows not 16-byte aligned, too many vectors
    for a 32-bit index."""
    if x.dtype not in ELEM_BYTES:
        raise TypeError(f"{name} kernel takes bfloat16 or float32, got {x.dtype}")
    elem = ELEM_BYTES[x.dtype]
    vec = VEC_BYTES // elem
    if x.shape[-1] % vec:
        raise ValueError(f"{name} kernel: C={x.shape[-1]} is not a multiple of {vec}")
    if x.stride(-1) != 1 or any(s % vec for s in x.stride()[:-1]) or x.data_ptr() % VEC_BYTES:
        raise ValueError(
            f"{name} kernel: strides {x.stride()} must leave C contiguous and the "
            f"rows {VEC_BYTES}-byte aligned"
        )
    if x.numel() // vec >= 2**32 - 256:
        raise ValueError(f"{name} kernel: {x.numel()} elements are too many for one launch")
    return elem
