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
