"""Sharding context (counterpart of ``musev_tpu/parallel/context.py``).

The axes of the mesh a denoise step runs under: ``predict_noise`` sets them
from its ``DenoiseSpec`` and the attention dispatch reads ``sp`` to send
long self-attention to ring attention. The JAX package reads them at trace
time to keep its Pallas kernels off an SPMD program; the port runs its
kernels on every rank's local shards, so only ``sp`` routes anything here:
``dp_axis``, ``tp_axis`` and ``mesh_active`` keep the JAX module's
interface, and nothing in the port reads them.
"""

from __future__ import annotations

import contextlib
from typing import Optional

_DP_AXIS: Optional[str] = None
_TP_AXIS: Optional[str] = None
_SP_AXIS: Optional[str] = None


def dp_axis() -> Optional[str]:
    return _DP_AXIS


def tp_axis() -> Optional[str]:
    return _TP_AXIS


def sp_axis() -> Optional[str]:
    return _SP_AXIS


def mesh_active() -> bool:
    return _DP_AXIS is not None or _TP_AXIS is not None or _SP_AXIS is not None


@contextlib.contextmanager
def sharding_ctx(
    dp: Optional[str] = None,
    tp: Optional[str] = None,
    sp: Optional[str] = None,
):
    global _DP_AXIS, _TP_AXIS, _SP_AXIS
    prev = (_DP_AXIS, _TP_AXIS, _SP_AXIS)
    _DP_AXIS, _TP_AXIS, _SP_AXIS = dp, tp, sp
    try:
        yield
    finally:
        _DP_AXIS, _TP_AXIS, _SP_AXIS = prev
