"""Ring attention: sequence-parallel exact attention over a mesh axis
(counterpart of ``musev_tpu/parallel/ring_attention.py``).

The token axis of a self-attention site is sharded over the ranks; K/V
shards rotate around the ring (rank i sends to rank i + 1) and each rank
merges its partial results with the online-softmax rescaling identity, so
the (S, S) scores never exist on any device and activation memory scales
1/n. Each ring step is one launch of the flash kernel with softmax stats
(K1s) of the local q against the K/V shard in hand; ``merge_stats`` (the
split-merge route's merge) folds it in. The next step's K/V transfer
(``batch_isend_irecv``) starts before the current launch, so the two
overlap, as the JAX package's ``ppermute`` does under XLA's async
scheduling.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..ops.kernels import records
from ..ops.kernels.flash_attention import (
    _check,
    _launch,
    flash_attention_stats_plain,
    merge_stats,
)
from .mesh import axis_group, gather_leading


def _stats(q, k, v, scale):
    if q.device.type == "cpu":
        return flash_attention_stats_plain(q, k, v, scale)
    out = _launch(q, k, v, scale, with_stats=True)
    ring_attention.launches += 1
    return out


def _ring(q, k, v, scale, n, pass_on):
    """The n-step loop of one rank: ``pass_on(k, v)`` starts handing the K/V
    in hand on and returns a function that waits for the next shard."""
    _check(q, k, v)
    if records(q, k, v):
        raise NotImplementedError("ring_attention has no backward")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    cur_k, cur_v = k, v
    o = m = l = None
    for step in range(n):
        wait = pass_on(cur_k, cur_v) if step < n - 1 else None
        oi, mi, li = _stats(q, cur_k, cur_v, scale)
        if o is None:
            o, m, l = oi.float(), mi, li
        else:
            o, m, l = merge_stats(o, m, l, oi, mi, li)
        if wait is not None:
            cur_k, cur_v = wait()
    return o.to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention with the sequence axis sharded over the ranks of
    ``group``: q, k, v are this rank's (B, S/n, H, D) shards; returns its
    output shard, whose concatenation over the ranks is the full attention.
    CUDA inputs follow ``flash_attention``'s rules; ``ring_attention.launches``
    counts the kernel's launches. Inference only: a call that autograd
    records raises."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (rank + 1) % n)
    src = dist.get_global_rank(group, (rank - 1) % n)

    def pass_on(cur_k, cur_v):
        nk, nv = torch.empty_like(cur_k), torch.empty_like(cur_v)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, cur_k, dst, group), dist.P2POp(dist.irecv, nk, src, group),
            dist.P2POp(dist.isend, cur_v, dst, group), dist.P2POp(dist.irecv, nv, src, group)])

        def wait():
            for req in reqs:
                req.wait()
            return nk, nv
        return wait

    return _ring(q, k.contiguous(), v.contiguous(), scale, n, pass_on)


def ring_attention_local(q: torch.Tensor, ks: Sequence[torch.Tensor],
                         vs: Sequence[torch.Tensor], rank: int,
                         scale: Optional[float] = None) -> torch.Tensor:
    """``ring_attention`` of rank ``rank`` of a ring of ``len(ks)`` ranks
    held on one device: ``ks``/``vs`` are every rank's K/V shards, and step
    s takes rank (rank - s) % n's, the shard the ring would hand it then.
    The same loop, kernel launches and merges as over a process group, with
    the transfers replaced by a lookup (the one-card check of the ring)."""
    n = len(ks)
    ks, vs = [x.contiguous() for x in ks], [x.contiguous() for x in vs]
    step = iter(range(1, n))

    def pass_on(cur_k, cur_v):
        j = (rank - next(step)) % n
        return lambda: (ks[j], vs[j])

    return _ring(q, ks[rank], vs[rank], scale, n, pass_on)


ring_attention.launches = 0


def sp_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis: str = "sp",
            scale: Optional[float] = None) -> torch.Tensor:
    """Replicated-in, replicated-out ring attention over mesh axis ``axis``
    of the ambient mesh: each rank takes its slice of the (B, S, H, D)
    sequence, runs ``ring_attention`` and the slices are gathered. S must be
    divisible by the axis size (``ops.attention.sdpa`` routes only such
    sites)."""
    group = axis_group(axis)
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    s = q.shape[1]
    if s % n:
        raise ValueError(f"sp_sdpa: sequence {s} is not divisible by the {n} ranks of {axis!r}")
    sl = slice(rank * (s // n), (rank + 1) * (s // n))
    out = ring_attention(q[:, sl], k[:, sl], v[:, sl], group, scale)
    return gather_leading(out.transpose(0, 1), group).transpose(0, 1).contiguous()
