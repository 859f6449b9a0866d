"""Device meshes, collectives and the CLIs' ``--parallel`` topology
(counterpart of ``musev_tpu/parallel/mesh.py``).

One process per device: ``torchrun --nproc-per-node N python -m
musev_torch.cli.text2video --parallel fp`` starts N ranks, rank r on
``cuda:{LOCAL_RANK}``, which is PyTorch's form of what JAX does with one
controller over a ``Mesh``. ``make_mesh`` builds a ``DeviceMesh`` over the
initialised default group with the JAX function's shape and axis names;
``set_mesh`` makes it the ambient mesh that ``axis_group`` and
``axis_size`` read, as ``jax.set_mesh`` does for the JAX package. A
shard's slice of the leading axis is ``batch_sharding``; ``replicated``
gathers it back.

The collectives here are differentiable: ``all_reduce_sum``'s backward
all-reduces the gradient (the transpose of a ``psum``), and
``gather_leading``'s takes this rank's slice of it, which is the transpose
of an all-gather whose result every rank consumes alike (a replicated loss
or scheduler step).
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

TOPOLOGIES = ("none", "fp", "dp")

_MESH = None  # the ambient DeviceMesh (set_mesh)


def make_mesh(shape: Optional[Tuple[int, ...]] = None, axis_names: Sequence[str] = ("dp",)):
    """A ``DeviceMesh`` of ``shape`` (default: every rank on one axis) with
    ``axis_names`` over the default process group, on CUDA under NCCL and on
    the CPU under gloo. Its size must be the group's."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: run one process per "
                           "device under torchrun, or call init_process_group first")
    world = dist.get_world_size()
    shape = tuple(shape) if shape is not None else (world,)
    n = int(np.prod(shape))
    if n != world:
        raise ValueError(f"mesh shape {shape} needs {n} ranks, the process group has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axis_names))


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` the ambient mesh inside the context."""
    global _MESH
    prev, _MESH = _MESH, mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def axis_group(axis: str, mesh=None):
    """The process group of mesh dimension ``axis`` (of the ambient mesh
    where ``mesh`` is None); raises where no mesh carries that axis."""
    mesh = mesh if mesh is not None else _MESH
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"axis {axis!r} needs an ambient mesh (parallel.mesh.set_mesh) "
                         "carrying that axis")
    return mesh.get_group(axis)


def axis_size(axis: str, mesh=None) -> int:
    return dist.get_world_size(axis_group(axis, mesh))


def axis_rank(axis: str, mesh=None) -> int:
    return dist.get_rank(axis_group(axis, mesh))


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherLeading(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        ctx.rows, ctx.rank = x.shape[0], rank
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (``lax.psum``)."""
    return _AllReduceSum.apply(x, group)


def gather_leading(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the leading axis in rank order;
    each rank must pass the same shape."""
    return _GatherLeading.apply(x, group)


def is_main_rank() -> bool:
    """Rank 0 of the default group, or a process without one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def batch_sharding(x: torch.Tensor, mesh=None, axis: str = "dp", groups: int = 1) -> torch.Tensor:
    """This rank's contiguous slice of ``x``'s leading axis over mesh axis
    ``axis``, the axis padded to a multiple of its size with copies of the
    last row (``batch_sharding``'s ``P(axis)`` on the leading axis). With
    ``groups``, the leading axis is that many equal parts (the [uncond;
    cond] halves of a CFG batch), each sliced so; the rank's slices are
    concatenated in order, so every rank holds the same share of each."""
    n, rank = axis_size(axis, mesh), axis_rank(axis, mesh)
    if x.shape[0] % groups:
        raise ValueError(f"batch_sharding: {x.shape[0]} rows do not split into {groups} groups")
    per = -(-x.shape[0] // groups // n)
    parts = []
    for part in x.chunk(groups):
        pad = per * n - part.shape[0]
        if pad:
            part = torch.cat([part, part[-1:].expand(pad, *part.shape[1:])], dim=0)
        parts.append(part[rank * per:(rank + 1) * per])
    return torch.cat(parts, dim=0)


def replicated(x: torch.Tensor, rows: int, mesh=None, axis: str = "dp",
               groups: int = 1) -> torch.Tensor:
    """The inverse of ``batch_sharding``: every rank's slices gathered, in
    one call, and put back in order, cut to the first ``rows`` rows
    (``replicated``'s ``P()``)."""
    group = axis_group(axis, mesh)
    full = gather_leading(x, group).unflatten(0, (dist.get_world_size(group), groups, -1))
    return full.transpose(0, 1).flatten(1, 2)[:, :rows // groups].flatten(0, 1)


@contextlib.contextmanager
def _topology(mesh, started: bool):
    try:
        with set_mesh(mesh):
            yield
    finally:
        if started:
            dist.destroy_process_group()


def cli_topology(topology: str, device: str = "cuda"):
    """``none``/``fp``/``dp`` -> (context manager, pipeline kwargs).

    ``none``, or a world size of 1, gives a null context and no kwargs, as
    the JAX CLI does on one device (mesh.py:52-54). Under ``torchrun`` with
    a world size of 2 or more it starts the default group where it is not
    started yet (NCCL on CUDA, with rank r on ``cuda:{LOCAL_RANK}``; gloo on
    the CPU), and returns a context that makes the 1-D mesh over the axis
    named ``topology`` ambient (and ends the group it started) with
    ``{f"{topology}_axis": topology, "mesh": mesh}``. Two or more visible
    CUDA devices and no process group raise: one process would use one GPU.
    A group that cannot start raises."""
    if topology not in TOPOLOGIES:
        raise ValueError(f"unknown parallel topology {topology!r}")
    if topology == "none":
        return contextlib.nullcontext(), {}
    started = False
    world = dist.get_world_size() if dist.is_initialized() else int(
        os.environ.get("WORLD_SIZE", "1"))
    if world < 2:
        n = torch.cuda.device_count()
        if n >= 2 and not dist.is_initialized():
            raise RuntimeError(
                f"--parallel {topology} sees {n} CUDA devices and no process group: run one "
                f"process per device, torchrun --nproc-per-node {n} python -m "
                f"musev_torch.cli.text2video --parallel {topology} ...")
        return contextlib.nullcontext(), {}
    if not dist.is_initialized():
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
            dist.init_process_group("nccl")
        else:
            dist.init_process_group("gloo")
        started = True
    mesh = make_mesh((world,), (topology,))
    return _topology(mesh, started), {f"{topology}_axis": topology, "mesh": mesh}
