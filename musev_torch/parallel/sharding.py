"""Tensor-parallel rules over a (dp, tp) mesh (counterpart of
``musev_tpu/parallel/sharding.py``).

Megatron pairing, as the JAX package's ``_tp_spec`` (sharding.py:31-73)
decides it: the first matmul or conv of a chain splits its OUTPUT dim
(``to_q``/``to_k``/``to_v``, the IP-Adapter and FaceID K/V, a resnet's
``time_emb_proj`` and ``conv1`` with their biases), the closing projection
its INPUT dim (``to_out``, a resnet's ``conv2``). A leaf whose dim does not
divide the axis size stays replicated, as ``col``/``row`` return ``P()``
there; the GEGLU feed-forward stays replicated (the note at :55-60).

In JAX the split is a sharding and XLA inserts the collectives. Here it is
explicit: ``shard_params_tp`` cuts each rank's slice out of the module's
weights in place. A column-split module computes its slice of the output
channels, so an ``Attention`` runs heads/n heads of the same head dim; a
row-split module (``RowParallelLinear``, ``RowParallelConv2d``) takes its
slice of the input channels, all-reduces its output and adds its bias once,
after the reduce. A resnet's ``norm2`` sits between its split ``conv1`` and
``conv2``: where this rank's channels hold whole groups it normalises them
alone, else it all-reduces the groups' partial sums (``TPGroupNorm``), so
GroupNorm stays exact at any split.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.common import Conv2d, GroupNorm, group_norm
from ..models.unet_blocks import Attention, ResnetBlock
from .mesh import all_reduce_sum, axis_group, batch_sharding

# output-dim split (bias too), by module name
_COL_SPLIT = {
    "to_q", "to_k", "to_v", "to_k_ip", "to_v_ip", "ip_adapter_face_to_k_ip",
    "ip_adapter_face_to_v_ip", "time_emb_proj",
}
_ROW_SPLIT = {"to_out"}  # input-dim split (the Linear at to_out.0); bias replicated


def tp_split_dims(unet: nn.Module, size: int) -> Dict[str, Optional[int]]:
    """The dim of each parameter (by ``named_parameters`` name) that the
    rules split over ``size`` ranks, or None where it stays replicated; in
    the port's (out, in, ...) weight layout."""
    dims: Dict[str, Optional[int]] = {}
    modules = dict(unet.named_modules())
    for name, p in unet.named_parameters():
        mod_name, leaf = name.rsplit(".", 1)
        keys = mod_name.split(".")
        parent = modules.get(mod_name.rsplit(".", 1)[0]) if "." in mod_name else unet
        dim = None
        if keys[-1] in _COL_SPLIT and isinstance(modules[mod_name], nn.Linear):
            dim = 0 if p.shape[0] % size == 0 else None
        elif (len(keys) >= 2 and keys[-2] in _ROW_SPLIT and leaf == "weight"
              and isinstance(modules[mod_name], nn.Linear)):
            dim = 1 if p.shape[1] % size == 0 else None
        elif isinstance(parent, ResnetBlock) and p.ndim in (4, 1):
            if keys[-1] == "conv1":
                dim = 0 if p.shape[0] % size == 0 else None
            elif keys[-1] == "conv2" and leaf == "weight":
                dim = 1 if p.shape[1] % size == 0 else None
        dims[name] = dim
    return dims


class RowParallelLinear(nn.Linear):
    """A Linear holding this rank's slice of the input dim: the partial
    products are all-reduced, then the bias is added once."""

    group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = all_reduce_sum(F.linear(x, self.weight), self.group)
        return y + self.bias.to(y.dtype)


class RowParallelConv2d(Conv2d):
    """``Conv2d`` (channels-last) holding this rank's slice of the input
    channels: partial outputs all-reduced, bias added after."""

    group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._conv_forward(x.permute(0, 3, 1, 2), self.weight, None)
        y = all_reduce_sum(y.permute(0, 2, 3, 1).contiguous(), self.group)
        return y + self.bias.to(y.dtype)


class TPGroupNorm(GroupNorm):
    """GroupNorm over this rank's slice ``[lo, lo + c)`` of C channels.
    Whole groups on the rank: its own groups' statistics; else each group's
    partial sums over the rank's channels are all-reduced (one pass:
    E[x^2] - E[x]^2 in float32, the JAX package's form)."""

    def __init__(self, norm: GroupNorm, lo: int, c: int, group):
        total = norm.weight.shape[0]
        super().__init__(norm.num_groups, c, norm.eps)
        with torch.no_grad():
            self.weight = nn.Parameter(norm.weight[lo:lo + c].clone())
            self.bias = nn.Parameter(norm.bias[lo:lo + c].clone())
        self.cg = total // norm.num_groups
        self.lo, self.group = lo, group
        self.whole = lo % self.cg == 0 and c % self.cg == 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.whole:
            return group_norm(x, self.weight, self.bias, x.shape[-1] // self.cg, self.eps)
        n, c = x.shape[0], x.shape[-1]
        xf = x.reshape(n, -1, c).float()
        gid = (torch.arange(c, device=x.device) + self.lo) // self.cg
        onehot = F.one_hot(gid, self.num_groups).float()  # (c, G)
        sums = torch.cat([xf.sum(1) @ onehot, xf.square().sum(1) @ onehot], dim=-1)
        s1, s2 = all_reduce_sum(sums, self.group).chunk(2, dim=-1)  # (N, G)
        count = xf.shape[1] * self.cg
        mean = s1 / count
        inv = torch.rsqrt(torch.clamp(s2 / count - mean * mean, min=0.0) + self.eps)
        scale = (inv @ onehot.t()) * self.weight.float()
        shift = self.bias.float() - (mean @ onehot.t()) * scale
        return torch.addcmul(shift[:, None], xf, scale[:, None]).reshape(x.shape).to(x.dtype)


def _slice_(mod: nn.Module, name: str, dim: int, rank: int, n: int) -> None:
    p = getattr(mod, name)
    size = p.shape[dim] // n
    with torch.no_grad():
        setattr(mod, name, nn.Parameter(p.narrow(dim, rank * size, size).clone()))


def _row_parallel(mod: nn.Module, cls, rank: int, n: int, group) -> nn.Module:
    _slice_(mod, "weight", 1, rank, n)
    mod.__class__ = cls
    mod.group = group
    return mod


def shard_params_tp(unet: nn.Module, mesh=None, axis: str = "tp") -> nn.Module:
    """Split ``unet``'s weights in place over mesh axis ``axis`` (of the
    ambient mesh where ``mesh`` is None) by the rules above; norms,
    embeddings and anything unmatched stay whole. Every rank calls it on
    the same weights. A column-split attention whose heads do not divide
    the axis size raises: its local heads would not be whole."""
    group = axis_group(axis, mesh)
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    dims = tp_split_dims(unet, n)
    modules = dict(unet.named_modules())
    for name, mod in modules.items():
        if isinstance(mod, Attention) and dims.get(f"{name}.to_q.weight") == 0:
            if mod.heads % n:
                raise ValueError(f"{name}: {mod.heads} heads do not divide over {n} ranks")
            mod.heads //= n
    for pname, dim in dims.items():
        if dim is None:
            continue
        mod_name, leaf = pname.rsplit(".", 1)
        mod = modules[mod_name]
        if dim == 0:
            _slice_(mod, leaf, 0, rank, n)
        elif isinstance(mod, nn.Linear):
            _row_parallel(mod, RowParallelLinear, rank, n, group)
        else:
            _row_parallel(mod, RowParallelConv2d, rank, n, group)
    for name, mod in modules.items():
        if isinstance(mod, ResnetBlock) and dims.get(f"{name}.conv1.weight") == 0:
            c = mod.conv1.weight.shape[0]
            mod.norm2 = TPGroupNorm(mod.norm2, rank * c, c, group)
    return unet


def shard_batch(x: torch.Tensor, mesh=None, axis: str = "dp") -> torch.Tensor:
    """This rank's slice of ``x``'s leading axis over ``axis``
    (``mesh.batch_sharding``)."""
    return batch_sharding(x, mesh, axis)
