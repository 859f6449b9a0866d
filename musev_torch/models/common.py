"""NN primitives of the port, as ``nn.Module``s named after the reference keys.

Counterpart of ``musev_tpu/models/common.py``. Activations are channels-last
as in the JAX package: images ``(N, H, W, C)``, videos ``(B, T, H, W, C)``,
sequences ``(N, S, C)``. A convolution sees its input as an NCHW view of that
memory (``channels_last`` format), so cuDNN runs its NHWC kernels and no copy
is made either way. GroupNorm and LayerNorm statistics run in float32 whatever
the activation dtype (the fp32 norm islands of the bf16 network).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def group_norm_scale_shift(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int, eps: float
):
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


def group_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int, eps: float
) -> torch.Tensor:
    """GroupNorm over the last (channel) axis of a channels-last tensor."""
    n, c = x.shape[0], x.shape[-1]
    xf = x.reshape(n, -1, c).float()
    scale, shift = group_norm_scale_shift(xf, weight, bias, num_groups, eps)
    return torch.addcmul(shift[:, None], xf, scale[:, None]).reshape(x.shape).to(x.dtype)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps)
    return y.to(x.dtype)


class GroupNorm(nn.Module):
    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps)

    def scale_shift(self, x: torch.Tensor):
        """``group_norm_scale_shift`` with this module's parameters."""
        return group_norm_scale_shift(x, self.weight, self.bias, self.num_groups, self.eps)


class LayerNorm(nn.Module):
    def __init__(self, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` applied to channels-last ``(N, H, W, C)`` activations."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._conv_forward(x.permute(0, 3, 1, 2), self.weight, self.bias)
        return y.permute(0, 2, 3, 1).contiguous()


class TemporalConv(nn.Conv3d):
    """The (3, 1, 1) time conv of the reference (resnet.py:59) on
    ``(B, T, H, W, C)``, as three shifted matmuls with zero padding in time:
    y_t = x_{t-1} W0 + x_t W1 + x_{t+1} W2 (``conv_temporal`` in the JAX
    package)."""

    def __init__(self, channels: int):
        super().__init__(channels, channels, (3, 1, 1), padding=(1, 0, 0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight[:, :, :, 0, 0].to(x.dtype)  # (O, I, 3)
        zero = torch.zeros_like(x[:, :1])
        xm = torch.cat([zero, x[:, :-1]], dim=1)
        xp = torch.cat([x[:, 1:], zero], dim=1)
        y = xm @ w[:, :, 0].t() + x @ w[:, :, 1].t() + xp @ w[:, :, 2].t()
        return y + self.bias.to(x.dtype)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        # tanh GELU, as jax.nn.gelu's default in the JAX package's geglu_ff;
        # MuseV's diffusers GEGLU uses the exact form (ROADMAP queue 3)
        return h * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    """diffusers FeedForward with GEGLU: keys ``net.0.proj`` and ``net.2``."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Identity(), nn.Linear(inner, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))
