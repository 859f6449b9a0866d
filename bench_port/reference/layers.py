"""Plain PyTorch layers of the benchmark's reference, and how it rounds.

Activations are channels-last, as the measured program keeps them: images
``(N, H, W, C)``, videos ``(B, T, H, W, C)``, sequences ``(N, S, C)``.
Every product (linear, convolution, both products of attention) runs in
float32 with TF32 off; under ``Numerics("fp8")``, the control, on operands
rounded to float8 e4m3 with one scale per tensor, the way an fp8 GEMM takes
them; under ``Numerics("bf16")`` on operands rounded to bfloat16 (a witness
of what bfloat16 alone does to a clip). Norms, softmax and elementwise math
stay in float32 either way. Attention is written out (logits, softmax, product) in blocks of rows
so that the float32 logits fit the device.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0  # the largest float8 e4m3 value
LOGIT_BUDGET = 1 << 28  # float32 logits held at once (1 GiB)


class Numerics:
    """How the reference computes its products: ``precision`` "fp32", "bf16"
    (every operand of a product rounded to bfloat16) or "fp8" (to float8
    e4m3 under a per-tensor scale: the control); ``attn_log``, a list,
    receives ``(n, heads, sq, sk, d)`` of every unmasked attention call (the
    kernels' work, counted from the reference's shapes)."""

    def __init__(self, precision: str = "fp32", attn_log: Optional[List[tuple]] = None):
        if precision not in ("fp32", "bf16", "fp8"):
            raise ValueError(f"precision {precision!r}: expected fp32, bf16 or fp8")
        self.precision = precision
        self.attn_log = attn_log

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the product sees it."""
        x = x.float()
        if self.precision == "bf16":
            return x.to(torch.bfloat16).float()
        if self.precision == "fp8":
            scale = FP8_MAX / x.abs().amax().clamp(min=1e-30)
            return (x * scale).to(torch.float8_e4m3fn).float() / scale
        return x


def attach(module: nn.Module, numerics: Numerics) -> nn.Module:
    """Give every layer of ``module`` the same ``numerics``."""
    for m in module.modules():
        if isinstance(m, (Linear, Conv2d, TemporalConv, NumericsUser)):
            m.numerics = numerics
    return module


class NumericsUser(nn.Module):
    """A module that runs attention and so needs the ``numerics``."""

    numerics: Numerics = Numerics()


class Linear(nn.Linear):
    numerics: Numerics = Numerics()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.numerics.q
        return F.linear(q(x), q(self.weight), None if self.bias is None else self.bias.float())


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` on channels-last ``(N, H, W, C)`` activations."""

    numerics: Numerics = Numerics()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.numerics.q
        b = None if self.bias is None else self.bias.float()
        w = q(self.weight).contiguous(memory_format=torch.channels_last)
        y = F.conv2d(q(x).permute(0, 3, 1, 2), w, b, self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class TemporalConv(nn.Conv3d):
    """The (3, 1, 1) time convolution on ``(B, T, H, W, C)`` with zero
    padding in time: y_t = x_{t-1} W0 + x_t W1 + x_{t+1} W2 + b."""

    numerics: Numerics = Numerics()

    def __init__(self, channels: int):
        super().__init__(channels, channels, (3, 1, 1), padding=(1, 0, 0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.numerics.q
        w = q(self.weight[:, :, :, 0, 0])  # (O, I, 3)
        x = q(x)
        zero = torch.zeros_like(x[:, :1])
        xm = torch.cat([zero, x[:, :-1]], dim=1)
        xp = torch.cat([x[:, 1:], zero], dim=1)
        y = xm @ w[:, :, 0].t() + x @ w[:, :, 1].t() + xp @ w[:, :, 2].t()
        return y + self.bias.float()


class GroupNorm(nn.Module):
    """GroupNorm over the channel (last) axis; statistics over every other
    axis of each sample (dim 0)."""

    def __init__(self, groups: int, channels: int, eps: float = 1e-5):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[0], x.shape[-1]
        g = self.groups
        xf = x.float().reshape(n, -1, g, c // g)
        var, mean = torch.var_mean(xf, dim=(1, 3), correction=0, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y.reshape(n, -1, c) * self.weight.float() + self.bias.float()
        return y.reshape(x.shape)


class LayerNorm(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(), self.bias.float(),
                            self.eps)


def attention(numerics: Numerics, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(d) + bias) v over ``(N, S, H, D)`` tensors,
    written out in float32 in blocks of rows and query positions."""
    n, sq, h, d = q.shape
    sk = k.shape[1]
    if bias is None and numerics.attn_log is not None:
        numerics.attn_log.append((n, h, sq, sk, d))
    qh, kh, vh = (numerics.q(t).permute(0, 2, 1, 3) for t in (q, k, v))
    scale = 1.0 / math.sqrt(d)
    out = qh.new_empty(n, h, sq, d)
    rows = max(1, LOGIT_BUDGET // (h * sq * sk))
    cols = sq if rows > 1 else max(1, min(sq, LOGIT_BUDGET // (h * sk)))
    for r in range(0, n, rows):
        for c in range(0, sq, cols):
            logits = qh[r:r + rows, :, c:c + cols] @ kh[r:r + rows].transpose(-1, -2)
            logits = logits * scale
            if bias is not None:
                logits = logits + bias
            p = numerics.q(torch.softmax(logits, dim=-1))
            out[r:r + rows, :, c:c + cols] = p @ vh[r:r + rows]
    return out.permute(0, 2, 1, 3)
