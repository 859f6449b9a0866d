"""The weights of a run, drawn on the device from its seed.

One flat buffer in the type the configuration serves in, filled by one
normal draw from a ``torch.Generator`` on the device, then cut into every
module's parameters in the reference's key order: every matrix, kernel,
embedding and gate N(0, ``std``) of the configuration, its norm scales and
biases set to its constants. The same seed on the same
device gives the same tensors, so the benchmark draws them once for the
program and again, after the window, for the reference.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..reference.pipeline import layout


def weight_seed(run_seed: int) -> int:
    return int(np.random.SeedSequence([run_seed, 0x77656967]).generate_state(1)[0])


def draw(cfg: dict, run_seed: int, device,
         dtype: torch.dtype) -> Dict[str, Dict[str, torch.Tensor]]:
    """{module: {key: tensor}} for ``cfg``'s modules."""
    spec = layout(cfg)
    w = cfg["weights"]
    total = sum(math.prod(shape) for params in spec.values() for shape, _ in params.values())
    gen = torch.Generator(device=device).manual_seed(weight_seed(run_seed))
    flat = torch.empty(total, dtype=dtype, device=device).normal_(0.0, w["std"], generator=gen)
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    at = 0
    for name, params in spec.items():
        out[name] = {}
        for key, (shape, is_scale) in params.items():
            n = math.prod(shape)
            t = flat[at:at + n].view(shape)
            at += n
            if is_scale:
                t.fill_(w["norm_scales"])
            elif key.endswith("bias"):
                t.fill_(w["biases"])
            out[name][key] = t
    return out
