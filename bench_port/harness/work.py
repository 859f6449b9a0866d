"""The work in one clip, counted from the reference's shapes on the
``meta`` device, so the count does not move when the program changes.

``torch.utils.flop_counter.FlopCounterMode`` counts the products (GEMM,
convolution, the attention products, which the reference writes as
matmuls); the reference's ``Numerics.attn_log`` lists each unmasked
attention call's shape. A clip is run once at one step of each kind and
the UNet calls of one step are scaled to the clip's steps: every step of a
kind makes the same calls at the same shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import pipeline as ref
from ..reference.layers import Numerics


@dataclasses.dataclass
class ClipWork:
    flops: float  # model operations of the whole clip
    attention: List[tuple]  # (n, heads, sq, sk, d) of every attention call of the clip


def clip_work(cfg: dict, args: ref.ClipArgs) -> ClipWork:
    log: List[tuple] = []
    mods = ref.build(cfg, Numerics(attn_log=log), device="meta")
    unet = mods["unet"]
    calls: Dict[str, list] = {"video": [], "image": []}  # per call: (flops, attention calls)
    inner = unet.forward

    def counted(sample, *a, **kw):
        f0, n0 = counter.get_total_flops(), len(log)
        out = inner(sample, *a, **kw)
        kind = "video" if sample.shape[1] > 1 else "image"
        calls[kind].append((counter.get_total_flops() - f0, log[n0:]))
        return out

    one = dataclasses.replace(args, video_steps=1, t2i_steps=1)
    unet.forward = counted
    with FlopCounterMode(display=False) as counter:
        ref.text2video(mods, one, "meta")
    flops, attention = float(counter.get_total_flops()), list(log)
    for kind, steps in (("video", args.video_steps), ("image", args.t2i_steps)):
        for f, att in calls[kind] * (steps - 1):
            flops += f
            attention += att
    return ClipWork(flops=flops, attention=attention)
