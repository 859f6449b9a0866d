"""The one generator of requests: a traffic file's parameters and the run's
seed make the clips a client sends.

A traffic file gives the entry's arguments (``clip``: sizes, steps,
guidance), the prompts to draw from, the negative prompt, whether each clip
starts from a seeded image (``condition``: ``"image"``) or makes its
condition frame text-to-image (``"t2i"``), and the warm-up's steps. Clip k
of a run gets its own seed from the run's seed and k; its prompt and, for
``"image"``, its uint8 image come from that seed. Every clip of a mix has
the same sizes, so seeds change the numbers and not the work.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from ..reference.pipeline import ClipArgs

WARMUP_INDEX = 1 << 40  # a clip index no window reaches


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    args: ClipArgs  # what both the program and the reference are given


def clip_seed(run_seed: int, index: int) -> int:
    """A 32-bit seed for clip ``index`` of the run (any whole ``run_seed``)."""
    return int(np.random.SeedSequence([run_seed, index]).generate_state(1)[0])


def request(traffic: dict, run_seed: int, index: int, steps: Optional[dict] = None) -> Request:
    """Clip ``index`` of the mix under ``run_seed``; ``steps`` overrides the
    clip's step counts (the warm-up's)."""
    seed = clip_seed(run_seed, index)
    rng = np.random.default_rng(seed)
    clip = dict(traffic["clip"], **(steps or {}))
    prompt = traffic["prompts"][int(rng.integers(len(traffic["prompts"])))]
    image = None
    if traffic["condition"] == "image":
        image = rng.integers(0, 256, (clip["height"], clip["width"], 3), dtype=np.uint8)
    elif traffic["condition"] != "t2i":
        raise ValueError(f"condition {traffic['condition']!r}: expected 'image' or 't2i'")
    return Request(index, ClipArgs(prompt=prompt, negative_prompt=traffic["negative_prompt"],
                                   seed=seed, condition_image=image, **clip))


def closed_loop(traffic: dict, run_seed: int) -> Iterator[Request]:
    """One client: clip 0, 1, 2, ... each sent when the last returns."""
    index = 0
    while True:
        yield request(traffic, run_seed, index)
        index += 1


def warmup(traffic: dict, run_seed: int) -> Request:
    """A clip at the mix's shapes with the warm-up's step counts, on a seed
    no measured clip has."""
    return request(traffic, run_seed, WARMUP_INDEX, traffic["warmup_steps"])
