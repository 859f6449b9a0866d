"""VCPD context-window planning, pure numpy.

A copy of ``musev_tpu/ops/context.py`` (the port imports nothing of the JAX
package). The Visual Conditioned Parallel Denoising scheme denoises
overlapping temporal windows of the latent video each step and averages the
overlaps (reference musev/pipelines/context.py). A ``WindowPlan`` carries a
dense ``(n_windows, window)`` index array plus the overlap counts, so the
denoiser runs all windows as one batch and does the overlap average as one
scatter-add.

Schedules:
  * ``uniform_v2`` (default; context.py:51-66): plain sliding windows of size
    ``context_frames`` with step ``context_frames - context_overlap``; the tail
    window is shifted back so it ends at the last frame (drop_last=False), and
    a fully-redundant final window is dropped (context.py:105-117).
  * ``uniform`` (context.py:21-48): AnimateDiff-style strided, wrapping
    windows whose layout depends on the step index via bit-reversed fractions.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List

import numpy as np


def ordered_halving(val: int) -> float:
    """Bit-reversed fraction in [0, 1) (reference context.py:12-17)."""
    as_int = int(f"{val:064b}"[::-1], 2)
    return as_int / (1 << 64)


def uniform_windows(
    step: int,
    num_frames: int,
    context_size: int,
    context_stride: int = 3,
    context_overlap: int = 4,
    closed_loop: bool = True,
) -> Iterator[List[int]]:
    """Strided wrapping windows (reference ``uniform``, context.py:21-48)."""
    if num_frames <= context_size:
        yield list(range(num_frames))
        return
    context_stride = min(
        context_stride, int(np.ceil(np.log2(num_frames / context_size))) + 1
    )
    for context_step in 1 << np.arange(context_stride):
        pad = int(round(num_frames * ordered_halving(step)))
        for j in range(
            int(ordered_halving(step) * context_step) + pad,
            num_frames + pad + (0 if closed_loop else -context_overlap),
            (context_size * context_step - context_overlap),
        ):
            yield [
                e % num_frames
                for e in range(j, j + context_size * context_step, context_step)
            ]


def uniform_v2_windows(
    num_frames: int,
    context_size: int,
    context_overlap: int = 4,
) -> List[List[int]]:
    """Sliding windows, tail snapped to the end (reference context.py:51-66 via
    mmcm generate_sample_idxs(drop_last=False), then drop_last_repeat_context).
    """
    if num_frames <= context_size:
        return [list(range(num_frames))]
    step = context_size - context_overlap
    if step <= 0:
        raise ValueError(
            f"context_overlap ({context_overlap}) must be < context_size "
            f"({context_size})"
        )
    windows: List[List[int]] = []
    for start in range(0, num_frames, step):
        end = start + context_size
        if end > num_frames:
            windows.append(list(range(num_frames - context_size, num_frames)))
            break
        windows.append(list(range(start, end)))
    # drop a final window that is fully redundant (same max frame as previous)
    if len(windows) >= 2 and windows[-1][-1] == windows[-2][-1]:
        windows = windows[:-1]
    return windows


def drop_last_repeat_context(contexts: List[List[int]]) -> List[List[int]]:
    """Reference context.py:105-117."""
    if len(contexts) >= 2 and contexts[-1][-1] == contexts[-2][-1]:
        return contexts[:-1]
    return contexts


@dataclasses.dataclass(frozen=True, eq=False)
class WindowPlan:
    """Static VCPD plan for one denoise step.

    Attributes:
      windows: (n_windows, window_size) int32 frame indices into [0, T).
      counts:  (T,) float32 — how many windows cover each frame (>= 1);
               the divisor of the overlap-average reduction
               (pipeline_controlnet.py:2076-2079).
      num_frames: T, the generated-video length (excludes condition frames).

    Hashable by content so it can be a jit static argument.
    """

    windows: np.ndarray
    counts: np.ndarray
    num_frames: int

    def __hash__(self):
        return hash((self.num_frames, self.windows.tobytes()))

    def __eq__(self, other):
        return (
            isinstance(other, WindowPlan)
            and self.num_frames == other.num_frames
            and np.array_equal(self.windows, other.windows)
            and np.array_equal(self.counts, other.counts)
        )

    @property
    def n_windows(self) -> int:
        return int(self.windows.shape[0])

    @property
    def window_size(self) -> int:
        return int(self.windows.shape[1])

    @property
    def per_step(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True, eq=False)
class StackedWindowPlan:
    """Per-step window plans for step-dependent schedules (``uniform``).

    windows: (num_steps, n_windows_max, window) int32 — short steps padded by
    repeating their last window (repeats only re-add the same prediction and
    are averaged out by the matching counts).
    counts: (num_steps, T) float32.
    """

    windows: np.ndarray
    counts: np.ndarray
    num_frames: int

    @property
    def n_windows(self) -> int:
        return int(self.windows.shape[1])

    @property
    def window_size(self) -> int:
        return int(self.windows.shape[2])

    @property
    def per_step(self) -> bool:
        return True

    def __hash__(self):
        return hash((self.num_frames, self.windows.tobytes()))

    def __eq__(self, other):
        return (
            isinstance(other, StackedWindowPlan)
            and self.num_frames == other.num_frames
            and np.array_equal(self.windows, other.windows)
        )


def make_stacked_window_plan(
    num_steps: int,
    num_frames: int,
    context_frames: int,
    context_overlap: int = 4,
    context_stride: int = 3,
    schedule: str = "uniform",
) -> StackedWindowPlan:
    """Build one plan per denoise step and pad to a common window count."""
    plans = [
        make_window_plan(
            num_frames, context_frames, context_overlap, context_stride,
            schedule=schedule, step=i,
        )
        for i in range(num_steps)
    ]
    n_max = max(p.n_windows for p in plans)
    w = plans[0].window_size
    windows = np.zeros((num_steps, n_max, w), np.int32)
    counts = np.zeros((num_steps, num_frames), np.float32)
    for i, p in enumerate(plans):
        padded = np.concatenate(
            [p.windows] + [p.windows[-1:]] * (n_max - p.n_windows), axis=0
        )
        windows[i] = padded
        c = np.zeros((num_frames,), np.float32)
        np.add.at(c, padded.reshape(-1), 1.0)
        # uncovered frames already raise in make_window_plan above
        counts[i] = c
    return StackedWindowPlan(windows=windows, counts=counts, num_frames=num_frames)


def make_window_plan(
    num_frames: int,
    context_frames: int,
    context_overlap: int = 4,
    context_stride: int = 1,
    schedule: str = "uniform_v2",
    step: int = 0,
) -> WindowPlan:
    """Build the static plan for a given schedule.

    For ``uniform`` the plan depends on ``step``; ``uniform_v2`` is
    step-invariant. All windows in a plan have equal length (the schedules
    guarantee this when ``num_frames >= context_frames``; shorter videos get a
    single full-span window).
    """
    if schedule == "uniform_v2":
        wins = uniform_v2_windows(num_frames, context_frames, context_overlap)
    elif schedule == "uniform":
        wins = drop_last_repeat_context(
            list(
                uniform_windows(
                    step,
                    num_frames,
                    context_frames,
                    context_stride,
                    context_overlap,
                )
            )
        )
    else:
        raise ValueError(f"unknown context schedule {schedule!r}")
    lengths = {len(w) for w in wins}
    if len(lengths) != 1:
        raise ValueError(f"ragged window plan: lengths {sorted(lengths)}")
    windows = np.asarray(wins, dtype=np.int32)
    counts = np.zeros((num_frames,), dtype=np.float32)
    np.add.at(counts, windows.reshape(-1), 1.0)
    # A frame no window touches would silently denoise with noise_pred=0
    # (stepped as if the model predicted zero noise) — refuse the plan
    # instead of clamping. Reachable only with exotic `uniform`
    # stride/overlap combinations; uniform_v2 always covers [0, T).
    uncovered = np.flatnonzero(counts == 0)
    if uncovered.size:
        raise ValueError(
            f"window plan (schedule={schedule!r}, context={context_frames}, "
            f"overlap={context_overlap}, stride={context_stride}) leaves "
            f"frames {uncovered.tolist()} uncovered of {num_frames}"
        )
    return WindowPlan(windows=windows, counts=counts, num_frames=num_frames)
