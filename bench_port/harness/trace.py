"""The device trace of a window: torch.profiler's kineto events, read
directly (building ``key_averages()`` for every event takes tens of seconds
after a clip), and the arithmetic over them.

Times are nanoseconds on the profiler's clock. The first device operation of
a trace is an anchor launched right after a synchronise, so its start minus
the host's ``time.time_ns()`` just before its launch maps host times onto
the device's timeline to within a launch's latency.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Sequence, Tuple

import torch


@dataclasses.dataclass
class Op:
    name: str
    start_ns: int
    dur_ns: int
    kind: str  # "kernel", "memcpy" or "memset"

    @property
    def end_ns(self) -> int:
        return self.start_ns + self.dur_ns


def _kind(name: str, activity: str) -> str:
    low = (activity + " " + name).lower()
    if "memcpy" in low:
        return "memcpy"
    if "memset" in low:
        return "memset"
    return "kernel"


class DeviceTrace:
    """``with DeviceTrace():`` profiles the device (CUDA activity only) from
    the anchor to the exit; ``ops`` then holds every device operation after
    the anchor, ``offset_ns`` the host-to-device clock offset."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self.ops: List[Op] = []
        self.offset_ns = 0

    def __enter__(self):
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._anchor_host = time.time_ns()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        results = self._prof.profiler.kineto_results
        ops = []
        for e in results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA or e.duration_ns() <= 0:
                continue
            ops.append(Op(e.name(), e.start_ns(), e.duration_ns(),
                          _kind(e.name(), str(getattr(e, "activity_type", lambda: "")()))))
        ops.sort(key=lambda o: o.start_ns)
        if not ops:
            raise RuntimeError("torch.profiler recorded no device operation: the trace is empty")
        self.offset_ns = ops[0].start_ns - self._anchor_host
        self.ops = ops[1:]
        return False


def union(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merged [start, end) intervals, sorted."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(ops: Sequence[Op], lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi) in which some device operation ran."""
    return sum(min(e, hi) - max(s, lo) for s, e in union([(o.start_ns, o.end_ns) for o in ops])
               if e > lo and s < hi)


def gaps(ops: Sequence[Op], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The idle intervals of [lo, hi)."""
    out, at = [], lo
    for s, e in union([(o.start_ns, o.end_ns) for o in ops]):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def top_ops(ops: Sequence[Op], n: int = 10) -> List[list]:
    """[[name, seconds], ...]: the device operations by total time."""
    total: Dict[str, int] = {}
    for o in ops:
        total[o.name] = total.get(o.name, 0) + o.dur_ns
    return [[k[:200], v / 1e9] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def idle_by_span(idle: Sequence[Tuple[int, int]], spans, offset_ns: int,
                 outside: str = "pipeline", n: int = 10) -> List[list]:
    """[[label, seconds], ...]: idle device time by the span that was open on
    the host at each gap's midpoint (``outside`` where none was)."""
    marks = sorted((s.host_start_ns + offset_ns, s.host_end_ns + offset_ns, s.label)
                   for s in spans)
    total: Dict[str, int] = {}
    j = 0
    for s, e in idle:
        mid = (s + e) // 2
        while j < len(marks) and marks[j][1] < mid:
            j += 1
        label = marks[j][2] if j < len(marks) and marks[j][0] <= mid <= marks[j][1] else outside
        total[label] = total.get(label, 0) + (e - s)
    return [[k, v / 1e9] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def kernels(ops: Sequence[Op]) -> List[Op]:
    return [o for o in ops if o.kind == "kernel"]


def matching(ops: Sequence[Op], patterns: Sequence[str]) -> List[Op]:
    """The operations whose lower-cased name holds one of ``patterns``."""
    pats = [p.lower() for p in patterns]
    return [o for o in ops if any(p in o.name.lower() for p in pats)]


def window_clip(ops: Sequence[Op], lo: int, hi: int) -> List[Op]:
    """The operations that overlap [lo, hi)."""
    return [o for o in ops if o.end_ns > lo and o.start_ns < hi]
