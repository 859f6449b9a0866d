"""Spans around the program's model calls, from the benchmark's side.

The configuration file lists each span: a module of the program's models
and the submodules whose call opens it (a forward pre-hook) and closes it (a
forward hook), by their checkpoint key paths; an empty path is the module
itself. At each end a hook records a CUDA event on the current stream and
the host's ``time.time_ns()``, and the rows of the tensor that enters or
leaves. Only a traced run installs them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch


@dataclasses.dataclass
class Span:
    label: str
    host_start_ns: int
    host_end_ns: int = 0
    in_rows: int = 0
    out_rows: int = 0
    ms: Optional[float] = None  # CUDA-event time from open to close
    start_event: object = None
    end_event: object = None


def _rows(x) -> int:
    if isinstance(x, (tuple, list)):
        x = x[0] if x else None
    return int(x.shape[0]) if isinstance(x, torch.Tensor) and x.ndim else 0


class SpanRecorder:
    """Installs the hooks of ``entries`` on ``models``' modules; ``spans``
    holds every closed span in order, ``active`` switches recording."""

    def __init__(self, models, entries: List[dict], timed: bool):
        self.spans: List[Span] = []
        self.active = False
        self.timed = timed
        self._open: Dict[str, Span] = {}
        self._handles = []
        for e in entries:
            root = getattr(models, e["module"], None)
            if root is None:
                continue
            start = root.get_submodule(e["start"]) if e["start"] else root
            end = root.get_submodule(e["end"]) if e["end"] else root
            self._handles.append(start.register_forward_pre_hook(self._opener(e["label"])))
            self._handles.append(end.register_forward_hook(self._closer(e["label"])))

    def _event(self):
        if not self.timed:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _opener(self, label: str):
        def hook(module, args):
            if self.active:
                self._open[label] = Span(label, time.time_ns(), in_rows=_rows(args),
                                         start_event=self._event())
        return hook

    def _closer(self, label: str):
        def hook(module, args, out):
            span = self._open.pop(label, None) if self.active else None
            if span is not None:
                span.end_event = self._event()
                span.host_end_ns = time.time_ns()
                span.out_rows = _rows(out)
                self.spans.append(span)
        return hook

    def finish(self) -> List[Span]:
        """Reads the events (after the device has finished) and removes the hooks."""
        for h in self._handles:
            h.remove()
        for s in self.spans:
            if s.start_event is not None:
                s.ms = s.start_event.elapsed_time(s.end_event)
                s.start_event = s.end_event = None
        return self.spans
