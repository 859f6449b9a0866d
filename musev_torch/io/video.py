"""Video input for ``MusevPipeline.video2video`` (counterpart of ``musev_tpu/io/video.py``).

Only ``PrefetchingWindows`` is ported, a copy: it runs the host stage of the
next source window (slicing, broadcasting, a control-map processor) on a
background thread while the current window denoises on the card (the
reference's DecordVideoDataset prefetch contract, predictor.py:867-932).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


class PrefetchingWindows:
    """Wrap a window iterator with a 2-deep background prefetch queue.

    ``map_fn`` (optional) is applied to each item INSIDE the worker thread —
    host-side stages like controlnet processors (dwpose, canny) run there and
    overlap the consumer's device compute: window i+1's maps are computed
    while window i denoises (the reference's DecordVideoDataset prefetch
    contract, predictor.py:867-932)."""

    def __init__(self, it: Iterator[np.ndarray], depth: int = 2, map_fn=None):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: Optional[BaseException] = None

        def worker():
            try:
                for item in it:
                    self._q.put(item if map_fn is None else map_fn(item))
            except BaseException as e:  # pragma: no cover
                self._err = e
            finally:
                self._q.put(self._done)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._done:
                if self._err is not None:
                    raise self._err
                return
            yield item
