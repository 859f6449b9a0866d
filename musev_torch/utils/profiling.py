"""Tracing and per-phase timing (counterpart of ``musev_tpu/utils/profiling.py``).

``PhaseTimers`` accumulates named wall-clock timers that synchronise the
device at each phase edge where asked (PyTorch returns before the card
finishes, as JAX dispatches asynchronously); ``trace`` captures a
``torch.profiler`` trace; ``device_status`` snapshots each CUDA device's
memory with the JAX package's keys.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Dict, Optional

import torch

logger = logging.getLogger(__name__)


def _synchronize(block_on) -> None:
    """Wait for the CUDA work behind ``block_on``: a tensor, or nested lists,
    tuples and dicts of them (the JAX package's ``block_until_ready``)."""
    if isinstance(block_on, torch.Tensor):
        if block_on.is_cuda:
            torch.cuda.synchronize(block_on.device)
    elif isinstance(block_on, dict):
        for v in block_on.values():
            _synchronize(v)
    elif isinstance(block_on, (list, tuple)):
        for v in block_on:
            _synchronize(v)


class PhaseTimers:
    """Accumulating named wall-clock timers.

    Usage:
        timers = PhaseTimers()
        with timers.phase("denoise", block_on=latents):
            latents = run(...)

    ``block_on`` is read when the phase ends, so pass what exists before it
    (or a container the phase fills); its CUDA devices are synchronised
    before the time is taken.
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = [
            f"{name}: {total:.3f}s / {self.counts[name]} calls"
            for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)

    def as_json(self) -> str:
        return json.dumps(
            {k: {"seconds": v, "calls": self.counts[k]} for k, v in self.totals.items()}
        )


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace (CPU, and CUDA where available)
    into ``log_dir`` as a Chrome trace; a no-op without ``log_dir``."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    logger.info("wrote profiler trace to %s", path)


def device_status() -> list:
    """Per-device memory snapshot (the counterpart of mmcm ``get_gpu_status``,
    imported by the reference at temporal_transformer.py:35): a dict per
    CUDA device with ``id``, ``platform``, ``device_kind``, and
    ``bytes_in_use`` (``memory_allocated``), ``bytes_limit`` (the device's
    total memory) and ``utilization``; without CUDA, one CPU entry with no
    memory stats, as the JAX package reports CPU devices."""
    if not torch.cuda.is_available():
        return [{"id": 0, "platform": "cpu", "device_kind": "cpu"}]
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        used = int(stats.get("allocated_bytes.all.current", 0))
        out.append({"id": i, "platform": "gpu", "device_kind": torch.cuda.get_device_name(i),
                    "bytes_in_use": used, "bytes_limit": int(total),
                    "utilization": used / int(total)})
    return out


def log_device_status(prefix: str = "") -> None:
    for e in device_status():
        if "bytes_in_use" in e:
            logger.info(
                "%sdevice %d (%s): %.2f/%.2f GiB in use",
                prefix, e["id"], e["device_kind"], e["bytes_in_use"] / 2**30,
                e.get("bytes_limit", 0) / 2**30,
            )
        else:
            logger.info("%sdevice %d (%s): no memory stats", prefix, e["id"], e["device_kind"])
