"""Device kernels per clip in the profiler's record of the traced window
(copies and memsets not counted)."""

from bench_port.harness.trace import kernels


def read(rec):
    n = len(kernels(rec.ops))
    return n / rec.clips if n else None
