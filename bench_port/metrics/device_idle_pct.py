"""Share of the traced window in which no device operation ran: the union
of the operations' intervals, not the sum of their durations."""

from bench_port.harness.trace import busy_ns


def read(rec):
    lo, hi = rec.window_ns
    if not rec.ops or hi <= lo:
        return None
    return 100.0 * (1.0 - busy_ns(rec.ops, lo, hi) / (hi - lo))
