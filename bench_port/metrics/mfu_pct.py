"""The whole clip's share of the card's bf16 peak: the clip's model
operations (GEMM, convolution and attention products, counted by
FlopCounterMode over the reference at the cell's shapes) over the traced
window's time per clip times 989 TFLOP/s."""

from bench_port.harness.peaks import PEAK_FLOPS


def read(rec):
    if rec.work is None or not rec.clips:
        return None
    return 100.0 * rec.work.flops / (rec.window_s / rec.clips * PEAK_FLOPS)
