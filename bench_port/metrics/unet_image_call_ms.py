"""CUDA-event ms per UNet call at one frame a row (the text-to-image
condition frame's calls), averaged over every such call of the traced
window."""

from bench_port.metrics._spans import mean_ms


def read(rec):
    return mean_ms(rec, "unet", lambda s: s.out_rows == s.in_rows)
