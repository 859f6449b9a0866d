"""CUDA-event ms per UNet call over the window's frames (more than one frame
a row): from the call's time embedding to its conv_out, host stalls inside
the call included, averaged over every such call of the traced window."""

from bench_port.metrics._spans import mean_ms


def read(rec):
    return mean_ms(rec, "unet", lambda s: s.out_rows > s.in_rows)
