"""CUDA-event ms of the VAE decode per frame decoded: every decode call of
the traced window over the frames they took."""

from bench_port.metrics._spans import timed


def read(rec):
    spans = timed(rec, ("vae.decode",))
    frames = sum(s.in_rows for s in spans)
    return sum(s.ms for s in spans) / frames if frames else None
