"""CUDA-event ms per clip of the conditioning encoders: the ReferenceNet,
CLIP vision and the IP-Adapter projection."""

from bench_port.metrics._spans import timed

LABELS = ("referencenet", "clip_vision", "ip_proj")


def read(rec):
    spans = timed(rec, LABELS)
    return sum(s.ms for s in spans) / rec.clips if spans else None
