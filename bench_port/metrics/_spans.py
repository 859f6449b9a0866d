"""What the span readers share."""


def timed(rec, labels, keep=lambda s: True):
    return [s for s in rec.spans if s.label in labels and s.ms is not None and keep(s)]


def mean_ms(rec, label, keep):
    spans = timed(rec, (label,), keep)
    return sum(s.ms for s in spans) / len(spans) if spans else None
