"""The allocator's peak over the window (``torch.cuda.max_memory_allocated``
after ``reset_peak_memory_stats`` at its start), in GB (1e9 bytes)."""


def read(rec):
    return rec.peak_bytes / 1e9 if rec.peak_bytes else None
