"""The H100 SXM's published peaks (NVIDIA data sheet, dense, at its 700 W
limit) and the least time a piece of work can take on it."""

PEAK_FLOPS = 989e12  # bf16 / fp16 tensor cores
PEAK_BYTES = 3.35e12  # HBM3


def bound_s(flops: float, nbytes: float) -> float:
    """The larger of the operations over the peak rate and the bytes over
    the peak bandwidth."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def attention_bound_s(n: int, heads: int, sq: int, sk: int, d: int, elem_bytes: int = 2) -> float:
    """One attention call over (n, sq / sk, heads, d) q / k, v: two products
    of 2 n h sq sk d operations; q, k, v read once and the output written
    once."""
    flops = 4.0 * n * heads * sq * sk * d
    nbytes = elem_bytes * n * heads * d * (2 * sq + 2 * sk)
    return bound_s(flops, nbytes)
