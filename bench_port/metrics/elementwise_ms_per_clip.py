"""Device ms per clip of the kernels that are neither a product (GEMM or
convolution, by the names below) nor attention (by the attention
roofline's list): the unfused elementwise, norm, copy and layout traffic."""

from bench_port.harness.trace import kernels, matching
from bench_port.metrics.attn_roofline_pct import NAMES as ATTENTION

PRODUCTS = (
    "gemm", "xmma", "nvjet", "cutlass", "cublas", "sm90_", "sm80_", "ampere_", "hopper_",
    "conv", "fprop", "dgrad", "wgrad", "winograd", "splitk", "matmul",
)


def read(rec):
    ks = kernels(rec.ops)
    if not ks:
        return None
    skip = {id(o) for o in matching(ks, ATTENTION + PRODUCTS)}
    return sum(o.dur_ns for o in ks if id(o) not in skip) / 1e6 / rec.clips
