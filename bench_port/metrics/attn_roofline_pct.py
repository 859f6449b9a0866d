"""The attention kernels' share of their roofline: the least time of every
attention call the window's clips need (from the reference's shapes: the
larger of 4 n h sq sk d operations at 989 TFLOP/s and q, k, v and the
output in bf16 once at 3.35 TB/s) over the device time of every kernel
named below. The list holds the program's kernels and the library's SDPA,
cuDNN and FlashAttention kernels, so a site moved to the library still
counts."""

from bench_port.harness.peaks import attention_bound_s
from bench_port.harness.trace import kernels, matching

NAMES = (
    "flash_fwd_wgmma_kernel", "flash_fwd_wide_kernel", "flash_stream_kernel", "short_attn_kernel",
    "pytorch_flash", "flash_fwd", "flash::", "fmha", "mem_efficient", "efficient_attention",
    "cudnn_generated_fort_native_sdpa", "sdpa", "attention",
)


def read(rec):
    ops = matching(kernels(rec.ops), NAMES)
    if not ops or rec.work is None:
        return None
    bound = sum(attention_bound_s(*call) for call in rec.work.attention) * rec.clips
    return 100.0 * bound / (sum(o.dur_ns for o in ops) / 1e9)
