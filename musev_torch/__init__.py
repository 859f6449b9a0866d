"""musev_torch: the PyTorch/CUDA port of musev_tpu, for one NVIDIA H100.

It mirrors ``musev_tpu``'s module layout and names and imports nothing of it
(nor JAX). Entry points (``pipelines.loader.build_models``,
``pipelines.pipeline.MusevPipeline``) run on CUDA unless the caller passes
``device="cpu"``; without CUDA they raise.

Layouts: public functions keep the JAX package's layouts, latents
``(B, T, h, w, C)`` and attention ``(B, S, H, D)``. Inside, activations are
channels-last contiguous tensors and a convolution sees them as NCHW views in
``channels_last`` memory format, cuDNN's NHWC path, so no layout copies are
made around convolutions. Precision on the card: bf16 activations, float32
GroupNorm/LayerNorm statistics, float32 latents and scheduler math.

Kernels: every Pallas TPU kernel of the repository is hand-written CUDA C++
for sm_90a under ``csrc/``, built by nvcc at first use
(``ops/kernels/_build.py``) and bound with ctypes: ``flash_attention.cu``
(Pallas K1 + K3, with the K1s softmax stats), ``flash_stream.cu`` (K2),
``short_attention.cu`` (K4) and ``pivot.cu`` (the temporal-rows pivots K5,
K6 and K7).
"""


def __getattr__(name):
    # the JAX package's top-level mesh helpers (musev_tpu/__init__.py:42-45)
    if name in ("make_mesh", "batch_sharding"):
        from .parallel import mesh as _m

        return getattr(_m, name)
    raise AttributeError(name)
