"""First-party ONNX support: protobuf reader/writer + PyTorch executor
(counterpart of ``musev_tpu/onnx``).

Replaces the reference's onnxruntime dependency for the host stages
(dwpose, face embedding, SAM, the ONNX map processors).
"""

from .proto import Model, Graph, Node, load_model, save_model, parse_model, encode_model  # noqa: F401
from .runtime import OnnxModel  # noqa: F401
