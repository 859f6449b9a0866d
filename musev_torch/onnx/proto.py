"""Minimal ONNX protobuf reader/writer (counterpart of ``musev_tpu/onnx/proto.py``).

A copy of the JAX package's numpy-only module (the port imports nothing of
``musev_tpu``): neither onnxruntime nor the ``onnx`` package is needed, so
the protobuf wire format is read and written directly for the subset of the
ONNX schema the executor (``musev_torch.onnx.runtime``) needs: graph
topology, node attributes and initializer tensors. Field numbers follow the
public onnx.proto3 spec. Two decoding rules matter for real exports: proto3
serializers omit zero-valued scalar attributes (a type-only INT attribute
is 0, not None), and float16 tensors without ``raw_data`` keep their bit
patterns in ``int32_data``.

The encoder writes test graphs and the seeded stand-in graphs
(``musev_torch.onnx.standins``), and keeps model surgery possible without
external tooling.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

# -- wire format -------------------------------------------------------------

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: memoryview):
    """Yield (field_number, wire_type, value) over one message's bytes."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == _VARINT:
            val, pos = _read_varint(buf, pos)
        elif wt == _I64:
            val = buf[pos : pos + 8]
            pos += 8
        elif wt == _LEN:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wt == _I32:
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt} (field {field})")
        yield field, wt, val


def _zigzag64(v: int) -> int:
    # onnx int64 fields are plain varints (two's complement for negatives)
    if v >= 1 << 63:
        v -= 1 << 64
    return v


def _packed_or_single(wt, val, fmt: str, size: int) -> List:
    """repeated scalar field: packed (LEN) or one-per-tag encodings."""
    if wt == _LEN:
        k = len(val) // size
        return list(struct.unpack(f"<{k}{fmt}", bytes(val)))
    return [struct.unpack(f"<{fmt}", bytes(val))[0]]


# -- schema (subset) ----------------------------------------------------------

# TensorProto.DataType
TENSOR_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}
DTYPE_CODES = {np.dtype(v): k for k, v in TENSOR_DTYPES.items()}


@dataclasses.dataclass
class Attribute:
    name: str
    value: object  # float | int | bytes | np.ndarray | list | "Graph"


@dataclasses.dataclass
class Node:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, object]
    name: str = ""


@dataclasses.dataclass
class Graph:
    nodes: List[Node]
    initializers: Dict[str, np.ndarray]
    inputs: List[Tuple[str, Optional[List[int]]]]  # (name, shape or None)
    outputs: List[str]
    name: str = ""


@dataclasses.dataclass
class Model:
    graph: Graph
    opset: int = 13
    ir_version: int = 8


def _parse_tensor(buf: memoryview) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    data_type = 1
    raw = b""
    floats: List[float] = []
    ints: List[int] = []
    doubles: List[float] = []
    name = ""
    for field, wt, val in _iter_fields(buf):
        if field == 1:  # dims
            if wt == _LEN:  # packed
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    dims.append(_zigzag64(v))
            else:
                dims.append(_zigzag64(val))
        elif field == 2:
            data_type = val
        elif field == 4:  # float_data
            floats.extend(_packed_or_single(wt, val, "f", 4))
        elif field == 5:  # int32_data
            if wt == _LEN:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    ints.append(_zigzag64(v))
            else:
                ints.append(_zigzag64(val))
        elif field == 7:  # int64_data
            if wt == _LEN:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    ints.append(_zigzag64(v))
            else:
                ints.append(_zigzag64(val))
        elif field == 8:
            name = bytes(val).decode("utf-8")
        elif field == 9:
            raw = bytes(val)
        elif field == 10:  # double_data
            doubles.extend(_packed_or_single(wt, val, "d", 8))
        elif field == 13:
            raise ValueError(
                f"tensor {name!r} uses external data files — not supported; "
                "re-export the onnx model with embedded weights"
            )
    np_dtype = TENSOR_DTYPES.get(data_type)
    if np_dtype is None:
        raise ValueError(f"tensor {name!r}: unsupported data_type {data_type}")
    if raw:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif floats:
        arr = np.asarray(floats, dtype=np_dtype)
    elif doubles:
        arr = np.asarray(doubles, dtype=np_dtype)
    elif np_dtype == np.float16:
        # fp16 without raw_data stores the uint16 BIT PATTERNS in
        # int32_data (onnx.proto TensorProto.int32_data comment); a value
        # cast would turn 0x3C00 (1.0) into 15360.0
        arr = np.asarray(ints, dtype=np.uint16).view(np.float16)
    else:
        arr = np.asarray(ints, dtype=np_dtype)
    return name, arr.reshape(dims) if dims else arr.reshape(())


def _parse_attribute(buf: memoryview) -> Attribute:
    name = ""
    a_type = None
    f = i = s = t = g = None
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    for field, wt, val in _iter_fields(buf):
        if field == 1:
            name = bytes(val).decode("utf-8")
        elif field == 2:
            f = struct.unpack("<f", bytes(val))[0]
        elif field == 3:
            i = _zigzag64(val)
        elif field == 4:
            s = bytes(val)
        elif field == 5:
            t = _parse_tensor(val)[1]
        elif field == 6:
            g = _parse_graph(val)
        elif field == 7:
            floats.extend(_packed_or_single(wt, val, "f", 4))
        elif field == 8:
            if wt == _LEN:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    ints.append(_zigzag64(v))
            else:
                ints.append(_zigzag64(val))
        elif field == 9:
            strings.append(bytes(val))
        elif field == 20:
            a_type = val
    # AttributeProto.AttributeType: FLOAT=1 INT=2 STRING=3 TENSOR=4 GRAPH=5
    # FLOATS=6 INTS=7 STRINGS=8
    # proto3 serializers omit zero-valued scalar fields entirely (e.g.
    # Gather.axis=0, MaxPool.ceil_mode=0 write only type=INT): when the
    # type says scalar but the value field is absent, the value IS the
    # proto3 default, not None
    if a_type == 1 or (a_type is None and f is not None):
        return Attribute(name, f if f is not None else 0.0)
    if a_type == 2 or (a_type is None and i is not None):
        return Attribute(name, i if i is not None else 0)
    if a_type == 3 or (a_type is None and s is not None):
        return Attribute(name, s if s is not None else b"")
    if a_type == 4 or (a_type is None and t is not None):
        return Attribute(name, t)
    if a_type == 5 or (a_type is None and g is not None):
        return Attribute(name, g)
    if a_type == 6 or floats:
        return Attribute(name, floats)
    if a_type == 7 or ints:
        return Attribute(name, ints)
    if a_type == 8 or strings:
        return Attribute(name, strings)
    return Attribute(name, None)


def _parse_node(buf: memoryview) -> Node:
    inputs: List[str] = []
    outputs: List[str] = []
    op_type = ""
    name = ""
    attrs: Dict[str, object] = {}
    for field, wt, val in _iter_fields(buf):
        if field == 1:
            inputs.append(bytes(val).decode("utf-8"))
        elif field == 2:
            outputs.append(bytes(val).decode("utf-8"))
        elif field == 3:
            name = bytes(val).decode("utf-8")
        elif field == 4:
            op_type = bytes(val).decode("utf-8")
        elif field == 5:
            a = _parse_attribute(val)
            attrs[a.name] = a.value
    return Node(op_type, inputs, outputs, attrs, name)


def _parse_value_info(buf: memoryview) -> Tuple[str, Optional[List[int]]]:
    name = ""
    shape: Optional[List[int]] = None
    for field, _, val in _iter_fields(buf):
        if field == 1:
            name = bytes(val).decode("utf-8")
        elif field == 2:  # TypeProto
            for f2, _, v2 in _iter_fields(val):
                if f2 == 1:  # tensor_type
                    for f3, _, v3 in _iter_fields(v2):
                        if f3 == 2:  # shape
                            shape = []
                            for f4, _, v4 in _iter_fields(v3):
                                if f4 == 1:  # dim
                                    dv = -1
                                    for f5, _, v5 in _iter_fields(v4):
                                        if f5 == 1:
                                            dv = _zigzag64(v5)
                                    shape.append(dv)
    return name, shape


def _parse_graph(buf: memoryview) -> Graph:
    nodes: List[Node] = []
    inits: Dict[str, np.ndarray] = {}
    inputs: List[Tuple[str, Optional[List[int]]]] = []
    outputs: List[str] = []
    name = ""
    for field, _, val in _iter_fields(buf):
        if field == 1:
            nodes.append(_parse_node(val))
        elif field == 2:
            name = bytes(val).decode("utf-8")
        elif field == 5:
            tname, arr = _parse_tensor(val)
            inits[tname] = arr
        elif field == 11:
            inputs.append(_parse_value_info(val))
        elif field == 12:
            outputs.append(_parse_value_info(val)[0])
    return Graph(nodes, inits, inputs, outputs, name)


def parse_model(data: bytes) -> Model:
    buf = memoryview(data)
    graph = None
    opset = 13
    ir_version = 8
    for field, _, val in _iter_fields(buf):
        if field == 1:
            ir_version = val
        elif field == 7:
            graph = _parse_graph(val)
        elif field == 8:  # opset_import
            for f2, _, v2 in _iter_fields(val):
                if f2 == 2:
                    opset = v2
    if graph is None:
        raise ValueError("no GraphProto in model")
    return Model(graph, opset=opset, ir_version=ir_version)


def load_model(path: str) -> Model:
    with open(path, "rb") as fh:
        return parse_model(fh.read())


# -- encoder (tests / model surgery) ------------------------------------------


def _w_varint(out: bytearray, v: int) -> None:
    if v < 0:
        v += 1 << 64
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _w_tag(out: bytearray, field: int, wt: int) -> None:
    _w_varint(out, (field << 3) | wt)


def _w_len(out: bytearray, field: int, payload: bytes) -> None:
    _w_tag(out, field, _LEN)
    _w_varint(out, len(payload))
    out.extend(payload)


def _w_str(out: bytearray, field: int, s: str) -> None:
    _w_len(out, field, s.encode("utf-8"))


def _enc_tensor(name: str, arr: np.ndarray) -> bytes:
    out = bytearray()
    for d in arr.shape:
        _w_tag(out, 1, _VARINT)
        _w_varint(out, d)
    _w_tag(out, 2, _VARINT)
    _w_varint(out, DTYPE_CODES[arr.dtype])
    _w_str(out, 8, name)
    _w_len(out, 9, np.ascontiguousarray(arr).tobytes())
    return bytes(out)


def _enc_attr(name: str, value) -> bytes:
    out = bytearray()
    _w_str(out, 1, name)
    if isinstance(value, float):
        _w_tag(out, 2, _I32)
        out.extend(struct.pack("<f", value))
        _w_tag(out, 20, _VARINT)
        _w_varint(out, 1)
    elif isinstance(value, (bool, int, np.integer)):
        _w_tag(out, 3, _VARINT)
        _w_varint(out, int(value))
        _w_tag(out, 20, _VARINT)
        _w_varint(out, 2)
    elif isinstance(value, (str, bytes)):
        _w_len(out, 4, value.encode() if isinstance(value, str) else value)
        _w_tag(out, 20, _VARINT)
        _w_varint(out, 3)
    elif isinstance(value, np.ndarray):
        _w_len(out, 5, _enc_tensor("", value))
        _w_tag(out, 20, _VARINT)
        _w_varint(out, 4)
    elif isinstance(value, (list, tuple)) and value and isinstance(
        value[0], float
    ):
        for v in value:
            _w_tag(out, 7, _I32)
            out.extend(struct.pack("<f", v))
        _w_tag(out, 20, _VARINT)
        _w_varint(out, 6)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _w_tag(out, 8, _VARINT)
            _w_varint(out, int(v))
        _w_tag(out, 20, _VARINT)
        _w_varint(out, 7)
    else:
        raise TypeError(f"cannot encode attribute {name}={value!r}")
    return bytes(out)


def _enc_value_info(name: str, shape: Optional[List[int]]) -> bytes:
    dims = bytearray()
    if shape is not None:
        for d in shape:
            dim = bytearray()
            _w_tag(dim, 1, _VARINT)
            _w_varint(dim, d)
            _w_len(dims, 1, bytes(dim))
    tensor_type = bytearray()
    _w_tag(tensor_type, 1, _VARINT)
    _w_varint(tensor_type, 1)  # elem_type float
    _w_len(tensor_type, 2, bytes(dims))
    type_proto = bytearray()
    _w_len(type_proto, 1, bytes(tensor_type))
    out = bytearray()
    _w_str(out, 1, name)
    _w_len(out, 2, bytes(type_proto))
    return bytes(out)


def encode_model(model: Model) -> bytes:
    g = model.graph
    gb = bytearray()
    for n in g.nodes:
        nb = bytearray()
        for s in n.inputs:
            _w_str(nb, 1, s)
        for s in n.outputs:
            _w_str(nb, 2, s)
        if n.name:
            _w_str(nb, 3, n.name)
        _w_str(nb, 4, n.op_type)
        for k, v in n.attrs.items():
            _w_len(nb, 5, _enc_attr(k, v))
        _w_len(gb, 1, bytes(nb))
    _w_str(gb, 2, g.name or "graph")
    for name, arr in g.initializers.items():
        _w_len(gb, 5, _enc_tensor(name, arr))
    for name, shape in g.inputs:
        _w_len(gb, 11, _enc_value_info(name, shape))
    for name in g.outputs:
        _w_len(gb, 12, _enc_value_info(name, None))
    out = bytearray()
    _w_tag(out, 1, _VARINT)
    _w_varint(out, model.ir_version)
    opset = bytearray()
    _w_tag(opset, 2, _VARINT)
    _w_varint(opset, model.opset)
    _w_len(out, 8, bytes(opset))
    _w_len(out, 7, bytes(gb))
    return bytes(out)


def save_model(model: Model, path: str) -> None:
    with open(path, "wb") as fh:
        fh.write(encode_model(model))
