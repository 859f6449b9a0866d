"""The port's ONNX protobuf codec and executor against the JAX package's.

Every op the JAX executor lowers runs here through both executors on the
same encoded model (the port's ``encode_model`` bytes, parsed by each
package's own parser), inputs from numpy seeds, float32 on the CPU:
relative L2 <= 1e-5 for floating outputs, equality for integer and bool
ones. ``test_every_jax_op_is_covered`` holds the case list to the JAX
executor's ``_lower_*`` methods, so an op added there without a case here
fails; no op is left out.
"""

import numpy as np
import pytest
import torch

from musev_tpu.onnx import proto as jproto
from musev_tpu.onnx import runtime as jruntime
from musev_torch.onnx import proto
from musev_torch.onnx.proto import Graph, Model, Node, encode_model, parse_model
from musev_torch.onnx.runtime import OnnxModel, jax_bicubic_weights

REL_L2 = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: torch's OpenMP pool spun
    against the suite's other xdist workers. Restored after, as the setting
    is the process's and JAX shares it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_model(nodes, inits, inputs, outputs, opset=13):
    return Model(Graph(nodes, inits, inputs, outputs, "g"), opset=opset)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def run_both(model, feeds):
    """The same encoded bytes through the JAX executor and the port's (CPU)."""
    data = encode_model(model)
    want = jruntime.OnnxModel(jproto.parse_model(data)).run(feeds)
    got = OnnxModel(parse_model(data), device="cpu").run(feeds)
    return got, want


def assert_same(got, want, tol=REL_L2):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        if w.dtype.kind == "f":
            assert g.dtype.kind == "f"
            assert np.array_equal(np.isnan(g), np.isnan(w))
            g, w = np.nan_to_num(g), np.nan_to_num(w)
            norm = np.linalg.norm(w)
            err = np.linalg.norm(g.astype(np.float64) - w)
            assert err <= tol * max(norm, 1e-12), (err, norm)
        else:
            np.testing.assert_array_equal(g.astype(np.int64) if g.dtype != bool else g, w)


# -- protobuf ----------------------------------------------------------------------


def _attr_model():
    t = np.ones((2, 2), np.int64)
    return make_model(
        [Node("X", [], ["o"], {"f": 2.5, "i": -3, "s": b"abc", "t": t,
                               "floats": [1.0, 2.0], "ints": [4, 5, 6]}, "n0"),
         Node("MatMul", ["x", "w"], ["y"], {})],
        {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
         "h": np.arange(3, dtype=np.float16), "i": np.array([7, -1], np.int32)},
        [("x", [2, 3])], ["y", "o"])


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_proto_round_trip_against_jax(writer, reader):
    """Bytes written by one package's encoder parse to the same graph in the
    other's parser, byte for byte the same encoding."""
    m = _attr_model()
    enc = {"port": proto.encode_model, "jax": jproto.encode_model}
    dec = {"port": proto.parse_model, "jax": jproto.parse_model}
    data = enc[writer](m)
    assert data == enc[reader](m)
    got = dec[reader](data)
    assert got.opset == 13 and got.ir_version == 8
    assert got.graph.inputs == [("x", [2, 3])] and got.graph.outputs == ["y", "o"]
    assert [(n.op_type, n.inputs, n.outputs, n.name) for n in got.graph.nodes] == [
        ("X", [], ["o"], "n0"), ("MatMul", ["x", "w"], ["y"], "")]
    attrs = got.graph.nodes[0].attrs
    assert attrs["f"] == pytest.approx(2.5) and attrs["i"] == -3 and attrs["s"] == b"abc"
    np.testing.assert_array_equal(attrs["t"], np.ones((2, 2), np.int64))
    assert attrs["floats"] == [1.0, 2.0] and attrs["ints"] == [4, 5, 6]
    for k, v in m.graph.initializers.items():
        assert got.graph.initializers[k].dtype == v.dtype
        np.testing.assert_array_equal(got.graph.initializers[k], v)


def _varint(v):
    out = b""
    while True:
        b7 = v & 0x7F
        v >>= 7
        out += bytes([b7 | (0x80 if v else 0)])
        if not v:
            return out


def _tag(f, wt):
    return _varint((f << 3) | wt)


@pytest.mark.parametrize("case", ["int", "float", "fp16_int32_data"])
def test_proto3_zero_scalar_and_fp16_rules_match_jax(case):
    """A type-only scalar attribute is the proto3 default, and float16
    without raw_data reinterprets the int32_data bits: both parsers agree."""
    if case == "fp16_int32_data":
        buf = _tag(2, 0) + _varint(10) + _tag(5, 0) + _varint(0x3C00)
        (_, got), (_, want) = (m._parse_tensor(memoryview(buf)) for m in (proto, jproto))
        assert got.dtype == want.dtype == np.float16 and float(got) == float(want) == 1.0
        return
    name, code = (b"axis", 2) if case == "int" else (b"f", 1)
    buf = _tag(1, 2) + _varint(len(name)) + name + _tag(20, 0) + _varint(code)
    got, want = (m._parse_attribute(memoryview(buf)) for m in (proto, jproto))
    assert got.value == want.value == 0 and type(got.value) is type(want.value)


# -- ops ---------------------------------------------------------------------------


def _unary(op, x=None, **attrs):
    x = _rand(1, 2, 3, 4) if x is None else x
    return [Node(op, ["x"], ["y"], attrs)], {}, {"x": x}, ["y"]


def _binary(op, y_static=True):
    x, y = _rand(2, 2, 3, 4), np.abs(_rand(3, 3, 4)) + 0.5
    feeds = {"x": np.abs(x) + 0.1 if op == "Pow" else x}
    inits = {}
    (inits if y_static else feeds)["y"] = y
    return [Node(op, ["x", "y"], ["z"], {})], inits, feeds, ["z"]


def _static_chain(op, *args):
    """A static value from ``op`` scaled by a dynamic input (Mul), so both
    the static fold and its use on the device are held."""
    nodes, inits = args[0], args[1]
    return nodes + [Node("Mul", ["s", "x"], ["y"], {})], inits, {"x": _rand(4, *args[2])}, ["y"]


def _conv(**attrs):
    x, w, b = _rand(5, 1, 4, 9, 11), _rand(6, 6, 4 // attrs.get("group", 1), 3, 3), _rand(7, 6)
    return [Node("Conv", ["x", "w", "b"], ["y"], dict(kernel_shape=[3, 3], **attrs))], \
        {"w": w, "b": b}, {"x": x}, ["y"]


def _pool(op, **attrs):
    return [Node(op, ["x"], ["y"], attrs)], {}, {"x": _rand(8, 1, 2, 7, 9)}, ["y"]


def _resize(mode, ctm, scales=(1, 1, 2, 1.5), nearest=None, sizes=None):
    attrs = {"mode": mode.encode(), "coordinate_transformation_mode": ctm.encode()}
    if nearest:
        attrs["nearest_mode"] = nearest.encode()
    if sizes is not None:
        return [Node("Resize", ["x", "", "", "sz"], ["y"], attrs)], \
            {"sz": np.asarray(sizes, np.int64)}, {"x": _rand(9, 1, 2, 6, 8)}, ["y"]
    return [Node("Resize", ["x", "", "sc"], ["y"], attrs)], \
        {"sc": np.asarray(scales, np.float32)}, {"x": _rand(9, 1, 2, 6, 8)}, ["y"]


def _reduce(op, axes=(1, -1), keepdims=1):
    return [Node(op, ["x", "ax"], ["y"], {"keepdims": keepdims})], \
        {"ax": np.asarray(axes, np.int64)}, {"x": np.abs(_rand(10, 2, 3, 4)) + 0.5}, ["y"]


def _gather(op, idx, axis=1):
    return [Node(op, ["x", "i"], ["y"], {"axis": axis})], {"i": idx}, \
        {"x": _rand(11, 2, 5, 3)}, ["y"]


CASES = {
    # elementwise
    "Add": _binary("Add"),
    "Add dynamic": _binary("Add", y_static=False),
    "Sub": _binary("Sub"),
    "Mul": _binary("Mul"),
    "Div": _binary("Div"),
    "Div integer static": _static_chain(
        "Div", [Node("Div", ["a", "b"], ["q"], {}), Node("Cast", ["q"], ["s"], {"to": 1})],
        {"a": np.asarray([7, -7, 9], np.int64), "b": np.asarray([2, 2, 4], np.int64)}, (2, 3)),
    "Pow": _binary("Pow"),
    "Neg": _unary("Neg"),
    "Abs": _unary("Abs"),
    "Exp": _unary("Exp"),
    "Log": _unary("Log", np.abs(_rand(1, 2, 3)) + 0.1),
    "Sqrt": _unary("Sqrt", np.abs(_rand(1, 2, 3))),
    "Erf": _unary("Erf"),
    "Floor": _unary("Floor"),
    "Ceil": _unary("Ceil"),
    "Relu": _unary("Relu"),
    "LeakyRelu": _unary("LeakyRelu", alpha=0.2),
    "PRelu": ([Node("PRelu", ["x", "s"], ["y"], {})], {"s": _rand(12, 3, 1, 1)},
              {"x": _rand(1, 2, 3, 4, 5)}, ["y"]),
    "Elu": _unary("Elu", alpha=0.7),
    "Sigmoid": _unary("Sigmoid"),
    "HardSigmoid": _unary("HardSigmoid", alpha=0.3, beta=0.4),
    "HardSwish": _unary("HardSwish", _rand(1, 2, 3, 4) * 4),
    "Tanh": _unary("Tanh"),
    "Softplus": _unary("Softplus", _rand(1, 2, 3, 4) * 10),
    "Clip": ([Node("Clip", ["x", "lo", "hi"], ["y"], {})],
             {"lo": np.float32(-0.5) * np.ones((), np.float32), "hi": np.ones((), np.float32)},
             {"x": _rand(1, 2, 3, 4)}, ["y"]),
    "Clip attrs": _unary("Clip", min=-0.2, max=0.3),
    "Min": ([Node("Min", ["x", "y", "z"], ["o"], {})], {"z": _rand(13, 4)},
            {"x": _rand(1, 3, 4), "y": _rand(2, 3, 4)}, ["o"]),
    "Max": ([Node("Max", ["x", "y"], ["o"], {})], {}, {"x": _rand(1, 3, 4), "y": _rand(2, 3, 4)},
            ["o"]),
    "Where": ([Node("Greater", ["x", "y"], ["c"], {}), Node("Where", ["c", "x", "y"], ["o"], {})],
              {}, {"x": _rand(1, 3, 4), "y": _rand(2, 3, 4)}, ["o"]),
    "Equal": ([Node("Floor", ["x"], ["f"], {}), Node("Equal", ["f", "z"], ["o"], {})],
              {"z": np.zeros((), np.float32)}, {"x": _rand(1, 3, 4)}, ["o"]),
    "Greater": ([Node("Greater", ["x", "y"], ["o"], {})], {}, {"x": _rand(1, 3, 4),
                                                              "y": _rand(2, 3, 4)}, ["o"]),
    "Less": ([Node("Less", ["x", "y"], ["o"], {})], {"y": _rand(2, 3, 4)}, {"x": _rand(1, 3, 4)},
             ["o"]),
    "Not": ([Node("Less", ["x", "y"], ["c"], {}), Node("Not", ["c"], ["o"], {})],
            {"y": _rand(2, 3, 4)}, {"x": _rand(1, 3, 4)}, ["o"]),
    "And": ([Node("Less", ["x", "y"], ["c"], {}), Node("Greater", ["x", "z"], ["d"], {}),
             Node("And", ["c", "d"], ["o"], {})],
            {"y": _rand(2, 3, 4), "z": np.zeros((), np.float32)}, {"x": _rand(1, 3, 4)}, ["o"]),
    "Or": ([Node("Less", ["x", "y"], ["c"], {}), Node("Greater", ["x", "z"], ["d"], {}),
            Node("Or", ["c", "d"], ["o"], {})],
           {"y": _rand(2, 3, 4), "z": np.zeros((), np.float32)}, {"x": _rand(1, 3, 4)}, ["o"]),
    # matmul / norms
    "MatMul": ([Node("MatMul", ["x", "w"], ["y"], {})], {"w": _rand(14, 4, 5)},
               {"x": _rand(1, 2, 3, 4)}, ["y"]),
    "Gemm transB": ([Node("Gemm", ["a", "b", "c"], ["y"], {"transB": 1})],
                    {"b": _rand(4, 5, 3), "c": _rand(4, 5)}, {"a": _rand(4, 2, 3)}, ["y"]),
    "Gemm transA alpha beta": ([Node("Gemm", ["a", "b", "c"], ["y"],
                                     {"transA": 1, "alpha": 0.5, "beta": 2.0})],
                               {"b": _rand(4, 2, 5), "c": _rand(4, 5)}, {"a": _rand(4, 2, 3)},
                               ["y"]),
    "Conv + BatchNormalization, grouped": (
        [Node("Conv", ["x", "w"], ["c"], {"kernel_shape": [3, 3], "pads": [1, 1, 1, 1],
                                          "group": 2}),
         Node("BatchNormalization", ["c", "s", "b", "m", "v"], ["y"], {"epsilon": 1e-5})],
        {"w": _rand(15, 4, 2, 3, 3), "s": np.abs(_rand(16, 4)) + 0.5, "b": _rand(17, 4),
         "m": _rand(18, 4), "v": np.abs(_rand(19, 4)) + 0.5},
        {"x": _rand(1, 1, 4, 8, 8)}, ["y"]),
    "InstanceNormalization": ([Node("InstanceNormalization", ["x", "s", "b"], ["y"], {})],
                              {"s": _rand(20, 3), "b": _rand(21, 3)}, {"x": _rand(1, 2, 3, 5, 4)},
                              ["y"]),
    "LayerNormalization": ([Node("LayerNormalization", ["x", "s", "b"], ["y"], {"axis": -1})],
                           {"s": _rand(22, 6), "b": _rand(23, 6)}, {"x": _rand(1, 2, 5, 6)},
                           ["y"]),
    "Softmax": _unary("Softmax", axis=1),
    # conv / pool / resize
    "Conv strided": _conv(strides=[2, 2], pads=[1, 1, 1, 1]),
    "Conv SAME_UPPER dilated": _conv(auto_pad=b"SAME_UPPER", dilations=[2, 1]),
    "Conv asymmetric pads": _conv(pads=[0, 1, 2, 1]),
    "Conv grouped": _conv(group=2, pads=[1, 1, 1, 1]),
    "Conv 1-D": ([Node("Conv", ["x", "w"], ["y"], {"kernel_shape": [3], "pads": [1, 1]})],
                 {"w": _rand(24, 5, 3, 3)}, {"x": _rand(1, 2, 3, 10)}, ["y"]),
    "ConvTranspose": ([Node("ConvTranspose", ["x", "w", "b"], ["y"],
                            {"strides": [2, 2], "pads": [1, 0, 0, 1]})],
                      {"w": _rand(25, 3, 4, 3, 3), "b": _rand(26, 4)},
                      {"x": _rand(1, 1, 3, 5, 6)}, ["y"]),
    "MaxPool ceil_mode": _pool("MaxPool", kernel_shape=[3, 3], strides=[2, 2], ceil_mode=1),
    "MaxPool pads": _pool("MaxPool", kernel_shape=[3, 3], pads=[1, 1, 1, 1]),
    "AveragePool": _pool("AveragePool", kernel_shape=[2, 2], strides=[2, 2]),
    "AveragePool pads ceil_mode": _pool("AveragePool", kernel_shape=[3, 3], strides=[2, 2],
                                        pads=[1, 1, 1, 1], ceil_mode=1),
    "AveragePool count_include_pad": _pool("AveragePool", kernel_shape=[3, 3],
                                           pads=[1, 1, 1, 1], count_include_pad=1),
    "GlobalAveragePool": _pool("GlobalAveragePool"),
    "GlobalMaxPool": _pool("GlobalMaxPool"),
    "Upsample": ([Node("Upsample", ["x", "sc"], ["y"], {"mode": b"nearest"})],
                 {"sc": np.asarray([1, 1, 2, 3], np.float32)}, {"x": _rand(1, 1, 2, 3, 4)},
                 ["y"]),
    "Pad constant": ([Node("Pad", ["x", "p", "v"], ["y"], {"mode": b"constant"})],
                     {"p": np.asarray([0, 1, 2, 0, 0, 2, 1, 3], np.int64),
                      "v": np.asarray(1.5, np.float32)}, {"x": _rand(1, 1, 2, 3, 4)}, ["y"]),
    "Pad reflect": ([Node("Pad", ["x", "p"], ["y"], {"mode": b"reflect"})],
                    {"p": np.asarray([0, 0, 2, 1, 0, 0, 1, 3], np.int64)},
                    {"x": _rand(1, 1, 2, 4, 5)}, ["y"]),
    "Pad edge axes": ([Node("Pad", ["x", "p", "", "ax"], ["y"], {"mode": b"edge"})],
                      {"p": np.asarray([2, 1, 3, 2], np.int64), "ax": np.asarray([-1, 2], np.int64)},
                      {"x": _rand(1, 1, 2, 4, 5)}, ["y"]),
    # shape algebra
    "Shape Gather Unsqueeze Concat Reshape": (
        [Node("Shape", ["x"], ["sh"], {}), Node("Gather", ["sh", "i0"], ["d0"], {"axis": 0}),
         Node("Unsqueeze", ["d0", "ax"], ["d0u"], {}),
         Node("Concat", ["d0u", "minus1"], ["newshape"], {"axis": 0}),
         Node("Reshape", ["x", "newshape"], ["y"], {})],
        {"i0": np.asarray(0, np.int64), "ax": np.asarray([0], np.int64),
         "minus1": np.asarray([-1], np.int64)},
        {"x": _rand(1, 2, 3, 4)}, ["y"]),
    "Shape start end": ([Node("Shape", ["x"], ["s"], {"start": 1, "end": -1}),
                         Node("Reshape", ["x", "r"], ["y"], {}),
                         Node("ConstantOfShape", ["s"], ["o"], {})],
                        {"r": np.asarray([0, -1], np.int64)}, {"x": _rand(1, 2, 3, 4)},
                        ["y", "o", "s"]),
    "Size": _static_chain("Size", [Node("Size", ["z"], ["n"], {}),
                                   Node("Cast", ["n"], ["s"], {"to": 1})],
                          {"z": np.zeros((2, 5), np.float32)}, (3,)),
    "Transpose": _unary("Transpose", perm=[2, 0, 1]),
    "Transpose default": _unary("Transpose"),
    "Flatten": _unary("Flatten", axis=2),
    "Squeeze": ([Node("Squeeze", ["x", "ax"], ["y"], {})], {"ax": np.asarray([-1], np.int64)},
                {"x": _rand(1, 2, 3, 1)}, ["y"]),
    "Squeeze all": _unary("Squeeze", _rand(1, 1, 3, 1)),
    "Unsqueeze attrs": _unary("Unsqueeze", axes=[0, -1]),
    "Concat": ([Node("Concat", ["x", "w"], ["y"], {"axis": -1})], {"w": _rand(27, 2, 3, 2)},
               {"x": _rand(1, 2, 3, 4)}, ["y"]),
    "Split sizes": ([Node("Split", ["x", "sp"], ["p", "q"], {"axis": 1})],
                    {"sp": np.asarray([2, 4], np.int64)}, {"x": _rand(1, 1, 6, 4)}, ["p", "q"]),
    "Split attr": ([Node("Split", ["x"], ["p", "q"], {"axis": 1, "split": [2, 4]})], {},
                   {"x": _rand(1, 1, 6, 4)}, ["p", "q"]),
    "Split num_outputs": ([Node("Split", ["x"], ["p", "q", "r"], {"axis": -1, "num_outputs": 3})],
                          {}, {"x": _rand(1, 2, 6)}, ["p", "q", "r"]),
    "Gather negative indices": _gather("Gather", np.asarray([[-1, 0], [2, -5]], np.int64)),
    "Gather dynamic indices": (
        [Node("ArgMax", ["x"], ["i"], {"axis": 1, "keepdims": 0}),
         Node("Gather", ["t", "i"], ["y"], {"axis": 0})],
        {"t": _rand(28, 5, 3)}, {"x": _rand(11, 2, 5)}, ["y"]),
    "Gather out of range fills": _gather("Gather", np.asarray([-6, 5, 1], np.int64)),
    "GatherElements negative indices": _gather(
        "GatherElements", np.asarray([[[-1, 0, 4]], [[2, -5, 1]]], np.int64)),
    "Slice": ([Node("Slice", ["x", "st", "en", "ax", "sp"], ["y"], {})],
              {"st": np.asarray([1, 0], np.int64), "en": np.asarray([3, 9999], np.int64),
               "ax": np.asarray([2, -1], np.int64), "sp": np.asarray([1, 2], np.int64)},
              {"x": _rand(1, 2, 3, 4, 5)}, ["y"]),
    "Slice negative step": ([Node("Slice", ["x", "st", "en", "ax", "sp"], ["y"], {})],
                            {"st": np.asarray([-1], np.int64),
                             "en": np.asarray([-9999], np.int64),
                             "ax": np.asarray([1], np.int64), "sp": np.asarray([-2], np.int64)},
                            {"x": _rand(1, 2, 5)}, ["y"]),
    "Slice attrs (opset 9)": _unary("Slice", starts=[0, 1], ends=[1, -1], axes=[0, 2]),
    "Expand": ([Node("Expand", ["x", "sh"], ["y"], {})], {"sh": np.asarray([2, 1, 3], np.int64)},
               {"x": _rand(1, 4, 1)}, ["y"]),
    "Tile": ([Node("Tile", ["x", "r"], ["y"], {})], {"r": np.asarray([2, 1, 3], np.int64)},
             {"x": _rand(1, 2, 3, 2)}, ["y"]),
    "Cast": ([Node("Mul", ["x", "k"], ["m"], {}), Node("Cast", ["m"], ["y"], {"to": 6})],
             {"k": np.asarray(10.0, np.float32)}, {"x": _rand(1, 2, 3)}, ["y"]),
    "Identity": _unary("Identity"),
    "Constant": _static_chain("Constant", [Node("Constant", [], ["s"],
                                                {"value": _rand(29, 3)})], {}, (2, 3)),
    "Constant value_floats": _static_chain("Constant", [Node("Constant", [], ["s"],
                                                             {"value_floats": [1.5, -2.0]})],
                                           {}, (3, 2)),
    "ConstantOfShape": _static_chain(
        "ConstantOfShape", [Node("ConstantOfShape", ["sh"], ["s"],
                                 {"value": np.asarray([2.5], np.float32)})],
        {"sh": np.asarray([2, 3], np.int64)}, (2, 3)),
    "Range": _static_chain("Range", [Node("Range", ["a", "b", "c"], ["r"], {}),
                                     Node("Cast", ["r"], ["s"], {"to": 1})],
                           {"a": np.asarray(1, np.int64), "b": np.asarray(9, np.int64),
                            "c": np.asarray(3, np.int64)}, (2, 3)),
    # reductions
    "ReduceMean": _reduce("ReduceMean"),
    "ReduceSum no keepdims": _reduce("ReduceSum", keepdims=0),
    "ReduceMax": _reduce("ReduceMax"),
    "ReduceMin": _reduce("ReduceMin", axes=(0,)),
    "ReduceProd": _reduce("ReduceProd"),
    "ReduceL2": _reduce("ReduceL2"),
    "ReduceMean attr axes": _unary("ReduceMean", axes=[1], keepdims=0),
    "ArgMax": _unary("ArgMax", axis=2),
    "ArgMin": _unary("ArgMin", axis=1, keepdims=0),
    # the SiLU pattern torch exports
    "Sigmoid Mul (SiLU)": ([Node("Sigmoid", ["x"], ["s"], {}), Node("Mul", ["x", "s"], ["y"], {})],
                           {}, {"x": _rand(1, 2, 8)}, ["y"]),
}
# every Resize coordinate mode with every nearest mode, linear, cubic as JAX
for _ctm in ("half_pixel", "pytorch_half_pixel", "asymmetric", "align_corners",
             "tf_half_pixel_for_nn"):
    for _nm in ("round_prefer_floor", "round_prefer_ceil", "floor", "ceil"):
        CASES[f"Resize nearest {_ctm} {_nm}"] = _resize("nearest", _ctm, nearest=_nm)
    CASES[f"Resize linear {_ctm}"] = _resize("linear", _ctm)
CASES["Resize nearest downscale sizes"] = _resize("nearest", "asymmetric", sizes=(1, 2, 3, 5))
CASES["Resize linear downscale"] = _resize("linear", "half_pixel", scales=(1, 1, 0.5, 0.75))
CASES["Resize cubic upscale (JAX bicubic)"] = _resize("cubic", "half_pixel")
CASES["Resize cubic downscale (JAX bicubic, antialiased)"] = _resize(
    "cubic", "pytorch_half_pixel", sizes=(1, 2, 3, 5))


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    nodes, inits, feeds, outputs = CASES[name]
    inputs = [(k, list(v.shape)) for k, v in feeds.items()]
    model = make_model(nodes, inits, inputs, outputs)
    got, want = run_both(model, feeds)
    assert_same(got, want)


def test_every_jax_op_is_covered():
    """The cases above run every op the JAX executor lowers, and the port
    lowers exactly the same set."""
    jax_ops = {n[len("_lower_"):] for n in dir(jruntime.OnnxModel) if n.startswith("_lower_")}
    port_ops = {n[len("_lower_"):] for n in dir(OnnxModel) if n.startswith("_lower_")}
    covered = {n.op_type for nodes, *_ in CASES.values() for n in nodes}
    assert port_ops == jax_ops
    assert jax_ops <= covered, sorted(jax_ops - covered)


def test_resize_cubic_is_jax_bicubic_not_onnx_cubic():
    """The JAX executor's cubic Resize is ``jax.image.resize``'s bicubic
    (Keys a = -0.5, antialiased on downscale): the port's weights are
    those, and they differ from ONNX's a = -0.75 (``F.interpolate``)."""
    import jax.numpy as jnp
    import jax

    x = _rand(30, 1, 1, 6, 8)
    for size in ((1, 1, 12, 8), (1, 1, 3, 8)):
        want = np.asarray(jax.image.resize(jnp.asarray(x), size, method="bicubic"))
        w = jax_bicubic_weights(6, size[2])
        got = np.einsum("nchw,hH->ncHw", x, w)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    up = torch.nn.functional.interpolate(torch.from_numpy(x), size=(12, 8), mode="bicubic",
                                         align_corners=False).numpy()
    assert np.abs(up - np.einsum("nchw,hH->ncHw", x, jax_bicubic_weights(6, 12))).max() > 1e-3


def test_unknown_op_and_missing_cuda_raise():
    m = make_model([Node("NoSuchOp", ["x"], ["y"], {})], {}, [("x", [1])], ["y"])
    with pytest.raises(NotImplementedError, match="NoSuchOp"):
        OnnxModel(m, device="cpu").run({"x": np.zeros(1, np.float32)})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            OnnxModel(m)


def test_static_folding_keeps_shape_chains_on_the_host():
    """Shape algebra stays numpy (a Reshape's target is a host constant),
    feeds become device tensors and initializers are uploaded once."""
    nodes, inits, feeds, outputs = CASES["Shape Gather Unsqueeze Concat Reshape"]
    model = OnnxModel(make_model(nodes, inits, [("x", [2, 3, 4])], outputs), device="cpu")
    env = {}
    real = model._run_node

    def record(op, attrs, ins):
        out = real(op, attrs, ins)
        env[op] = out
        return out

    model._run_node = record
    (y,) = model.run(feeds)
    for op in ("Shape", "Gather", "Unsqueeze", "Concat"):
        assert isinstance(env[op], (np.ndarray, np.generic)), op
    assert isinstance(env["Reshape"], torch.Tensor) and y.shape == (2, 12)
    mm = OnnxModel(make_model(*CASES["MatMul"][:1], CASES["MatMul"][1], [("x", [2, 3, 4])],
                              ["y"]), device="cpu")
    mm.run(CASES["MatMul"][2])
    first = dict(mm._uploaded)
    mm.run(CASES["MatMul"][2])
    assert len(first) == 1 and all(mm._uploaded[k] is v for k, v in first.items())
