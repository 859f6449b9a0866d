"""Seeded stand-in ONNX graphs at the published shapes of the host stages' models.

The real graphs (DWPose's ``yolox_l.onnx`` and ``dw-ll_ucoco_384.onnx``,
insightface's SCRFD ``det_10g`` and ArcFace ``w600k_r50``, SAM's encoder
and decoder, a depth net) are external files that are not in the
repository. These functions write graphs with the same input and output
names and shapes through the port's own ``encode_model``, with seeded
weights, so the executor and the host stages run at full size without
them:

* each backbone is one Conv + BatchNormalization + SiLU (Sigmoid * Mul)
  block per stage at the published stage widths, with the heads' Resize,
  Concat, Reshape, Transpose, MatMul/Gemm, Softmax and LayerNormalization;
* where the stage decodes detections or keypoints, the graph's output is
  the backbone's head scaled by a small seeded constant (about 1e-3) plus
  a constant table that places them (one confident person, SimCC peaks
  spread over the crop, one face), so the decoded result is deterministic
  while the backbone still does the full-size work.

Each ``*_graph`` returns a ``Model``; ``write_standins(directory)`` writes
them all and returns their paths. The tables are exposed
(``person_box``, ``simcc_peaks``, ``face_box``) so that a caller can check
what the stages decode.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .proto import Graph, Model, Node, save_model

HEAD_SCALE = 1e-3  # the backbone's share of a detector or pose output


class _Builder:
    """Appends nodes and seeded initializers to one graph."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.nodes: List[Node] = []
        self.inits: Dict[str, np.ndarray] = {}
        self.n = 0

    def _name(self, prefix: str) -> str:
        self.n += 1
        return f"{prefix}_{self.n}"

    def const(self, arr, prefix: str = "c") -> str:
        name = self._name(prefix)
        self.inits[name] = np.asarray(arr)
        return name

    def op(self, op_type: str, inputs, attrs=None, n_out: int = 1):
        outs = [self._name(op_type.lower()) for _ in range(n_out)]
        self.nodes.append(Node(op_type, list(inputs), outs, dict(attrs or {})))
        return outs[0] if n_out == 1 else outs

    def weight(self, *shape, fan_in: int) -> str:
        w = self.rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
        return self.const(w.astype(np.float32), "w")

    def silu(self, x: str) -> str:
        return self.op("Mul", [x, self.op("Sigmoid", [x])])

    def conv(self, x: str, cin: int, cout: int, k: int = 3, s: int = 1, bias: bool = False,
             group: int = 1) -> str:
        ins = [x, self.weight(cout, cin // group, k, k, fan_in=cin // group * k * k)]
        if bias:
            ins.append(self.const(np.zeros(cout, np.float32), "b"))
        return self.op("Conv", ins, dict(kernel_shape=[k, k], strides=[s, s],
                                         pads=[k // 2] * 4, group=group))

    def conv_block(self, x: str, cin: int, cout: int, k: int = 3, s: int = 2) -> str:
        """Conv + BatchNormalization + SiLU, the exports' stage block."""
        y = self.conv(x, cin, cout, k, s)
        bn = [self.const(v.astype(np.float32), "bn") for v in (
            1.0 + 0.1 * self.rng.standard_normal(cout), 0.1 * self.rng.standard_normal(cout),
            0.1 * self.rng.standard_normal(cout), 1.0 + 0.1 * self.rng.uniform(size=cout))]
        y = self.op("BatchNormalization", [y, *bn], {"epsilon": 1e-5})
        return self.silu(y)

    def linear(self, x: str, cin: int, cout: int) -> str:
        y = self.op("MatMul", [x, self.weight(cin, cout, fan_in=cin)])
        return self.op("Add", [y, self.const(np.zeros(cout, np.float32), "b")])

    def layer_norm(self, x: str, c: int) -> str:
        return self.op("LayerNormalization", [x, self.const(np.ones(c, np.float32), "g"),
                                              self.const(np.zeros(c, np.float32), "b")],
                       {"axis": -1, "epsilon": 1e-6})

    def reshape(self, x: str, shape) -> str:
        return self.op("Reshape", [x, self.const(np.asarray(shape, np.int64), "shape")])

    def table(self, head: str, table: np.ndarray) -> str:
        """head * (a seeded constant near HEAD_SCALE) + table."""
        scale = np.float32(HEAD_SCALE * (1.0 + 0.1 * self.rng.uniform()))
        y = self.op("Mul", [head, self.const(scale, "scale")])
        return self.op("Add", [y, self.const(table.astype(np.float32), "table")])

    def model(self, inputs, outputs, name: str) -> Model:
        return Model(Graph(self.nodes, self.inits, inputs, outputs, name), opset=17)


# -- yolox_l.onnx (DWPose's person detector) -------------------------------------

YOLOX_SIZE = 640
YOLOX_WIDTHS = (64, 128, 256, 512, 1024)  # strides 2, 4, 8, 16, 32
YOLOX_ANCHORS = sum((YOLOX_SIZE // s) ** 2 for s in (8, 16, 32))  # 8400


def person_box(frame_hw: Tuple[int, int] = (576, 576)) -> np.ndarray:
    """The (x1, y1, x2, y2) box, in frame pixels, that the detector's table
    places: centred, 0.35 of the width by 0.8 of the height."""
    h, w = frame_hw
    return np.array([w * 0.325, h * 0.1, w * 0.675, h * 0.9], np.float32)


def yolox_graph(seed: int = 0, person: bool = True,
                frame_hw: Tuple[int, int] = (576, 576)) -> Model:
    """(1, 3, 640, 640) BGR 0-255 -> (1, 8400, 85) raw head (cx, cy
    offsets and log sizes on the stride-8/16/32 grids, objectness, 80
    class scores). The table places ``person_box(frame_hw)`` (letterboxed
    into 640) at one stride-32 anchor with objectness and person score
    0.95, or nothing with ``person=False``."""
    b = _Builder(seed)
    x = b.op("Mul", ["images", b.const(np.float32(1 / 255.0))])
    feats, c = [], 3
    for width in YOLOX_WIDTHS:
        x = b.conv_block(x, c, width)
        feats.append(x)
        c = width
    p3, p4, p5 = feats[2:]
    up = b.op("Resize", [p5, "", b.const(np.asarray([1, 1, 2, 2], np.float32))],
              {"mode": b"nearest", "coordinate_transformation_mode": b"asymmetric",
               "nearest_mode": b"floor"})
    p4 = b.conv_block(b.op("Concat", [p4, up], {"axis": 1}), 512 + 1024, 512, k=1, s=1)
    heads = []
    for feat, cin, stride in ((p3, 256, 8), (p4, 512, 16), (p5, 1024, 32)):
        n = (YOLOX_SIZE // stride) ** 2
        heads.append(b.reshape(b.conv(feat, cin, 85, k=1, bias=True), [1, 85, n]))
    out = b.op("Transpose", [b.op("Concat", heads, {"axis": 2})], {"perm": [0, 2, 1]})
    table = np.zeros((1, YOLOX_ANCHORS, 85), np.float32)
    if person:
        ratio = min(YOLOX_SIZE / frame_hw[0], YOLOX_SIZE / frame_hw[1])
        x1, y1, x2, y2 = person_box(frame_hw) * ratio
        cx, cy, bw, bh = (x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1
        g = YOLOX_SIZE // 32
        gx, gy = int(cx // 32), int(cy // 32)
        i = (YOLOX_SIZE // 8) ** 2 + (YOLOX_SIZE // 16) ** 2 + gy * g + gx
        table[0, i, :6] = [cx / 32 - gx, cy / 32 - gy, np.log(bw / 32), np.log(bh / 32),
                           0.95, 0.95]
    return b.model([("images", [1, 3, YOLOX_SIZE, YOLOX_SIZE])], [b.table(out, table)],
                   "yolox_l_standin")


# -- dw-ll_ucoco_384.onnx (DWPose's RTMPose whole-body model) ---------------------

POSE_WH = (288, 384)
POSE_KEYPOINTS = 133
POSE_WIDTHS = (64, 128, 256, 512, 1024)


def simcc_peaks(seed: int = 0) -> np.ndarray:
    """(133, 2) integer SimCC bins (x of 576, y of 768) of the table's
    peaks: spread over the middle of the crop."""
    rng = np.random.default_rng(seed + 1000)
    xs = rng.integers(2 * 40, 2 * (POSE_WH[0] - 40), POSE_KEYPOINTS)
    ys = rng.integers(2 * 40, 2 * (POSE_WH[1] - 40), POSE_KEYPOINTS)
    return np.stack([xs, ys], axis=1)


def rtmpose_graph(seed: int = 1) -> Model:
    """(1, 3, 384, 288) ImageNet-normalised crop -> SimCC (1, 133, 576) and
    (1, 133, 768); the table puts a peak of 1 at ``simcc_peaks(seed)``."""
    b = _Builder(seed)
    x, c = "input", 3
    for width in POSE_WIDTHS:
        x = b.conv_block(x, c, width)
        c = width
    hw = (POSE_WH[1] // 32) * (POSE_WH[0] // 32)  # 12 x 9
    k = b.reshape(b.conv(x, c, POSE_KEYPOINTS, k=1, bias=True), [1, POSE_KEYPOINTS, hw])
    h = b.silu(b.linear(b.layer_norm(k, hw), hw, 256))
    outs = []
    peaks = simcc_peaks(seed)
    for axis, bins in ((0, 2 * POSE_WH[0]), (1, 2 * POSE_WH[1])):
        table = np.zeros((1, POSE_KEYPOINTS, bins), np.float32)
        table[0, np.arange(POSE_KEYPOINTS), peaks[:, axis]] = 1.0
        outs.append(b.table(b.linear(h, 256, bins), table))
    return b.model([("input", [1, 3, POSE_WH[1], POSE_WH[0]])], outs, "rtmpose_standin")


# -- SCRFD det_10g (insightface face detector) -------------------------------------

SCRFD_SIZE = 640
SCRFD_WIDTHS = (32, 64, 128, 256, 512)  # strides 2 .. 32; heads at 8, 16, 32
ARCFACE_DST = np.array([[38.2946, 51.6963], [73.5318, 51.5014], [56.0252, 71.7366],
                        [41.5493, 92.3655], [70.7299, 92.2041]], np.float32)


def face_box(frame_hw: Tuple[int, int] = (576, 576)) -> Tuple[float, float, float]:
    """(cx, cy, half side) in frame pixels of the face the SCRFD table
    places."""
    h, w = frame_hw
    return w * 0.5, h * 0.35, min(h, w) * 0.12


def scrfd_graph(seed: int = 2, frame_hw: Tuple[int, int] = (576, 576)) -> Model:
    """(1, 3, 640, 640) -> the 9 head tensors ``scrfd_decode`` reads: scores
    (M_s, 1), bbox distances (M_s, 4), landmark distances (M_s, 10) for
    strides 8/16/32, two anchors per cell. The table places one face,
    score 0.9, at ``face_box(frame_hw)`` with the arcface template's five
    landmarks."""
    b = _Builder(seed)
    x, c = "input.1", 3
    feats = []
    for width in SCRFD_WIDTHS:
        x = b.conv_block(x, c, width)
        feats.append(x)
        c = width
    ratio = min(SCRFD_SIZE / frame_hw[0], SCRFD_SIZE / frame_hw[1])
    cx, cy, half = (v * ratio for v in face_box(frame_hw))
    outs = {"score": [], "bbox": [], "kps": []}
    for feat, cin, stride in zip(feats[2:], SCRFD_WIDTHS[2:], (8, 16, 32)):
        g = SCRFD_SIZE // stride
        m = g * g * 2
        tables = {k: np.zeros((m, n), np.float32) for k, n in (("score", 1), ("bbox", 4),
                                                                ("kps", 10))}
        if stride == 8:
            gx, gy = int(cx // 8), int(cy // 8)
            idx, ax, ay = (gy * g + gx) * 2, gx * 8, gy * 8
            tables["score"][idx] = 0.9
            tables["bbox"][idx] = [(ax - (cx - half)) / 8, (ay - (cy - half)) / 8,
                                   ((cx + half) - ax) / 8, ((cy + half) - ay) / 8]
            kps = (ARCFACE_DST - 56.0) * (2 * half / 112.0) + [cx, cy]
            tables["kps"][idx] = ((kps - [ax, ay]) / 8).reshape(-1)
        for key, n in (("score", 1), ("bbox", 4), ("kps", 10)):
            head = b.conv(feat, cin, 2 * n, k=1, bias=True)  # (1, 2n, g, g)
            head = b.op("Transpose", [head], {"perm": [0, 2, 3, 1]})
            outs[key].append(b.table(b.reshape(head, [m, n]), tables[key]))
    return b.model([("input.1", [1, 3, SCRFD_SIZE, SCRFD_SIZE])],
                   outs["score"] + outs["bbox"] + outs["kps"], "scrfd_standin")


# -- ArcFace w600k_r50 (insightface recognition) ------------------------------------

ARCFACE_WIDTHS = (64, 128, 256, 512)


def arcface_graph(seed: int = 3) -> Model:
    """(1, 3, 112, 112) aligned face in [-1, 1] -> (1, 512) embedding: the
    backbone, global average pooling, a Gemm and a BatchNormalization, as
    the published export ends (no table: the embedding is the net's)."""
    b = _Builder(seed)
    x, c = "input.1", 3
    for width in ARCFACE_WIDTHS:
        x = b.conv_block(x, c, width)
        c = width
    x = b.op("Flatten", [b.op("GlobalAveragePool", [x])], {"axis": 1})
    x = b.op("Gemm", [x, b.weight(512, c, fan_in=c), b.const(np.zeros(512, np.float32))],
             {"transB": 1})
    bn = [b.const(v) for v in (np.ones(512, np.float32), np.zeros(512, np.float32),
                               np.zeros(512, np.float32), np.ones(512, np.float32))]
    x = b.op("BatchNormalization", [x, *bn], {"epsilon": 1e-5})
    return b.model([("input.1", [1, 3, 112, 112])], [x], "arcface_standin")


# -- SAM ViT encoder and mask decoder ------------------------------------------------

SAM_SIZE = 1024
SAM_DIM = 768
SAM_HEADS = 12


def sam_encoder_graph(seed: int = 4, size: int = SAM_SIZE) -> Model:
    """(1, 3, 1024, 1024) -> (1, 256, 64, 64): the 16/16 patch conv to 768,
    one pre-norm attention block (12 heads) and MLP, and the neck (1x1 and
    3x3 convolutions to 256). ``size`` scales the input side (tests)."""
    b = _Builder(seed)
    g = size // 16
    n = g * g
    x = b.conv("x", 3, SAM_DIM, k=16, s=16, bias=True)
    b.nodes[-1].attrs["pads"] = [0, 0, 0, 0]
    tokens = b.op("Transpose", [b.reshape(x, [1, SAM_DIM, n])], {"perm": [0, 2, 1]})
    h = b.layer_norm(tokens, SAM_DIM)
    d = SAM_DIM // SAM_HEADS

    def heads(t):
        return b.op("Transpose", [b.reshape(t, [1, n, SAM_HEADS, d])], {"perm": [0, 2, 1, 3]})

    q, k, v = (heads(b.linear(h, SAM_DIM, SAM_DIM)) for _ in range(3))
    kt = b.op("Transpose", [k], {"perm": [0, 1, 3, 2]})
    logits = b.op("Mul", [b.op("MatMul", [q, kt]), b.const(np.float32(d ** -0.5))])
    att = b.op("MatMul", [b.op("Softmax", [logits], {"axis": -1}), v])
    att = b.reshape(b.op("Transpose", [att], {"perm": [0, 2, 1, 3]}), [1, n, SAM_DIM])
    tokens = b.op("Add", [tokens, b.linear(att, SAM_DIM, SAM_DIM)])
    mlp = b.linear(b.silu(b.linear(b.layer_norm(tokens, SAM_DIM), SAM_DIM, 4 * SAM_DIM)),
                   4 * SAM_DIM, SAM_DIM)
    tokens = b.op("Add", [tokens, mlp])
    x = b.reshape(b.op("Transpose", [tokens], {"perm": [0, 2, 1]}), [1, SAM_DIM, g, g])
    x = b.conv(b.conv(x, SAM_DIM, 256, k=1), 256, 256, k=3)
    return b.model([("x", [1, 3, size, size])], [x], "sam_encoder_standin")


def sam_decoder_graph(seed: int = 5, radius: float = 100.0, size: int = SAM_SIZE) -> Model:
    """The segment-anything decoder's inputs (``image_embeddings`` (1, 256,
    64, 64), ``point_coords`` (1, 2, 2), ``point_labels`` (1, 2),
    ``mask_input`` (1, 1, 256, 256), ``has_mask_input`` (1,)) ->
    ``masks`` (1, 1, 256, 256) low-resolution logits, ``iou_predictions``
    (1, 1) and ``low_res_masks``, as an export without ``orig_im_size``
    gives them. The logits are a crisp disc of ``radius`` encoder pixels
    around the first point (50 per pixel inside its edge), plus the
    embedding projected, upsampled and scaled by about 1e-3, plus the
    mask input where ``has_mask_input``; the IoU prediction is 0.95 plus
    1e-3 of the embedding's mean. ``size`` scales the encoder side (tests)."""
    b = _Builder(seed)
    r = size // 4
    centres = (np.arange(r, dtype=np.float32) + 0.5) * (size / r)
    gx, gy = np.meshgrid(centres, centres)
    grid = b.const(np.stack([gx, gy], axis=-1)[None, None], "grid")  # (1, 1, r, r, 2)
    point = b.op("Gather", ["point_coords", b.const(np.asarray(0, np.int64))], {"axis": 1})
    point = b.reshape(point, [1, 1, 1, 1, 2])
    diff = b.op("Sub", [grid, point])
    dist = b.op("Sqrt", [b.op("ReduceSum", [b.op("Mul", [diff, diff]),
                                           b.const(np.asarray([-1], np.int64))],
                              {"keepdims": 0})])  # (1, 1, r, r)
    disc = b.op("Mul", [b.op("Sub", [b.const(np.float32(radius)), dist]),
                        b.const(np.float32(50.0))])
    emb = b.conv("image_embeddings", 256, 1, k=1, bias=True)
    emb = b.op("Resize", [emb, "", b.const(np.asarray([1, 1, 4, 4], np.float32))],
               {"mode": b"linear", "coordinate_transformation_mode": b"half_pixel"})
    emb = b.table(emb, np.zeros((1, 1, r, r), np.float32))
    gate = b.reshape("has_mask_input", [1, 1, 1, 1])
    masks = b.op("Add", [b.op("Add", [disc, emb]), b.op("Mul", ["mask_input", gate])])
    mean = b.op("ReduceMean", ["image_embeddings"], {"keepdims": 0})
    iou = b.reshape(b.table(mean, np.asarray(0.95, np.float32)), [1, 1])
    low = b.op("Identity", [masks])
    inputs = [("image_embeddings", [1, 256, size // 16, size // 16]), ("point_coords", [1, 2, 2]),
              ("point_labels", [1, 2]), ("mask_input", [1, 1, r, r]), ("has_mask_input", [1])]
    return b.model(inputs, [masks, iou, low], "sam_decoder_standin")


# -- a depth net (OnnxImageProcessor kind "depth") -----------------------------------


def depth_graph(seed: int = 6, size: int = 384) -> Model:
    """(1, 3, 384, 384) normalised image -> (1, 1, 384, 384) relative
    depth: three stride-2 stages (64, 128, 256), a linear x8 Resize back
    to the input and a 1x1 head (no table: the map is the net's)."""
    b = _Builder(seed)
    x, c = "image", 3
    for width in (64, 128, 256):
        x = b.conv_block(x, c, width)
        c = width
    x = b.op("Resize", [x, "", b.const(np.asarray([1, 1, 8, 8], np.float32))],
             {"mode": b"linear", "coordinate_transformation_mode": b"half_pixel"})
    return b.model([("image", [1, 3, size, size])], [b.conv(x, c, 1, k=1, bias=True)],
                   "depth_standin")


def write_standins(directory: str, frame_hw: Tuple[int, int] = (576, 576),
                   names: Optional[List[str]] = None) -> Dict[str, str]:
    """Write the stand-in graphs into ``directory``; returns {name: path}
    for ``yolox`` (one person), ``yolox_empty`` (no person), ``rtmpose``,
    ``scrfd``, ``arcface``, ``sam_encoder``, ``sam_decoder`` and
    ``depth`` (or the subset ``names``)."""
    makers = {
        "yolox": lambda: yolox_graph(frame_hw=frame_hw),
        "yolox_empty": lambda: yolox_graph(person=False, frame_hw=frame_hw),
        "rtmpose": rtmpose_graph,
        "scrfd": lambda: scrfd_graph(frame_hw=frame_hw),
        "arcface": arcface_graph,
        "sam_encoder": sam_encoder_graph,
        "sam_decoder": sam_decoder_graph,
        "depth": depth_graph,
    }
    paths = {}
    for name in names or makers:
        paths[name] = os.path.join(directory, f"{name}.onnx")
        save_model(makers[name](), paths[name])
    return paths
