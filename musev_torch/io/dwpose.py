"""DWPose stage: person detection + whole-body pose -> OpenPose-style maps
(counterpart of ``musev_tpu/io/dwpose.py``).

The reference's Pose2Video demo drives the pose ControlNet with dwpose maps
made from a source video by an onnxruntime pipeline (README.md:295-303,
403-406; controlnet_aux fork "dwpose": the yolox_l.onnx person detector and
the dw-ll_ucoco_384.onnx RTMPose whole-body model). Here both graphs run
through the port's executor (``musev_torch.onnx.runtime``, on the card
unless given another device) and every pre/post-processing step is
first-party numpy or torch on the host: letterbox, grid decode, NMS, SimCC
decode, affine crop and rendering.

The JAX package calls OpenCV for three steps; the port has one code path
without it, so its maps differ from the JAX package's at rounding and at
shape edges (the CPU tests state by how much):

* the letterbox resize is bilinear with half-pixel centres in float
  (``F.interpolate``), rounded to uint8, where ``cv2.resize`` works in
  fixed point;
* the affine crop solves the three-point transform and warps with
  ``face_emb.warp_affine``'s numpy bilinear (edge pixels clamp, the result
  truncates to uint8), where ``cv2.warpAffine`` quantises coordinates to
  1/32 px and blends the border with black;
* rendering reimplements OpenCV's rasterisers in integer arithmetic
  (``ellipse2Poly``, ``fillConvexPoly`` with its 8-connected outline and
  16.16 edge stepping, filled ``circle``, the thick ``line``, with
  OpenCV's line clipping), so a pose inside the frame renders the same
  pixels as OpenCV 5; a 2-px line that crosses the frame's edge may
  differ there by a few pixels.

Usage:
    det = OnnxModel.from_file("yolox_l.onnx")
    pose = OnnxModel.from_file("dw-ll_ucoco_384.onnx")
    processor = DWPoseProcessor(det, pose)
    maps = processor(frames)          # (T, H, W, 3) uint8 pose maps

``register_dwpose(det_path, pose_path)`` installs it into the controlnet
processor registry under the reference's names.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

# -- yolox person detection ---------------------------------------------------


def resize_bilinear(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """(H, W, C) uint8 -> (nh, nw, C) uint8, bilinear with half-pixel
    centres and no antialiasing (``cv2.INTER_LINEAR``'s sampling)."""
    import torch
    import torch.nn.functional as F

    t = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None].float()
    y = F.interpolate(t, size=(nh, nw), mode="bilinear", align_corners=False)
    return y[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()


def letterbox(img: np.ndarray, size: Tuple[int, int]) -> Tuple[np.ndarray, float]:
    """Resize keeping aspect, pad with 114 (yolox preprocessing contract)."""
    h, w = img.shape[:2]
    r = min(size[0] / h, size[1] / w)
    nh, nw = int(round(h * r)), int(round(w * r))
    resized = resize_bilinear(img, nh, nw)
    out = np.full((size[0], size[1], 3), 114, dtype=np.uint8)
    out[:nh, :nw] = resized
    return out, r


def yolox_grid_decode(raw: np.ndarray, img_size: Tuple[int, int]) -> np.ndarray:
    """(N_anchors, 5+C) raw head output -> decoded (cx, cy, w, h, obj, cls...).

    yolox exports without in-graph decode: offsets are relative to the
    stride-{8,16,32} grids.
    """
    grids = []
    strides = []
    for stride in (8, 16, 32):
        gh, gw = img_size[0] // stride, img_size[1] // stride
        ys, xs = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
        grids.append(np.stack([xs, ys], -1).reshape(-1, 2))
        strides.append(np.full((gh * gw, 1), stride))
    grid = np.concatenate(grids).astype(np.float32)
    stride = np.concatenate(strides).astype(np.float32)
    out = raw.copy()
    out[..., :2] = (raw[..., :2] + grid) * stride
    out[..., 2:4] = np.exp(raw[..., 2:4]) * stride
    return out


def nms(boxes: np.ndarray, scores: np.ndarray, iou_thr: float) -> List[int]:
    """Greedy IoU NMS over (N, 4) xyxy boxes."""
    order = scores.argsort()[::-1]
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    keep = []
    while order.size:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        rest = order[1:]
        xx1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(0, xx2 - xx1) * np.maximum(0, yy2 - yy1)
        iou = inter / (areas[i] + areas[rest] - inter + 1e-9)
        order = rest[iou <= iou_thr]
    return keep


def detect_persons(
    det_model,
    frame: np.ndarray,
    *,
    input_size: Tuple[int, int] = (640, 640),
    score_thr: float = 0.3,
    iou_thr: float = 0.45,
    class_index: int = 0,
) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> (N, 4) xyxy person boxes in frame coords.

    ``class_index`` selects the detector class column (0 = person for the
    yolox_l dwpose detector; face-detector checkpoints reuse this decode
    with their own class layout — see io/sam.py:FaceDetectorProcessor).
    """
    img, ratio = letterbox(frame[..., ::-1], input_size)  # yolox eats BGR
    inp = img.astype(np.float32).transpose(2, 0, 1)[None]
    (raw,) = det_model.run({det_model.input_names[0]: inp})
    raw = np.asarray(raw)
    if raw.ndim == 3:
        raw = raw[0]
    dec = yolox_grid_decode(raw, input_size)
    boxes_xywh = dec[:, :4]
    obj = dec[:, 4:5]
    cls = dec[:, 5:]
    scores = (obj * cls)[:, class_index]
    mask = scores > score_thr
    if not mask.any():
        return np.zeros((0, 4), np.float32)
    b = boxes_xywh[mask]
    s = scores[mask]
    xyxy = np.stack(
        [b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2,
         b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2], axis=1
    )
    keep = nms(xyxy, s, iou_thr)
    return xyxy[keep] / ratio


# -- rtmpose (SimCC) whole-body estimation -------------------------------------


def _bbox_center_scale(
    bbox: np.ndarray, aspect: float, padding: float = 1.25
) -> Tuple[np.ndarray, np.ndarray]:
    x1, y1, x2, y2 = bbox[:4]
    center = np.array([(x1 + x2) / 2, (y1 + y2) / 2], np.float32)
    w, h = x2 - x1, y2 - y1
    if w > aspect * h:
        h = w / aspect
    else:
        w = h * aspect
    return center, np.array([w * padding, h * padding], np.float32)


def affine_from_points(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The 2x3 affine mapping three ``src`` points onto three ``dst``
    points (what ``cv2.getAffineTransform`` returns), solved in float64."""
    a = np.concatenate([np.asarray(src, np.float64), np.ones((3, 1))], axis=1)
    return np.linalg.solve(a, np.asarray(dst, np.float64)).T


def _crop_affine(
    img: np.ndarray, center: np.ndarray, scale: np.ndarray,
    out_wh: Tuple[int, int],
) -> np.ndarray:
    from .face_emb import warp_affine

    ow, oh = out_wh
    src = np.float32([
        center,
        center + [0, -scale[1] / 2],
        center + [scale[0] / 2, 0],
    ])
    dst = np.float32([[ow / 2, oh / 2], [ow / 2, 0], [ow, oh / 2]])
    return warp_affine(img, affine_from_points(src, dst), (ow, oh))


def simcc_decode(
    simcc_x: np.ndarray, simcc_y: np.ndarray, split_ratio: float = 2.0
) -> Tuple[np.ndarray, np.ndarray]:
    """(N, K, Wx), (N, K, Wy) -> keypoints (N, K, 2) + scores (N, K)."""
    x_loc = simcc_x.argmax(axis=-1)
    y_loc = simcc_y.argmax(axis=-1)
    x_val = np.take_along_axis(simcc_x, x_loc[..., None], -1)[..., 0]
    y_val = np.take_along_axis(simcc_y, y_loc[..., None], -1)[..., 0]
    scores = np.minimum(x_val, y_val)
    kpts = np.stack([x_loc, y_loc], axis=-1).astype(np.float32) / split_ratio
    kpts[scores <= 0] = -1
    return kpts, scores


def estimate_pose(
    pose_model,
    frame: np.ndarray,
    boxes: np.ndarray,
    *,
    input_wh: Tuple[int, int] = (288, 384),
    split_ratio: float = 2.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """RTMPose top-down: (H,W,3) + (N,4) boxes -> (N, 133, 2) kpts + scores.

    Model input is normalized with the mmpose ImageNet constants.
    """
    if len(boxes) == 0:
        boxes = np.array([[0, 0, frame.shape[1], frame.shape[0]]], np.float32)
    mean = np.array([123.675, 116.28, 103.53], np.float32)
    std = np.array([58.395, 57.12, 57.375], np.float32)
    aspect = input_wh[0] / input_wh[1]
    all_k, all_s = [], []
    for bbox in boxes:
        center, scale = _bbox_center_scale(np.asarray(bbox, np.float32), aspect)
        crop = _crop_affine(frame, center, scale, input_wh)
        inp = ((crop.astype(np.float32) - mean) / std).transpose(2, 0, 1)[None]
        sx, sy = pose_model.run({pose_model.input_names[0]: inp})
        k, s = simcc_decode(np.asarray(sx), np.asarray(sy), split_ratio)
        k = k[0] / np.array([input_wh[0], input_wh[1]]) * scale + center - scale / 2
        all_k.append(k)
        all_s.append(s[0])
    return np.stack(all_k), np.stack(all_s)


# -- COCO-wholebody -> OpenPose layout ------------------------------------------

# openpose body-18 index -> coco-17 index (neck handled separately)
_OP_FROM_COCO = [0, -1, 6, 8, 10, 5, 7, 9, 12, 14, 16, 11, 13, 15, 2, 1, 4, 3]


@dataclasses.dataclass
class PoseResult:
    """Keypoints normalized to [0,1] x [0,1]; score<=0 marks invisible."""

    bodies: np.ndarray  # (N, 18, 2)
    body_scores: np.ndarray  # (N, 18)
    hands: np.ndarray  # (2N, 21, 2)  [left; right] per person
    hand_scores: np.ndarray  # (2N, 21)
    faces: np.ndarray  # (N, 68, 2)
    face_scores: np.ndarray  # (N, 68)


def wholebody_to_openpose(
    kpts: np.ndarray, scores: np.ndarray, width: int, height: int,
    thr: float = 0.3,
) -> PoseResult:
    """(N,133,2) coco-wholebody -> OpenPose-format groups, normalized."""
    n = kpts.shape[0]
    norm = np.array([width, height], np.float32)
    body = np.zeros((n, 18, 2), np.float32)
    body_s = np.zeros((n, 18), np.float32)
    for op_i, coco_i in enumerate(_OP_FROM_COCO):
        if coco_i >= 0:
            body[:, op_i] = kpts[:, coco_i]
            body_s[:, op_i] = scores[:, coco_i]
    # neck = midpoint of shoulders, visible when both are
    body[:, 1] = (kpts[:, 5] + kpts[:, 6]) / 2
    body_s[:, 1] = np.minimum(scores[:, 5], scores[:, 6])
    body /= norm
    body_s = np.where(body_s > thr, body_s, 0.0)
    # wholebody layout: 0-16 body, 17-22 feet, 23-90 face, 91-111 left hand,
    # 112-132 right hand
    faces = kpts[:, 23:91] / norm
    face_s = np.where(scores[:, 23:91] > thr, scores[:, 23:91], 0.0)
    lh = kpts[:, 91:112] / norm
    rh = kpts[:, 112:133] / norm
    hands = np.concatenate([lh, rh], axis=0)
    hand_s = np.concatenate([scores[:, 91:112], scores[:, 112:133]], axis=0)
    hand_s = np.where(hand_s > thr, hand_s, 0.0)
    return PoseResult(body, body_s, hands, hand_s, faces, face_s)


# -- first-party rasteriser -------------------------------------------------------


def _paint(canvas: np.ndarray, x0, y0, x1, y1, inside, color) -> None:
    """Set ``color`` where ``inside(xs, ys)`` holds over the pixel box
    [x0, x1] x [y0, y1], clipped to the canvas."""
    h, w = canvas.shape[:2]
    x0, y0 = max(int(math.floor(x0)), 0), max(int(math.floor(y0)), 0)
    x1, y1 = min(int(math.ceil(x1)), w - 1), min(int(math.ceil(y1)), h - 1)
    if x0 > x1 or y0 > y1:
        return
    ys, xs = np.mgrid[y0:y1 + 1, x0:x1 + 1]
    canvas[y0:y1 + 1, x0:x1 + 1][inside(xs, ys)] = color


def fill_disc(canvas: np.ndarray, cx: int, cy: int, r: int, color) -> None:
    """A filled circle: the pixels with dx² + dy² <= r² (``cv2.circle``
    with ``thickness=-1``)."""
    _paint(canvas, cx - r, cy - r, cx + r, cy + r,
           lambda xs, ys: (xs - cx) ** 2 + (ys - cy) ** 2 <= r * r, color)


def ellipse_poly(center: Tuple[int, int], axes: Tuple[int, int], angle: int,
                 delta: int = 1) -> np.ndarray:
    """The integer polygon of a full ellipse at whole-degree steps of
    ``delta``, consecutive duplicates dropped (``cv2.ellipse2Poly`` over
    0-360 degrees)."""
    angle %= 360
    rad = np.deg2rad
    alpha, beta = np.float32(np.cos(rad(angle))), np.float32(np.sin(rad(angle)))
    steps = np.minimum(np.arange(0, 360 + delta, delta), 360)
    x = axes[0] * np.cos(rad(steps)).astype(np.float32).astype(np.float64)
    y = axes[1] * np.sin(rad(steps)).astype(np.float32).astype(np.float64)
    px = np.rint(center[0] + x * alpha - y * beta).astype(np.int64)
    py = np.rint(center[1] + x * beta + y * alpha).astype(np.int64)
    pts = np.stack([px, py], axis=1)
    keep = np.ones(len(pts), bool)
    keep[1:] = np.any(pts[1:] != pts[:-1], axis=1)
    pts = pts[keep]
    return np.stack([center, center]) if len(pts) == 1 else pts


_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _put(canvas: np.ndarray, x: int, y: int, color) -> None:
    if 0 <= x < canvas.shape[1] and 0 <= y < canvas.shape[0]:
        canvas[y, x] = color


def _clip_line(w: int, h: int, p1, p2):
    """The segment clipped to [0, w-1] x [0, h-1] as OpenCV's ``clipLine``
    does (truncating each moved end toward zero), or None outside."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return None if (c1 | c2) else ((x1, y1), (x2, y2))


def _line_fixed(canvas: np.ndarray, p1, p2, color) -> None:
    """An 8-connected line between points in 16.16 fixed point, clipped to
    the canvas, stepping one pixel along the major axis from the rounded
    start (OpenCV's ``Line2``)."""
    clipped = _clip_line(canvas.shape[1] << _XY_SHIFT, canvas.shape[0] << _XY_SHIFT, p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    _put(canvas, (x2 + (_XY_ONE >> 1)) >> _XY_SHIFT, (y2 + (_XY_ONE >> 1)) >> _XY_SHIFT, color)
    if ax > ay:
        if dx < 0:
            (x1, y1), (x2, y2), dy = (x2, y2), (x1, y1), -dy
        y_step = _cdiv(dy << _XY_SHIFT, ax | 1)
        count = (x2 - x1) >> _XY_SHIFT
        x, y = (x1 + (_XY_ONE >> 1)) >> _XY_SHIFT, y1 + (_XY_ONE >> 1)
        for _ in range(count + 1):
            _put(canvas, x, y >> _XY_SHIFT, color)
            x, y = x + 1, y + y_step
    else:
        if dy < 0:
            (x1, y1), (x2, y2), dx = (x2, y2), (x1, y1), -dx
        x_step = _cdiv(dx << _XY_SHIFT, ay | 1)
        count = (y2 - y1) >> _XY_SHIFT
        x, y = x1 + (_XY_ONE >> 1), (y1 + (_XY_ONE >> 1)) >> _XY_SHIFT
        for _ in range(count + 1):
            _put(canvas, x >> _XY_SHIFT, y, color)
            x, y = x + x_step, y + 1


def _line_int(canvas: np.ndarray, x1: int, y1: int, x2: int, y2: int, color) -> None:
    """An 8-connected Bresenham line between integer points, clipped to the
    canvas and walked from the left end (OpenCV's ``LineIterator``)."""
    clipped = _clip_line(canvas.shape[1], canvas.shape[0], (x1, y1), (x2, y2))
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    if x2 < x1:
        (x1, y1), (x2, y2) = (x2, y2), (x1, y1)
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    major, minor = ((1, 0), (0, sy)) if dx >= dy else ((0, sy), (1, 0))
    if dy > dx:
        dx, dy = dy, dx
    err, plus, minus = dx - 2 * dy, 2 * dx, -2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        _put(canvas, x, y, color)
        step = err < 0
        err += minus + (plus if step else 0)
        x += major[0] + (minor[0] if step else 0)
        y += major[1] + (minor[1] if step else 0)


def fill_convex_poly(canvas: np.ndarray, v, color, shift: int = 0) -> None:
    """A convex polygon of integer vertices with ``shift`` fractional bits:
    its outline as 8-connected lines between the rounded vertices, then
    each row filled between two edges stepped by their 16.16 slopes
    (OpenCV's ``FillConvexPoly``)."""
    h, w = canvas.shape[:2]
    v = [(int(x), int(y)) for x, y in v]
    npts, half, up = len(v), (1 << shift) >> 1, _XY_SHIFT - shift
    imin = 0
    p0 = v[-1]
    for i, p in enumerate(v):
        if p[1] < v[imin][1]:
            imin = i
        if shift == 0:
            _line_int(canvas, p0[0], p0[1], p[0], p[1], color)
        else:
            _line_fixed(canvas, (p0[0] << up, p0[1] << up), (p[0] << up, p[1] << up), color)
        p0 = p
    xs_all, ys_all = [p[0] for p in v], [p[1] for p in v]
    xmin, xmax = (min(xs_all) + half) >> shift, (max(xs_all) + half) >> shift
    ymin, ymax = (min(ys_all) + half) >> shift, (max(ys_all) + half) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = npts
    edge = [dict(idx=imin, di=1, x=-_XY_ONE, dx=0, ye=ymin),
            dict(idx=imin, di=npts - 1, x=-_XY_ONE, dx=0, ye=ymin)]
    y = ymin
    while True:
        for e in edge:
            if y < e["ye"]:
                continue
            idx0, di = e["idx"], e["di"]
            idx = (idx0 + di) % npts
            while True:
                more, edges = edges > 0, edges - 1
                if not more:
                    break
                ty = (v[idx][1] + half) >> shift
                if ty > y:
                    xs, xe = v[idx0][0] << up, v[idx][0] << up
                    e.update(ye=ty, dx=_cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y)), x=xs,
                             idx=idx)
                    break
                idx0, idx = idx, (idx + di) % npts
        if edges < 0:
            break
        if y >= 0:
            left, right = sorted(edge, key=lambda e: e["x"])
            x1 = (left["x"] + (_XY_ONE >> 1)) >> _XY_SHIFT
            x2 = (right["x"] + (_XY_ONE >> 1)) >> _XY_SHIFT
            if x2 >= 0 and x1 < w:
                canvas[y, max(x1, 0):min(x2, w - 1) + 1] = color
        for e in edge:
            e["x"] += e["dx"]
        y += 1
        if y > ymax:
            break


def draw_line(canvas: np.ndarray, pa, pb, color, thickness: int = 2) -> None:
    """A line ``thickness`` (> 1) pixels wide between integer points: the
    rectangle offset by half the thickness along the normal, in 16.16
    fixed point, filled as a convex polygon, and filled discs of radius
    (thickness + 1) // 2 at both ends (OpenCV's ``ThickLine``)."""
    p0 = (int(pa[0]) << _XY_SHIFT, int(pa[1]) << _XY_SHIFT)
    p1 = (int(pb[0]) << _XY_SHIFT, int(pb[1]) << _XY_SHIFT)
    dx, dy = (p0[0] - p1[0]) / _XY_ONE, (p1[1] - p0[1]) / _XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    half_w = thickness << (_XY_SHIFT - 1)
    if r > np.finfo(np.float64).eps:
        r = (half_w + odd * _XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = int(np.rint(dy * r)), int(np.rint(dx * r))
        fill_convex_poly(canvas, [(p0[0] + dpx, p0[1] + dpy), (p0[0] - dpx, p0[1] - dpy),
                                  (p1[0] - dpx, p1[1] - dpy), (p1[0] + dpx, p1[1] + dpy)],
                         color, shift=_XY_SHIFT)
    radius = (half_w + (_XY_ONE >> 1)) >> _XY_SHIFT
    for p in (p0, p1):
        fill_disc(canvas, (p[0] + (_XY_ONE >> 1)) >> _XY_SHIFT,
                  (p[1] + (_XY_ONE >> 1)) >> _XY_SHIFT, radius, color)


# -- OpenPose-style rendering ---------------------------------------------------

_LIMBS = [
    (1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (1, 8), (8, 9),
    (9, 10), (1, 11), (11, 12), (12, 13), (1, 0), (0, 14), (14, 16),
    (0, 15), (15, 17),
]

_COLORS = [
    (255, 0, 0), (255, 85, 0), (255, 170, 0), (255, 255, 0), (170, 255, 0),
    (85, 255, 0), (0, 255, 0), (0, 255, 85), (0, 255, 170), (0, 255, 255),
    (0, 170, 255), (0, 85, 255), (0, 0, 255), (85, 0, 255), (170, 0, 255),
    (255, 0, 255), (255, 0, 170), (255, 0, 85),
]

_HAND_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 4), (0, 5), (5, 6), (6, 7), (7, 8),
    (0, 9), (9, 10), (10, 11), (11, 12), (0, 13), (13, 14), (14, 15),
    (15, 16), (0, 17), (17, 18), (18, 19), (19, 20),
]


def _hsv_color(frac: float) -> Tuple[int, int, int]:
    h = (frac % 1.0) * 6.0
    i = int(h)
    f = h - i
    p, q, t = 0.0, 1.0 - f, f
    rgb = [(1, t, p), (q, 1, p), (p, 1, t), (p, q, 1), (t, p, 1), (1, p, q)][i % 6]
    return tuple(int(255 * c) for c in rgb)


def draw_bodypose(
    canvas: np.ndarray, bodies: np.ndarray, scores: np.ndarray
) -> np.ndarray:
    h, w = canvas.shape[:2]
    stickwidth = 4
    for limb_i, (a, b) in enumerate(_LIMBS):
        color = _COLORS[limb_i % len(_COLORS)]
        for person, s in zip(bodies, scores):
            if s[a] <= 0 or s[b] <= 0:
                continue
            pa = person[a] * [w, h]
            pb = person[b] * [w, h]
            mid = (pa + pb) / 2
            length = float(np.hypot(*(pa - pb)))
            angle = math.degrees(math.atan2(pa[1] - pb[1], pa[0] - pb[0]))
            poly = ellipse_poly(
                (int(mid[0]), int(mid[1])),
                (max(int(length / 2), 1), stickwidth), int(angle),
            )
            fill_convex_poly(canvas, poly, [int(0.6 * c) for c in color])
    for person, s in zip(bodies, scores):
        for j in range(18):
            if s[j] <= 0:
                continue
            x, y = (person[j] * [w, h]).astype(int)
            fill_disc(canvas, int(x), int(y), 4, _COLORS[j])
    return canvas


def draw_handpose(
    canvas: np.ndarray, hands: np.ndarray, scores: np.ndarray
) -> np.ndarray:
    h, w = canvas.shape[:2]
    for hand, s in zip(hands, scores):
        for ei, (a, b) in enumerate(_HAND_EDGES):
            if s[a] <= 0 or s[b] <= 0:
                continue
            pa = (hand[a] * [w, h]).astype(int)
            pb = (hand[b] * [w, h]).astype(int)
            draw_line(canvas, pa, pb, _hsv_color(ei / len(_HAND_EDGES)), thickness=2)
        for j in range(hand.shape[0]):
            if s[j] <= 0:
                continue
            x, y = (hand[j] * [w, h]).astype(int)
            fill_disc(canvas, int(x), int(y), 4, (0, 0, 255))
    return canvas


def draw_facepose(
    canvas: np.ndarray, faces: np.ndarray, scores: np.ndarray
) -> np.ndarray:
    h, w = canvas.shape[:2]
    for face, s in zip(faces, scores):
        for j in range(face.shape[0]):
            if s[j] <= 0:
                continue
            x, y = (face[j] * [w, h]).astype(int)
            fill_disc(canvas, int(x), int(y), 3, (255, 255, 255))
    return canvas


def render_pose(
    pose: PoseResult, height: int, width: int,
    include_body: bool = True, include_hand: bool = True,
    include_face: bool = True,
) -> np.ndarray:
    canvas = np.zeros((height, width, 3), np.uint8)
    if include_body:
        canvas = draw_bodypose(canvas, pose.bodies, pose.body_scores)
    if include_hand:
        canvas = draw_handpose(canvas, pose.hands, pose.hand_scores)
    if include_face:
        canvas = draw_facepose(canvas, pose.faces, pose.face_scores)
    return canvas


# -- pipeline stage --------------------------------------------------------------


class DWPoseProcessor:
    """frames (T, H, W, 3) uint8 -> pose maps (T, H, W, 3) uint8.

    ``include_*`` flags mirror the reference's dwpose processor variants
    (dwpose / dwpose_body_hand / dwpose_face etc., README.md:403-406).
    """

    def __init__(
        self,
        det_model,
        pose_model,
        *,
        include_body: bool = True,
        include_hand: bool = True,
        include_face: bool = True,
        detect_resolution: Optional[int] = None,
        score_thr: float = 0.3,
    ):
        self.det = det_model
        self.pose = pose_model
        self.include_body = include_body
        self.include_hand = include_hand
        self.include_face = include_face
        self.detect_resolution = detect_resolution
        self.score_thr = score_thr

    def detect_frame(self, frame: np.ndarray) -> PoseResult:
        if self.detect_resolution:
            # run detection+pose on a long-side-capped copy (reference
            # controlnet_aux detect_resolution contract); keypoints are
            # normalized by the frame they were estimated on, so the
            # full-resolution render is unaffected
            h, w = frame.shape[:2]
            long_side = max(h, w)
            if long_side > self.detect_resolution:
                s = self.detect_resolution / long_side
                nh, nw = max(1, round(h * s)), max(1, round(w * s))
                from PIL import Image

                frame = np.asarray(
                    Image.fromarray(frame.astype(np.uint8)).resize((nw, nh))
                )
        h, w = frame.shape[:2]
        boxes = detect_persons(self.det, frame)
        kpts, scores = estimate_pose(self.pose, frame, boxes)
        return wholebody_to_openpose(kpts, scores, w, h, thr=self.score_thr)

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        frames = np.asarray(frames)
        out = []
        for frame in frames:
            pose = self.detect_frame(frame)
            out.append(
                render_pose(
                    pose, frame.shape[0], frame.shape[1],
                    self.include_body, self.include_hand, self.include_face,
                )
            )
        return np.stack(out)


_DWPOSE_VARIANTS = {
    "dwpose": dict(include_body=True, include_hand=True, include_face=True),
    "dwpose_body_hand": dict(include_body=True, include_hand=True, include_face=False),
    "dwpose_body": dict(include_body=True, include_hand=False, include_face=False),
    "dwpose_face": dict(include_body=False, include_hand=False, include_face=True),
    "dwpose_hand": dict(include_body=False, include_hand=True, include_face=False),
    "dwpose_body_face": dict(include_body=True, include_hand=False, include_face=True),
    # the reference's openpose family ('pose*', mmcm controlnet.py:513 /
    # README.md:403-406) renders the same OpenPose-style skeleton from the
    # same keypoint sets; here they are render-subset variants of the dwpose
    # keypoints
    "pose": dict(include_body=True, include_hand=False, include_face=False),
    "pose_body": dict(include_body=True, include_hand=False, include_face=False),
    "pose_hand": dict(include_body=False, include_hand=True, include_face=False),
    "pose_face": dict(include_body=False, include_hand=False, include_face=True),
    "pose_hand_body": dict(include_body=True, include_hand=True, include_face=False),
    "pose_hand_face": dict(include_body=False, include_hand=True, include_face=True),
}


def register_dwpose(
    det_path: str, pose_path: str, names: Optional[Sequence[str]] = None, device=None,
) -> None:
    """Load the two onnx models (on ``device``: CUDA unless given) and
    register every dwpose variant."""
    from ..onnx.runtime import OnnxModel
    from .processors import register_processor

    det = OnnxModel.from_file(det_path, device=device)
    pose = OnnxModel.from_file(pose_path, device=device)
    for name in names or _DWPOSE_VARIANTS:
        register_processor(
            name, DWPoseProcessor(det, pose, **_DWPOSE_VARIANTS[name])
        )
