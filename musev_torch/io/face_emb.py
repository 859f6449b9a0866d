"""InsightFace-style face-embedding extraction (counterpart of ``musev_tpu/io/face_emb.py``).

Reference surface: mmcm ``insight_face_extractor.{InsightFaceExtractor,
InsightFaceExtractorNormEmb}``, built by the reference's text2video script
and handed to the predictor to turn a face image into the ``(B, 512)``
``face_emb`` the IPAdapterFaceID branch consumes
(``MusevPipeline.text2video(face_emb=...)``). The reference delegates to
the insightface package's onnxruntime binaries; here the same contract
runs on the port's ONNX executor (``musev_torch.onnx``, on the card unless
given another device):

  * SCRFD face detection (per-stride score/bbox/5-landmark distance heads,
    the standard insightface ``det_10g``/``buffalo`` family layout),
  * Umeyama similarity alignment to the canonical 112x112 arcface
    5-point template,
  * an arcface-style recognition net producing the identity embedding,
    optionally L2-normalized (the ``NormEmb`` variant).

Everything host-side is numpy. ``warp_affine`` is the JAX module's
pure-numpy branch alone: the port does not call OpenCV.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .dwpose import nms

# canonical arcface 112x112 destination landmarks (insightface
# face_align.arcface_dst; fixed public constants of the alignment spec)
ARCFACE_DST = np.array(
    [
        [38.2946, 51.6963],
        [73.5318, 51.5014],
        [56.0252, 71.7366],
        [41.5493, 92.3655],
        [70.7299, 92.2041],
    ],
    dtype=np.float32,
)


def umeyama_similarity(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares similarity transform (rotation+uniform scale+shift)
    mapping ``src`` (N, 2) onto ``dst`` (N, 2); returns a 2x3 matrix.

    Umeyama (1991) closed form — the estimator insightface's
    ``estimate_norm`` uses (via skimage SimilarityTransform)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    n, d = src.shape
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / n
    u, s, vt = np.linalg.svd(cov)
    sign = np.ones(d)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        sign[-1] = -1
    rot = u @ np.diag(sign) @ vt
    var_s = (sc ** 2).sum() / n
    scale = (s * sign).sum() / var_s if var_s > 0 else 1.0
    t = mu_d - scale * rot @ mu_s
    m = np.zeros((2, 3), np.float64)
    m[:, :2] = scale * rot
    m[:, 2] = t
    return m.astype(np.float32)


def warp_affine(
    img: np.ndarray, mat: np.ndarray, out_wh: Tuple[int, int]
) -> np.ndarray:
    """Bilinear inverse-map affine warp, (H, W, C) uint8 -> (oh, ow, C).

    Edge neighbours clamp, pixels whose 2x2 footprint lies wholly outside
    the image are 0, and the result truncates to the input dtype (the JAX
    module's pure-numpy branch; its cv2 path is not ported)."""
    ow, oh = out_wh
    full = np.vstack([mat, [0.0, 0.0, 1.0]]).astype(np.float64)
    inv = np.linalg.inv(full)[:2]
    ys, xs = np.mgrid[0:oh, 0:ow]
    coords = np.stack([xs, ys, np.ones_like(xs)], axis=-1).reshape(-1, 3)
    src = coords @ inv.T  # (N, 2) x,y in source
    sx, sy = src[:, 0], src[:, 1]
    h, w = img.shape[:2]
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx, fy = sx - x0, sy - y0
    valid = (x0 >= -1) & (x0 <= w - 1) & (y0 >= -1) & (y0 <= h - 1)
    x0c, y0c = np.clip(x0, 0, w - 1), np.clip(y0, 0, h - 1)
    x1c, y1c = np.clip(x0 + 1, 0, w - 1), np.clip(y0 + 1, 0, h - 1)
    im = img.astype(np.float32)
    p00, p01 = im[y0c, x0c], im[y0c, x1c]
    p10, p11 = im[y1c, x0c], im[y1c, x1c]
    fx = fx[:, None]
    fy = fy[:, None]
    out = (
        p00 * (1 - fx) * (1 - fy)
        + p01 * fx * (1 - fy)
        + p10 * (1 - fx) * fy
        + p11 * fx * fy
    )
    out = np.where(valid[:, None], out, 0.0)
    return out.reshape(oh, ow, -1).astype(img.dtype)


def norm_crop(
    img: np.ndarray, kps: np.ndarray, size: int = 112
) -> np.ndarray:
    """Align a face to the arcface template: (H, W, 3) + 5 landmarks ->
    (size, size, 3). ``size`` scales the 112-based template."""
    dst = ARCFACE_DST * (size / 112.0)
    mat = umeyama_similarity(np.asarray(kps, np.float32), dst)
    return warp_affine(img, mat, (size, size))


# -- SCRFD detector decode ------------------------------------------------------

_SCRFD_STRIDES = (8, 16, 32)
_SCRFD_NUM_ANCHORS = 2


def _anchor_centers(h: int, w: int, stride: int) -> np.ndarray:
    ys, xs = np.mgrid[0:h, 0:w]
    c = np.stack([xs, ys], axis=-1).astype(np.float32) * stride
    c = np.repeat(c.reshape(-1, 2), _SCRFD_NUM_ANCHORS, axis=0)
    return c


def scrfd_decode(
    outputs: Sequence[np.ndarray],
    input_size: Tuple[int, int],
    score_thr: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode SCRFD head outputs -> (boxes xyxy, scores, kps (N, 5, 2)).

    ``outputs`` are the net's 9 tensors in insightface order: scores per
    stride (M_i, 1), bbox distances (M_i, 4), landmark distances (M_i, 10)
    for strides 8/16/32 with 2 anchors per cell; distances are in stride
    units (insightface scrfd.py forward: ``bbox_preds * stride``)."""
    iw, ih = input_size
    n = len(_SCRFD_STRIDES)
    boxes_all: List[np.ndarray] = []
    scores_all: List[np.ndarray] = []
    kps_all: List[np.ndarray] = []
    for i, stride in enumerate(_SCRFD_STRIDES):
        scores = np.asarray(outputs[i]).reshape(-1)
        bbox = np.asarray(outputs[i + n]).reshape(-1, 4) * stride
        kps = np.asarray(outputs[i + 2 * n]).reshape(-1, 5, 2) * stride
        gh, gw = ih // stride, iw // stride
        centers = _anchor_centers(gh, gw, stride)
        m = min(len(scores), len(centers))
        scores, bbox, kps, centers = (
            scores[:m], bbox[:m], kps[:m], centers[:m],
        )
        keep = scores >= score_thr
        if not keep.any():
            continue
        c = centers[keep]
        b = bbox[keep]
        boxes_all.append(
            np.stack(
                [c[:, 0] - b[:, 0], c[:, 1] - b[:, 1],
                 c[:, 0] + b[:, 2], c[:, 1] + b[:, 3]], axis=1
            )
        )
        kps_all.append(c[:, None, :] + kps[keep])
        scores_all.append(scores[keep])
    if not boxes_all:
        z = np.zeros
        return z((0, 4), np.float32), z((0,), np.float32), z((0, 5, 2), np.float32)
    return (
        np.concatenate(boxes_all).astype(np.float32),
        np.concatenate(scores_all).astype(np.float32),
        np.concatenate(kps_all).astype(np.float32),
    )


def detect_faces(
    det_model,
    frame: np.ndarray,
    *,
    input_size: Tuple[int, int] = (640, 640),
    score_thr: float = 0.5,
    iou_thr: float = 0.4,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(H, W, 3) uint8 RGB -> NMS'd (boxes xyxy, scores, kps) in frame
    coordinates. Aspect-preserving resize into the detector canvas;
    input normalization (x - 127.5) / 128 matches insightface SCRFD."""
    h, w = frame.shape[:2]
    iw, ih = input_size
    ratio = min(iw / w, ih / h)
    nw, nh = int(round(w * ratio)), int(round(h * ratio))
    # bilinear resize into the canvas (insightface uses cv2.resize bilinear;
    # nearest-neighbor shifts detection scores / landmark positions):
    # warp_affine with a pure scale matrix is a bilinear resize
    scale_mat = np.array([[ratio, 0.0, 0.0], [0.0, ratio, 0.0]], np.float32)
    resized = warp_affine(frame, scale_mat, (nw, nh))
    canvas = np.zeros((ih, iw, 3), np.float32)
    canvas[:nh, :nw] = resized.astype(np.float32)
    inp = ((canvas - 127.5) / 128.0).transpose(2, 0, 1)[None]
    outs = det_model.run({det_model.input_names[0]: inp.astype(np.float32)})
    boxes, scores, kps = scrfd_decode(outs, input_size, score_thr)
    if len(boxes) == 0:
        return boxes, scores, kps
    keep = nms(boxes, scores, iou_thr)
    return boxes[keep] / ratio, scores[keep], kps[keep] / ratio


class FaceEmbExtractor:
    """images (B, H, W, 3) uint8 RGB -> identity embeddings (B, D).

    Mirrors mmcm ``InsightFaceExtractor`` (``norm=True`` =
    ``InsightFaceExtractorNormEmb``): detect faces, keep the largest,
    align to the arcface template, embed with the recognition net
    ((x - 127.5) / 127.5 input, insightface ArcFaceONNX contract).
    Images with no detected face fall back to a centered square resize of
    the whole frame (logged), so conditioning never silently drops."""

    def __init__(
        self,
        det_model,
        rec_model,
        *,
        norm: bool = False,
        det_input_size: Tuple[int, int] = (640, 640),
        det_score_thr: float = 0.5,
        rec_size: int = 112,
    ):
        self.det = det_model
        self.rec = rec_model
        self.norm = norm
        self.det_input_size = det_input_size
        self.det_score_thr = det_score_thr
        self.rec_size = rec_size

    def _align(self, img: np.ndarray) -> np.ndarray:
        boxes, scores, kps = detect_faces(
            self.det, img, input_size=self.det_input_size,
            score_thr=self.det_score_thr,
        )
        if len(boxes) == 0:
            import logging

            logging.getLogger(__name__).warning(
                "no face detected; embedding the centered full frame"
            )
            h, w = img.shape[:2]
            s = min(h, w)
            y0, x0 = (h - s) // 2, (w - s) // 2
            crop = img[y0:y0 + s, x0:x0 + s]
            idx = (np.arange(self.rec_size) * s // self.rec_size).clip(0, s - 1)
            return crop[idx][:, idx]
        areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        best = int(np.argmax(areas))
        return norm_crop(img, kps[best], self.rec_size)

    def embed_aligned(self, face: np.ndarray) -> np.ndarray:
        inp = (face.astype(np.float32) - 127.5) / 127.5
        inp = inp.transpose(2, 0, 1)[None]
        (emb,) = self.rec.run({self.rec.input_names[0]: inp})
        emb = np.asarray(emb, np.float32).reshape(-1)
        if self.norm:
            emb = emb / max(float(np.linalg.norm(emb)), 1e-12)
        return emb

    def __call__(self, images: np.ndarray) -> np.ndarray:
        images = np.asarray(images)
        if images.ndim == 3:
            images = images[None]
        return np.stack([self.embed_aligned(self._align(im)) for im in images])


def build_face_emb_extractor(
    det_path: str, rec_path: str, *, norm: bool = False, device=None, **kwargs
) -> FaceEmbExtractor:
    """Load the detector/recognition .onnx pair (external artifacts, as in
    the reference) on ``device`` (CUDA unless given) and return the
    extractor."""
    from ..onnx.runtime import OnnxModel

    det = OnnxModel.from_file(det_path, device=device)
    rec = OnnxModel.from_file(rec_path, device=device)
    return FaceEmbExtractor(det, rec, norm=norm, **kwargs)
