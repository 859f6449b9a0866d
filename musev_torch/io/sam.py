"""SAM automatic-mask segmentation + face-detector condition stages
(counterpart of ``musev_tpu/io/sam.py``).

The last names of the reference's controlnet processor zoo (README.md
:403-406, mmcm controlnet.py:513): ``sam`` / ``mobile_sam``
(Segment-Anything automatic mask generation rendered as a random-colour
segmentation map) and ``face_detector`` (detector boxes rendered as a
condition map). Both run their networks through the port's ONNX executor
(``musev_torch.onnx.runtime``, on the card unless given another device),
with all pre/post-processing (grid prompting, stability scoring, NMS,
rendering) first-party numpy, as in ``io/dwpose.py``.

Model contracts:
  * SAM encoder: (1, 3, S, S) float32, ImageNet-normalized, bottom-right
    zero-padded after a long-side resize to S (1024 for ViT-H / MobileSAM)
    -> image embedding (1, 256, S/16, S/16).
  * SAM decoder (the official segment-anything ONNX export): feeds
    image_embeddings / point_coords / point_labels / mask_input /
    has_mask_input / orig_im_size, returns (masks, iou_predictions, ...).
    Inputs are matched by name so trimmed exports also work.
  * face detector: yolox-format raw head (grid decode + NMS shared with
    the dwpose person detector, io/dwpose.py:detect_persons).

Weights are external artifacts, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .dwpose import detect_persons, nms

# ImageNet pixel stats shared by the SAM encoder and mmpose (dwpose.py:181).
_PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
_PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)


def sam_preprocess(
    frame: np.ndarray, encoder_size: int
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """(H, W, 3) uint8 -> padded (1, 3, S, S) float32 + resized (h, w)."""
    from PIL import Image

    h, w = frame.shape[:2]
    scale = encoder_size / max(h, w)
    nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
    resized = np.asarray(
        Image.fromarray(frame.astype(np.uint8)).resize((nw, nh))
    ).astype(np.float32)
    x = (resized - _PIXEL_MEAN) / _PIXEL_STD
    pad = np.zeros((encoder_size, encoder_size, 3), np.float32)
    pad[:nh, :nw] = x
    return pad.transpose(2, 0, 1)[None], (nh, nw)


def build_point_grid(
    points_per_side: int, sized_hw: Tuple[int, int]
) -> np.ndarray:
    """Evenly spaced prompt grid over the un-padded image region.

    Returns (P, 2) (x, y) coords in encoder input space — the cell-center
    layout segment-anything's automatic generator uses.
    """
    nh, nw = sized_hw
    frac = (np.arange(points_per_side, dtype=np.float32) + 0.5) / points_per_side
    xs = frac * nw
    ys = frac * nh
    gx, gy = np.meshgrid(xs, ys)
    return np.stack([gx.ravel(), gy.ravel()], axis=-1)


def stability_score(
    logits: np.ndarray, mask_threshold: float, offset: float
) -> float:
    """IoU between the mask thresholded at +/- offset around the cutoff.

    segment-anything's stability filter: masks whose area barely moves when
    the cutoff shifts are 'stable'.
    """
    hi = float((logits > mask_threshold + offset).sum())
    lo = float((logits > mask_threshold - offset).sum())
    return hi / lo if lo > 0 else 0.0


def _mask_bbox(mask: np.ndarray) -> Optional[np.ndarray]:
    ys, xs = np.nonzero(mask)
    if ys.size == 0:
        return None
    return np.array(
        [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1], np.float32
    )


class SamAutomaticMaskProcessor:
    """frames (T, H, W, 3) uint8 -> segmentation maps (T, H, W, 3) uint8.

    One encoder pass per frame, one decoder pass per grid prompt; masks are
    filtered by predicted IoU and stability, deduplicated with box NMS, and
    painted largest-first in deterministic pseudo-random colors (the
    reference's SamAutomaticMaskGenerator + random-color render,
    mmcm controlnet.py 'sam'/'mobile_sam').
    """

    def __init__(
        self,
        encoder,
        decoder,
        *,
        encoder_size: int = 1024,
        points_per_side: int = 8,
        pred_iou_thresh: float = 0.88,
        stability_score_thresh: float = 0.92,
        stability_offset: float = 1.0,
        box_nms_iou: float = 0.7,
        mask_threshold: float = 0.0,
        min_mask_area: int = 16,
        seed: int = 0,
    ):
        self.encoder = encoder
        self.decoder = decoder
        self.encoder_size = encoder_size
        self.points_per_side = points_per_side
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_offset = stability_offset
        self.box_nms_iou = box_nms_iou
        self.mask_threshold = mask_threshold
        self.min_mask_area = min_mask_area
        self.seed = seed

    # -- decoder plumbing ---------------------------------------------------

    def _decode_point(
        self, emb: np.ndarray, point: np.ndarray, orig_hw: Tuple[int, int]
    ) -> Tuple[np.ndarray, float]:
        """One point prompt -> (mask logits (h, w), predicted IoU)."""
        s4 = self.encoder_size // 4
        feeds = {
            "image_embeddings": emb,
            "point_coords": np.concatenate(
                [point[None], np.zeros((1, 2), np.float32)]
            )[None].astype(np.float32),
            "point_labels": np.array([[1.0, -1.0]], np.float32),
            "mask_input": np.zeros((1, 1, s4, s4), np.float32),
            "has_mask_input": np.zeros((1,), np.float32),
            "orig_im_size": np.array(orig_hw, np.float32),
        }
        names = list(self.decoder.input_names)
        unknown = [n for n in names if n not in feeds]
        if unknown:
            raise ValueError(
                f"SAM decoder has unrecognized inputs {unknown}; expected a "
                f"subset of {sorted(feeds)} (the official segment-anything "
                "ONNX export contract)"
            )
        outs = self.decoder.run({n: feeds[n] for n in names})
        masks = np.asarray(outs[0], np.float32)
        iou = float(np.asarray(outs[1], np.float32).ravel()[0])
        while masks.ndim > 2:  # (1, 1, h, w) -> (h, w)
            masks = masks[0]
        return masks, iou

    def _frame_masks(self, frame: np.ndarray) -> list:
        """All surviving (bool mask, iou, area) for one frame."""
        from PIL import Image

        h, w = frame.shape[:2]
        inp, sized_hw = sam_preprocess(frame, self.encoder_size)
        (emb,) = self.encoder.run({self.encoder.input_names[0]: inp})
        emb = np.asarray(emb, np.float32)
        cands = []
        for point in build_point_grid(self.points_per_side, sized_hw):
            logits, iou = self._decode_point(emb, point, (h, w))
            if iou < self.pred_iou_thresh:
                continue
            if (
                stability_score(
                    logits, self.mask_threshold, self.stability_offset
                )
                < self.stability_score_thresh
            ):
                continue
            if logits.shape != (h, w):
                # decoder exports without orig_im_size return low-res masks
                logits = np.asarray(
                    Image.fromarray(logits).resize((w, h), Image.BILINEAR)
                )
            mask = logits > self.mask_threshold
            area = int(mask.sum())
            if area < self.min_mask_area:
                continue
            bbox = _mask_bbox(mask)
            if bbox is None:
                continue
            cands.append((mask, iou, area, bbox))
        if not cands:
            return []
        boxes = np.stack([c[3] for c in cands])
        scores = np.array([c[1] for c in cands], np.float32)
        keep = nms(boxes, scores, self.box_nms_iou)
        return [cands[i][:3] for i in keep]

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        frames = np.asarray(frames)
        rng = np.random.RandomState(self.seed)
        # one palette per clip so a mask keeps its color across frames
        palette = rng.randint(0, 256, size=(4096, 3)).astype(np.uint8)
        out = []
        for frame in frames:
            canvas = np.zeros_like(frame)
            masks = sorted(self._frame_masks(frame), key=lambda c: -c[2])
            for i, (mask, _iou, _area) in enumerate(masks):
                canvas[mask] = palette[i % len(palette)]
            out.append(canvas)
        return np.stack(out)


class FaceDetectorProcessor:
    """frames (T, H, W, 3) uint8 -> face-box condition maps.

    Runs a yolox-format detector through the shared grid decode + NMS and
    renders each detection as a filled box (white) with its outline, the
    face-region condition the reference's 'face_detector' name produces
    (mmcm controlnet.py:513; weights external there too).
    """

    def __init__(
        self,
        det_model,
        *,
        input_size: Tuple[int, int] = (640, 640),
        score_thr: float = 0.3,
        iou_thr: float = 0.45,
        class_index: int = 0,
    ):
        self.det = det_model
        self.input_size = input_size
        self.score_thr = score_thr
        self.iou_thr = iou_thr
        self.class_index = class_index

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        frames = np.asarray(frames)
        out = []
        for frame in frames:
            h, w = frame.shape[:2]
            boxes = detect_persons(
                self.det,
                frame,
                input_size=self.input_size,
                score_thr=self.score_thr,
                iou_thr=self.iou_thr,
                class_index=self.class_index,
            )
            canvas = np.zeros((h, w, 3), np.uint8)
            for x1, y1, x2, y2 in boxes:
                x1 = int(np.clip(x1, 0, w - 1))
                x2 = int(np.clip(x2, x1 + 1, w))
                y1 = int(np.clip(y1, 0, h - 1))
                y2 = int(np.clip(y2, y1 + 1, h))
                canvas[y1:y2, x1:x2] = 255
            out.append(canvas)
        return np.stack(out)


def register_sam(
    encoder_path: str,
    decoder_path: str,
    names: Sequence[str] = ("sam", "mobile_sam"),
    device=None,
    **kwargs,
) -> None:
    """Load the encoder/decoder onnx pair (on ``device``: CUDA unless
    given) and register the sam variants."""
    from ..onnx.runtime import OnnxModel
    from .processors import register_processor

    enc = OnnxModel.from_file(encoder_path, device=device)
    dec = OnnxModel.from_file(decoder_path, device=device)
    proc = SamAutomaticMaskProcessor(enc, dec, **kwargs)
    for name in names:
        register_processor(name, proc)


def register_face_detector(det_path: str, device=None, **kwargs) -> None:
    """Load a yolox-format face detector (on ``device``: CUDA unless given)
    and register it as ``face_detector``."""
    from ..onnx.runtime import OnnxModel
    from .processors import register_processor

    det = OnnxModel.from_file(det_path, device=device)
    register_processor("face_detector", FaceDetectorProcessor(det, **kwargs))
