"""Host-side ControlNet condition processors (counterpart of ``musev_tpu/io/processors.py``).

Processors are plain callables ``(T, H, W, 3) uint8 -> (T, H, W, 3) uint8``
registered by name (the reference's mmcm/controlnet_aux zoo). The numpy-only
built-ins are copies of the JAX package's:

  * ``none`` — pass-through (``video_is_middle=True`` flows)
  * ``canny`` — numpy separable gaussian + Sobel + NMS + hysteresis
  * ``tile`` / ``content`` — low-pass / content-shuffle maps

``OnnxImageProcessor`` runs an image-to-map ONNX model (depth, hed,
scribble, lineart, normal conventions) on the port's executor, and
``register_onnx_processor(name, path)`` registers one under a reference
name. The dwpose family (``dwpose*``, ``pose*``: ``io/dwpose.py``), SAM
and the face detector (``io/sam.py``) register through their own modules'
``register_*``. Custom stages register a callable via
``register_processor``; unregistered names raise.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

Processor = Callable[[np.ndarray], np.ndarray]

_REGISTRY: Dict[str, Processor] = {}


def register_processor(name: str, fn: Processor) -> None:
    _REGISTRY[name] = fn


def get_processor(name: str) -> Processor:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"controlnet processor {name!r} is not registered; available: "
            f"{sorted(_REGISTRY)}. Register your own with "
            "musev_torch.io.processors.register_processor (e.g. a dwpose "
            "onnx wrapper)."
        ) from None


def _identity(frames: np.ndarray) -> np.ndarray:
    return frames


def _gaussian_blur_gray(img: np.ndarray, sigma: float = 1.4) -> np.ndarray:
    radius = max(1, int(3 * sigma))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-(x**2) / (2 * sigma**2))
    k /= k.sum()
    out = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 1, img)
    out = np.apply_along_axis(lambda c: np.convolve(c, k, mode="same"), 0, out)
    return out


def canny_frame(
    frame: np.ndarray, low: float = 0.1, high: float = 0.2
) -> np.ndarray:
    """Canny edges of one (H, W, 3) uint8 frame -> (H, W, 3) uint8 edge map."""
    gray = frame.astype(np.float32).mean(axis=-1) / 255.0
    sm = _gaussian_blur_gray(gray)
    gx = np.zeros_like(sm)
    gy = np.zeros_like(sm)
    gx[1:-1, 1:-1] = (
        sm[:-2, 2:] + 2 * sm[1:-1, 2:] + sm[2:, 2:]
        - sm[:-2, :-2] - 2 * sm[1:-1, :-2] - sm[2:, :-2]
    )
    gy[1:-1, 1:-1] = (
        sm[2:, :-2] + 2 * sm[2:, 1:-1] + sm[2:, 2:]
        - sm[:-2, :-2] - 2 * sm[:-2, 1:-1] - sm[:-2, 2:]
    )
    mag = np.hypot(gx, gy)
    ang = np.arctan2(gy, gx)
    # non-max suppression along the quantized gradient direction
    q = ((ang + np.pi) / (np.pi / 4)).round().astype(int) % 4
    offsets = {0: (0, 1), 1: (1, 1), 2: (1, 0), 3: (1, -1)}
    nms = np.zeros_like(mag)
    for d, (dy, dx) in offsets.items():
        a = np.roll(mag, (dy, dx), axis=(0, 1))
        b = np.roll(mag, (-dy, -dx), axis=(0, 1))
        keep = (mag >= a) & (mag >= b) & (q == d)
        nms[keep] = mag[keep]
    strong = nms >= high
    weak = (nms >= low) & ~strong
    # one-pass hysteresis: weak pixels next to strong survive
    grow = strong.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            grow |= np.roll(strong, (dy, dx), axis=(0, 1))
    edges = strong | (weak & grow)
    out = (edges * 255).astype(np.uint8)
    return np.stack([out] * 3, axis=-1)


def canny_video(frames: np.ndarray, low: float = 0.1, high: float = 0.2):
    return np.stack([canny_frame(f, low, high) for f in frames])


register_processor("none", _identity)
register_processor("canny", canny_video)


def _gaussian_blur_rgb(img: np.ndarray, sigma: float) -> np.ndarray:
    """(H, W, 3) float32 separable gaussian blur, edge-replicated borders
    (zero padding would darken the frame edges)."""
    radius = max(1, int(3 * sigma))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-(x**2) / (2 * sigma**2))
    k /= k.sum()
    pad = np.pad(img, ((radius, radius), (radius, radius), (0, 0)), mode="edge")
    out = np.empty_like(img)
    for c in range(img.shape[-1]):
        ch = np.apply_along_axis(
            lambda r: np.convolve(r, k, mode="valid"), 1, pad[..., c]
        )
        out[..., c] = np.apply_along_axis(
            lambda col: np.convolve(col, k, mode="valid"), 0, ch
        )
    return out


def tile_video(frames: np.ndarray, down: int = 2) -> np.ndarray:
    """'tile' controlnet conditioning: the image itself, low-passed (the
    lllyasviel tile preprocessing = downscale blur; mmcm controlnet.py:513
    name 'tile')."""
    out = []
    for f in frames:
        blurred = _gaussian_blur_rgb(f.astype(np.float32), sigma=float(down))
        out.append(np.clip(blurred, 0, 255).astype(np.uint8))
    return np.stack(out)


def _smooth_noise(h: int, w: int, cell: int, rng: np.random.RandomState):
    """Smooth [0,1] noise field: coarse uniform noise bicubically upsampled
    (the controlnet_aux make_noise_disk construction behind the 'content'
    shuffle processor)."""
    from PIL import Image

    coarse = rng.uniform(size=((h // cell) + 2, (w // cell) + 2)).astype(
        np.float32
    )
    img = Image.fromarray(coarse, mode="F").resize(
        (w + 2 * cell, h + 2 * cell), Image.BICUBIC
    )
    n = np.asarray(img, np.float32)[cell : cell + h, cell : cell + w]
    lo, hi = float(n.min()), float(n.max())
    return (n - lo) / (hi - lo) if hi > lo else np.zeros_like(n)


def _bilinear_sample(img: np.ndarray, ys: np.ndarray, xs: np.ndarray):
    h, w = img.shape[:2]
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = (ys - y0)[..., None]
    fx = (xs - x0)[..., None]
    a = img[y0, x0].astype(np.float32)
    b = img[y0, x1].astype(np.float32)
    c = img[y1, x0].astype(np.float32)
    d = img[y1, x1].astype(np.float32)
    return a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx + c * fy * (1 - fx) + d * fy * fx


def content_shuffle_video(
    frames: np.ndarray, cell: int = 256, seed: int = 0
) -> np.ndarray:
    """'content' controlnet conditioning (controlnet_aux
    ContentShuffleDetector; mmcm controlnet.py:513 name 'content'): remap
    every pixel through a smooth random absolute-coordinate field, keeping
    color/content statistics while destroying structure. One flow field is
    shared across the clip (per-frame reshuffling would flicker the
    conditioning; the reference processes stills)."""
    frames = np.asarray(frames)
    t, h, w = frames.shape[:3]
    rng = np.random.RandomState(seed)
    xs = _smooth_noise(h, w, min(cell, max(h, w)), rng) * float(w - 1)
    ys = _smooth_noise(h, w, min(cell, max(h, w)), rng) * float(h - 1)
    out = [
        np.clip(_bilinear_sample(f, ys, xs), 0, 255).astype(np.uint8)
        for f in frames
    ]
    return np.stack(out)


register_processor("tile", tile_video)
register_processor("content", content_shuffle_video)


# ---------------------------------------------------------------------------
# generic ONNX-backed single-image processors (depth / hed / lineart ...)
# run on the port's executor (musev_torch.onnx) — the reference drives these
# through onnxruntime/controlnet_aux binaries

_ONNX_KIND_DEFAULTS = {
    # midas/dpt-style relative depth: (x/255 - 0.5)/0.5 input, single-channel
    # output min-max normalized per frame (controlnet_aux MidasDetector)
    "depth": dict(mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
                  post="minmax", input_size=384),
    # HED edge net: raw 0-255 float input, sigmoid edge prob output
    # (controlnet_aux ControlNetHED contract)
    "hed": dict(mean=None, std=None, post="unit", input_size=None),
    # scribble = binarized hed
    "scribble": dict(mean=None, std=None, post="binary", input_size=None),
    # lineart generators: x/255 input, line-intensity output rendered as
    # white-on-black (controlnet_aux LineartDetector)
    "lineart": dict(mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0),
                    post="invert", input_size=None),
    # surface-normal nets (controlnet_aux NormalBaeDetector): imagenet-
    # normalized input, 3-channel normal-vector output rendered as the
    # standard ((n/|n|)+1)/2 RGB normal map
    "normal": dict(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
                   post="normal", input_size=384),
}


class OnnxImageProcessor:
    """frames (T, H, W, 3) uint8 -> (T, H, W, 3) uint8 maps via an ONNX
    image-to-map model run by the port's executor.

    The model is fed NCHW float32. ``kind`` picks the reference
    pre/postprocessing convention (see _ONNX_KIND_DEFAULTS); every knob can
    be overridden. ``input_size``: long-side resize before inference (None =
    native resolution, rounded down to ``multiple_of``); the map is resized
    back to the source frame size.
    """

    def __init__(self, model, kind: str = "depth", *, input_size=...,
                 multiple_of: int = 32, mean=..., std=..., post=...,
                 threshold: float = 0.5):
        if kind not in _ONNX_KIND_DEFAULTS:
            raise ValueError(
                f"unknown onnx processor kind {kind!r}; choose from "
                f"{sorted(_ONNX_KIND_DEFAULTS)}"
            )
        d = _ONNX_KIND_DEFAULTS[kind]
        self.model = model
        self.kind = kind
        self.input_size = d["input_size"] if input_size is ... else input_size
        self.multiple_of = multiple_of
        self.mean = d["mean"] if mean is ... else mean
        self.std = d["std"] if std is ... else std
        self.post = d["post"] if post is ... else post
        self.threshold = threshold

    def _pre(self, frame: np.ndarray) -> np.ndarray:
        from PIL import Image

        h, w = frame.shape[:2]
        if self.input_size:
            s = self.input_size / max(h, w)
            nh, nw = max(1, round(h * s)), max(1, round(w * s))
        else:
            nh, nw = h, w
        m = self.multiple_of
        nh, nw = max(m, nh - nh % m), max(m, nw - nw % m)
        if (nh, nw) != (h, w):
            frame = np.asarray(
                Image.fromarray(frame.astype(np.uint8)).resize((nw, nh))
            )
        x = frame.astype(np.float32)
        if self.mean is not None:
            x = x / 255.0
            x = (x - np.asarray(self.mean, np.float32)) / np.asarray(
                self.std, np.float32
            )
        return x.transpose(2, 0, 1)[None]  # NCHW

    def _post(self, y: np.ndarray, h: int, w: int) -> np.ndarray:
        from PIL import Image

        y = np.asarray(y, np.float32)
        if self.post == "normal":
            while y.ndim > 3:  # (1, 3, H', W') -> (3, H', W')
                y = y[0]
            n = y / np.maximum(
                np.linalg.norm(y, axis=0, keepdims=True), 1e-6
            )
            rgb = ((n + 1.0) * 0.5 * 255.0).astype(np.uint8)
            rgb = rgb.transpose(1, 2, 0)
            if rgb.shape[:2] != (h, w):
                rgb = np.asarray(Image.fromarray(rgb).resize((w, h)))
            return rgb
        while y.ndim > 2:  # (1, [1,] H', W') -> (H', W')
            y = y[0] if y.shape[0] == 1 else y.mean(axis=0)
        if self.post == "minmax":
            lo, hi = float(y.min()), float(y.max())
            y = (y - lo) / (hi - lo) if hi > lo else np.zeros_like(y)
        elif self.post == "unit":
            y = np.clip(y, 0.0, 1.0)
        elif self.post == "binary":
            y = (np.clip(y, 0.0, 1.0) > self.threshold).astype(np.float32)
        elif self.post == "invert":
            y = 1.0 - np.clip(y, 0.0, 1.0)
        else:
            raise ValueError(f"unknown post {self.post!r}")
        g = (y * 255.0).astype(np.uint8)
        if g.shape != (h, w):
            g = np.asarray(Image.fromarray(g).resize((w, h)))
        return np.stack([g] * 3, axis=-1)

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        out = []
        for f in frames:
            h, w = f.shape[:2]
            (y,) = self.model.run({self.model.input_names[0]: self._pre(f)})
            out.append(self._post(y, h, w))
        return np.stack(out)


_NAME_TO_KIND = {
    "depth": "depth", "zoe": "depth", "leres": "depth",
    "hed": "hed", "softedge": "hed", "pidi": "hed",
    "hed_scribble": "scribble", "scribble": "scribble",
    "lineart": "lineart", "lineart_anime": "lineart",
    "normal_bae": "normal", "normal": "normal",
}


def register_onnx_processor(name: str, onnx_path: str, kind: str = None, device=None,
                            **kwargs) -> None:
    """Register an ONNX-backed map processor under ``name``, its model on
    ``device`` (CUDA unless given).

    ``kind`` defaults from the name (depth/hed/lineart families,
    mmcm controlnet.py:513 name list)."""
    from ..onnx.runtime import OnnxModel

    if kind is None:
        kind = _NAME_TO_KIND.get(name)
        if kind is None:
            raise ValueError(
                f"cannot infer processor kind from name {name!r}; pass "
                f"kind= one of {sorted(_ONNX_KIND_DEFAULTS)}"
            )
    model = OnnxModel.from_file(onnx_path, device=device)
    register_processor(name, OnnxImageProcessor(model, kind, **kwargs))
