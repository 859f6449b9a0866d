"""Serving layer: shape/length guards, online inference callables, gradio UI.

Counterpart of ``musev_tpu/serve/app.py`` (reference scripts/gradio/app.py:
Blocks UI :185-395, ``limit_shape`` :92-123 caps the longest edge and snaps
to /8, ``limit_length`` :124-131 caps at 144 frames;
gradio_text2video.py:614-937 ``online_t2v_inference``; gradio_video2video.py,
whose source video is read here through ``VideoReader``; the HF-space
variants' checkpoint bootstrap, app_gradio_space.py:18-33, with a pluggable
downloader: nothing here downloads). The inference functions are plain
callables over the port's ``MusevPipeline``, so the serving path runs and is
tested without gradio; ``build_demo`` and ``build_space_demo`` import gradio
when called and raise without it, as the JAX package's do.
"""

from __future__ import annotations

import logging
import math
import os
import tempfile
from typing import Callable, Optional, Tuple, Union

import numpy as np

logger = logging.getLogger(__name__)

MAX_EDGE = 1280
MAX_FRAMES = 144


def limit_shape(
    image: np.ndarray,
    input_w: int,
    input_h: int,
    img_edge_ratio: float,
    max_image_edge: int = MAX_EDGE,
) -> Tuple[int, int, float]:
    """Cap the longest target edge and snap dims to multiples of 8
    (reference app.py:92-123). Returns (out_w, out_h, out_ratio)."""
    if input_h == -1 and input_w == -1:
        if image is None:
            raise ValueError("image must be given when w=h=-1")
        input_h, input_w = image.shape[:2]
    if img_edge_ratio == 0:
        img_edge_ratio = 1.0
    img_edge_ratio_infer = img_edge_ratio
    if max(input_h, input_w) * img_edge_ratio > max_image_edge:
        img_edge_ratio_infer = max_image_edge / max(input_h, input_w)
    out_w = int(input_w * img_edge_ratio_infer // 8 * 8)
    out_h = int(input_h * img_edge_ratio_infer // 8 * 8)
    return out_w, out_h, img_edge_ratio_infer


def limit_length(length: float, max_frames: int = MAX_FRAMES) -> int:
    """Cap generated frames (reference app.py:124-131)."""
    if length * 12 > max_frames:  # fps 12
        length = max_frames // 12
    return int(length)


def ensure_checkpoints(
    checkpoint_dir: str,
    downloader: Optional[Callable[[str], None]] = None,
) -> str:
    """HF-space bootstrap hook (app_gradio_space.py:18-33): when the
    checkpoint dir is missing/empty, invoke the pluggable ``downloader``
    (the reference uses huggingface_hub.snapshot_download; any callable
    taking the target dir works)."""
    if os.path.isdir(checkpoint_dir) and os.listdir(checkpoint_dir):
        return checkpoint_dir
    if downloader is None:
        raise FileNotFoundError(
            f"checkpoint dir {checkpoint_dir!r} is empty and no downloader "
            "was provided (reference: snapshot_download('TMElyralab/MuseV'))"
        )
    os.makedirs(checkpoint_dir, exist_ok=True)
    downloader(checkpoint_dir)
    return checkpoint_dir


def _resize_frames(frames: np.ndarray, w: int, h: int) -> np.ndarray:
    if frames.shape[1:3] == (h, w):
        return frames
    from PIL import Image

    return np.stack(
        [
            np.asarray(Image.fromarray(f.astype(np.uint8)).resize((w, h)))
            for f in frames
        ]
    )


def read_video_input(
    video: Union[str, np.ndarray], max_frames: int = MAX_FRAMES
) -> np.ndarray:
    """Accept what ``gr.Video`` yields — a file path (or (path, subtitles)
    tuple) — as well as a raw frame array. The reference reads the path via
    DecordVideoDataset (gradio_video2video.py); here the native VideoReader."""
    if isinstance(video, (tuple, list)):
        video = video[0]
    if isinstance(video, str):
        from ..io.video import VideoReader

        reader = VideoReader(video)
        frames = []
        n = 0
        for win in reader.windows(16):
            frames.append(win)
            n += win.shape[0]
            if n >= max_frames:
                break
        reader.close()
        if not frames:
            raise ValueError(f"no frames decoded from {video!r}")
        return np.concatenate(frames)[:max_frames]
    return np.asarray(video)[:max_frames]


class OnlineInference:
    """Holds a pipeline and exposes the two gradio entry points."""

    def __init__(self, pipeline, fps: int = 12, time_size: int = 12):
        self.pipe = pipeline
        self.fps = fps
        self.time_size = time_size

    def online_t2v_inference(
        self,
        prompt: str,
        image: Optional[np.ndarray],
        seed: int = -1,
        fps: int = 12,
        w: int = -1,
        h: int = -1,
        video_length: int = 12,
        img_edge_ratio: float = 1.0,
    ) -> np.ndarray:
        """(T, H, W, 3) uint8 frames (gradio_text2video.py:614).

        Length uses the reference's shot arithmetic: shots of ``time_size``
        frames chained until >= video_length, then trimmed — a 30-frame
        request yields exactly 30 generated frames (+1 condition frame)."""
        w, h, _ = limit_shape(image, w, h, img_edge_ratio)
        video_length = min(int(video_length), MAX_FRAMES)
        # -1 = random, per the UI label (reference gradio default)
        seed = (
            int(seed)
            if seed is not None and int(seed) >= 0
            else int(np.random.randint(0, 2**31 - 1))
        )
        cond = image[None, None] if image is not None else None
        if cond is not None and cond.shape[2:4] != (h, w):
            cond = _resize_frames(np.asarray(image)[None], w, h)[None]
        n_batch = max(1, math.ceil(video_length / self.time_size))
        res = self.pipe.text2video(
            prompt,
            height=h,
            width=w,
            video_length=self.time_size,
            n_batch=n_batch,
            condition_images=cond,
            seed=seed,
        )
        n_cond = res.videos.shape[1] - n_batch * self.time_size
        frames = res.videos[0, : n_cond + video_length]
        return (frames * 255).astype(np.uint8)

    def online_v2v_inference(
        self,
        prompt: str,
        image: Optional[np.ndarray],
        video: Union[str, np.ndarray],
        seed: int = -1,
        fps: int = 12,
        w: int = -1,
        h: int = -1,
        img_edge_ratio: float = 1.0,
        video_is_middle: bool = True,
        controlnet_name: Optional[str] = None,
    ) -> np.ndarray:
        video_frames = read_video_input(video)
        w, h, _ = limit_shape(
            video_frames[0] if image is None else image, w, h, img_edge_ratio
        )
        video_frames = _resize_frames(video_frames, w, h)
        # -1 = random, per the UI label (reference gradio default)
        seed = (
            int(seed)
            if seed is not None and int(seed) >= 0
            else int(np.random.randint(0, 2**31 - 1))
        )
        cond = None
        if image is not None:
            cond = _resize_frames(np.asarray(image)[None], w, h)[None]
        processor = None
        if controlnet_name and controlnet_name != "none":
            from ..io.processors import get_processor

            processor = get_processor(controlnet_name)
            video_is_middle = False
        res = self.pipe.video2video(
            prompt,
            video_frames,
            video_is_middle=video_is_middle,
            controlnet_processor=processor,
            condition_images=cond,
            time_size=self.time_size,
            height=h,
            width=w,
            seed=seed,
        )
        return (res.videos[0] * 255).astype(np.uint8)


def _to_video_file(frames: np.ndarray, fps: int) -> str:
    """Write frames to a temp mp4 for ``gr.Video`` (which takes a path)."""
    fd, path = tempfile.mkstemp(suffix=".mp4", prefix="musev_")
    os.close(fd)  # mkstemp is race-free; the writer reopens by path
    from ..io.video import native_available, write_video

    if native_available():
        write_video(path, frames, fps=fps)
    else:  # pragma: no cover - fallback writer
        import imageio

        imageio.mimwrite(path, frames, fps=fps)
    return path


def build_demo(pipeline, fps: int = 12):
    """gr.Blocks UI with T2V and V2V tabs (reference app.py:185-395)."""
    try:
        import gradio as gr
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("gradio is not installed: the UI needs it") from e

    infer = OnlineInference(pipeline, fps=fps)

    def t2v(p, im, s, l, ww, hh, r):
        frames = infer.online_t2v_inference(
            p, im, s, fps, int(ww), int(hh), int(l), r
        )
        return _to_video_file(frames, fps)

    def v2v(p, im, v, s, ww, hh, r):
        frames = infer.online_v2v_inference(
            p, im, v, s, fps, int(ww), int(hh), r
        )
        return _to_video_file(frames, fps)

    with gr.Blocks() as demo:
        gr.Markdown("# MuseV: infinite-length virtual human video")
        with gr.Tab("Text/Image to Video"):
            prompt = gr.Textbox(label="prompt")
            image = gr.Image(label="condition image (optional)")
            with gr.Row():
                seed = gr.Number(label="seed (-1 random)", value=-1)
                length = gr.Number(label="video length", value=12)
            with gr.Row():
                w = gr.Number(label="width (-1 auto)", value=-1)
                h = gr.Number(label="height (-1 auto)", value=-1)
                ratio = gr.Number(label="img edge ratio", value=1.0)
            out = gr.Video(label="result")
            gr.Button("generate").click(
                t2v, [prompt, image, seed, length, w, h, ratio], out
            )
        with gr.Tab("Video to Video"):
            prompt2 = gr.Textbox(label="prompt")
            image2 = gr.Image(label="condition image (optional)")
            video_in = gr.Video(label="pose/source video")
            with gr.Row():
                seed2 = gr.Number(label="seed (-1 random)", value=-1)
                w2 = gr.Number(label="width (-1 auto)", value=-1)
                h2 = gr.Number(label="height (-1 auto)", value=-1)
                ratio2 = gr.Number(label="img edge ratio", value=1.0)
            out2 = gr.Video(label="result")
            gr.Button("generate").click(
                v2v, [prompt2, image2, video_in, seed2, w2, h2, ratio2], out2
            )
    return demo


def build_space_demo(
    model_name: str = "musev",
    checkpoint_dir: str = "./checkpoints",
    downloader: Optional[Callable[[str], None]] = None,
    **preset_overrides,
):
    """HF-space style entry (app_gradio_space.py): bootstrap checkpoints,
    build the model zoo, return the demo."""
    from ..configs.model_registry import get_model_preset
    from ..pipelines.loader import build_models
    from ..pipelines.pipeline import MusevPipeline

    ensure_checkpoints(checkpoint_dir, downloader)
    preset = get_model_preset(model_name, **preset_overrides)

    def resolve(cand: str) -> Optional[str]:
        """snapshot_download lays out per-model *directories*; the loaders
        take weight files — pick the weight file inside."""
        if os.path.isfile(cand):
            return cand
        if os.path.isdir(cand):
            for ext in (".safetensors", ".bin", ".pt", ".pth", ".ckpt"):
                hits = sorted(
                    f for f in os.listdir(cand) if f.endswith(ext)
                )
                if hits:
                    return os.path.join(cand, hits[0])
        return None

    for slot in ("unet_checkpoint", "sd_base_checkpoint", "vae_checkpoint",
                 "text_checkpoint"):
        if getattr(preset, slot) is None:
            cand = resolve(
                os.path.join(checkpoint_dir, slot.replace("_checkpoint", ""))
            )
            if cand is not None:
                setattr(preset, slot, cand)
    pipe = MusevPipeline(build_models(preset))
    return build_demo(pipe)
