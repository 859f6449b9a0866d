"""One run of one cell: set-up, warm-up, the measured window, the comparison
with the reference, the metrics.

Set-up draws the weights on the device from the seed, builds the program's
models through its own loader (``musev_torch.pipelines.loader.build_models``)
and copies the weights in, then runs one warm-up clip at the mix's shapes
with one step of each kind. The window is a closed loop of one client: clip
k + 1 is sent when clip k has returned its frames to the host; it opens after
the warm-up and closes at the end of the first clip that ends at or after
``seconds``, so it holds whole clips. A traced run wraps the same window in
the device trace and the spans. After the window the peak is read, the
program freed, and one clip of the window, drawn from the seed, is computed
again by the float32 reference from the same weights and inputs.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..reference import pipeline as ref
from ..reference.layers import Numerics
from . import traffic as tr
from .spans import Span, SpanRecorder
from .spec import Cell
from .trace import DeviceTrace, Op, busy_ns, gaps, idle_by_span, top_ops, window_clip
from .weights import draw
from .work import ClipWork, clip_work

CHECKS = ("latents_rel_l2", "frames_rel_l2")


@dataclasses.dataclass
class RunRecord:
    """What a run leaves for the metric readers (``bench_port/metrics``)."""

    setup_s: float
    window_s: float
    clips: int
    frames: int
    peak_bytes: int
    spans: List[Span] = dataclasses.field(default_factory=list)
    ops: List[Op] = dataclasses.field(default_factory=list)  # the window's device operations
    window_ns: Tuple[int, int] = (0, 0)  # the window on the device's clock
    offset_ns: int = 0
    work: Optional[ClipWork] = None


@dataclasses.dataclass
class Clip:
    request: tr.Request
    latents: np.ndarray  # (1, 1 + T, h, w, 4)
    videos: np.ndarray  # (1, 1 + T, H, W, 3) in [0, 1]
    end_s: float


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def port_models(cfg: dict, weights: Dict[str, Dict[str, torch.Tensor]], device, dtype,
                preset=None):
    """The program's models for ``cfg`` through its loader, with the run's
    weights copied in; every module the loader builds must be drawn here."""
    from musev_torch.pipelines.loader import build_models

    models = build_models(preset or cfg["preset"], device=device, dtype=dtype, seed=0)
    for field in dataclasses.fields(models):
        module = getattr(models, field.name)
        if isinstance(module, torch.nn.Module):
            if field.name not in weights:
                raise ValueError(f"the program builds {field.name!r}, which configuration "
                                 f"{cfg['name']!r} does not list")
            module.load_state_dict(weights[field.name], strict=True)
    return models


def run_clip(pipe, req: tr.Request, traffic: dict) -> Tuple[np.ndarray, np.ndarray]:
    """The program's entry on one request; returns (latents, videos) on the host."""
    a = req.args
    images = None if a.condition_image is None else a.condition_image[None, None]
    res = pipe.text2video(
        a.prompt, a.negative_prompt, height=a.height, width=a.width,
        video_length=a.video_length, n_batch=1, n_vision_condition=1,
        condition_images=images, video_num_inference_steps=a.video_steps,
        num_inference_steps=a.t2i_steps, video_guidance_scale=a.video_guidance,
        guidance_scale=a.t2i_guidance, context_frames=a.context_frames,
        context_overlap=a.context_overlap, w_ind_noise=a.w_ind_noise, img_weight=a.img_weight,
        motion_speed=a.motion_speed, seed=a.seed, decode_segment=traffic["decode_segment"])
    return res.latents, res.videos


def reference_clip(cfg: dict, run_seed: int, args: ref.ClipArgs, device, dtype: torch.dtype,
                   numerics: Optional[Numerics] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's (latents, videos) of one request, from the run's
    weights drawn again in ``dtype``, computed in float32 with TF32 off (or
    under ``numerics``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    weights = draw(cfg, run_seed, device, dtype)
    mods = ref.build(cfg, numerics or Numerics(), device="meta")
    ref.load(mods, weights, device)
    del weights
    out = ref.text2video(mods, args, device)
    del mods
    return out


def rel_l2(got, want) -> float:
    got = torch.as_tensor(got, device=want.device, dtype=torch.float32)
    want = want.float()
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


def compare(clip_latents, clip_videos, want: Tuple[torch.Tensor, torch.Tensor]) -> Dict[str, float]:
    """The numbers the limits hold: the clip's latents and frames against
    the reference's, by relative L2."""
    return dict(latents_rel_l2=rel_l2(clip_latents, want[0]),
                frames_rel_l2=rel_l2(clip_videos, want[1]))


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(cell: Cell, seed: int, seconds: float, trace: bool, t0: float, *,
        device: str = "cuda", preset=None, log=print) -> Tuple[dict, RunRecord, dict]:
    """One run; returns (the result's fields but ``metrics``, the record, the
    checks {name: (value, limit)}). ``preset`` replaces the configuration's
    preset (a CPU test's narrow one)."""
    from musev_torch.pipelines.pipeline import MusevPipeline

    cfg, traffic = cell.config, cell.traffic
    dev = torch.device(device)
    dtype = getattr(torch, cfg["dtype"]) if dev.type == "cuda" else torch.float32
    models = port_models(cfg, draw(cfg, seed, dev, dtype), dev, dtype, preset)
    free(dev)
    pipe = MusevPipeline(models)
    spans = SpanRecorder(models, cfg["spans"], timed=dev.type == "cuda") if trace else None
    run_clip(pipe, tr.warmup(traffic, seed), traffic)
    sync(dev)
    setup_s = time.time() - t0
    log(f"set-up {setup_s:.3f} s")

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    tracer = DeviceTrace() if trace else None
    if tracer is not None:
        tracer.__enter__()
        spans.active = True
    clips: List[Clip] = []
    start_ns = time.time_ns()
    t_start = time.perf_counter()
    for req in tr.closed_loop(traffic, seed):
        latents, videos = run_clip(pipe, req, traffic)
        clips.append(Clip(req, latents, videos, time.perf_counter() - t_start))
        if clips[-1].end_s >= seconds:
            break
    end_ns = time.time_ns()
    window_s = clips[-1].end_s
    if tracer is not None:
        spans.active = False
        tracer.__exit__(None, None, None)
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    frames = sum(int(c.videos.shape[0] * c.videos.shape[1]) for c in clips)
    failed = sum(not (np.isfinite(c.videos).all() and np.isfinite(c.latents).all()
                      and c.videos.min() >= 0.0 and c.videos.max() <= 1.0) for c in clips)
    rec = RunRecord(setup_s=setup_s, window_s=window_s,
                    clips=len(clips), frames=frames, peak_bytes=peak)
    extra: dict = {}
    if trace:
        rec.spans = spans.finish()
        rec.offset_ns = tracer.offset_ns
        rec.window_ns = (start_ns + tracer.offset_ns, end_ns + tracer.offset_ns)
        rec.ops = window_clip(tracer.ops, *rec.window_ns)
        rec.work = clip_work(cfg, clips[0].request.args)
        lo, hi = rec.window_ns
        idle = gaps(rec.ops, lo, hi)
        extra = dict(busy_s=busy_ns(rec.ops, lo, hi) / 1e9, window_s=(hi - lo) / 1e9,
                     breakdown=dict(device_ops=top_ops(rec.ops),
                                    idle_gaps=idle_by_span(idle, rec.spans, rec.offset_ns)))
    log(f"window {window_s:.3f} s, {len(clips)} clips, {frames} frames, peak {peak} B")

    del pipe, models, spans, tracer
    free(dev)
    pick = clips[int(np.random.default_rng([seed, 1]).integers(len(clips)))]
    t_ref = time.perf_counter()
    want = reference_clip(cfg, seed, pick.request.args, dev, dtype)
    got = compare(pick.latents, pick.videos, want)
    log(f"reference of clip {pick.request.index} in {time.perf_counter() - t_ref:.1f} s")
    checks = {name: (got[name], cell.limits[name]) for name in CHECKS}
    correct = failed == 0 and all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    head = dict(correct=bool(correct), attempted=len(clips), failed=int(failed), **extra)
    return head, rec, checks
