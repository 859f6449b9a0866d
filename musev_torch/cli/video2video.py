"""video2video / pose2video CLI (counterpart of ``musev_tpu/cli/video2video.py``).

Reads each task's ``video_path`` through the native ``VideoReader`` in
windows of ``--time_size`` frames (decoded ahead on a background thread by
``PrefetchingWindows``), optionally treats them as the control maps
(``video_is_middle``), runs ``MusevPipeline.video2video`` with the
processor named by ``--controlnet_name`` and writes an mp4 (PNG frames
without the native library). The flags, defaults and output file name are
the JAX CLI's, plus ``--device`` (default ``cuda``) and ``--tiny``;
``--dtype`` defaults to bfloat16 on CUDA and float32 on the CPU. The
samplers and adapters are the text2video CLI's (``--lcm`` or
``--lcm_lora_path`` selects ``lcm``). The ONNX
host stages (``--processor_onnx``, dwpose, SAM, the face detector) and
``--parallel`` are not ported yet and raise before any model is built.
"""

from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np

from .text2video import (
    _load_image,
    _round16,
    _shrink_preset,
    _torch_dtype,
    refuse_unported_flags,
    write_frames,
)

# processor names the JAX CLI serves through its ONNX stages
_ONNX_PROCESSORS = ("dwpose", "pose", "sam", "mobile_sam", "face_detector")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="musev_torch video2video")
    p.add_argument("--test_data_path", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="./output")
    p.add_argument("--model_name", type=str, default="musev_referencenet_pose")
    p.add_argument("--unet_checkpoint", type=str, default=None)
    p.add_argument("--sd_base_checkpoint", type=str, default=None)
    p.add_argument("--vae_checkpoint", type=str, default=None)
    p.add_argument("--text_checkpoint", type=str, default=None)
    p.add_argument("--referencenet_checkpoint", type=str, default=None)
    p.add_argument("--clip_vision_checkpoint", type=str, default=None,
                   help="IP-Adapter image encoder (transformers "
                        "CLIPVisionModelWithProjection weights)")
    p.add_argument("--ip_adapter_checkpoint", type=str, default=None)
    p.add_argument("--controlnet_checkpoint", type=str, default=None)
    p.add_argument("--pose_guider_model_path", type=str, default=None,
                   help="Moore-AnimateAnyone PoseGuider checkpoint "
                        "(reference video2video.py:531-534)")
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--time_size", type=int, default=12)
    p.add_argument("--fps", type=int, default=12)
    p.add_argument("--sample_rate", type=int, default=1)
    p.add_argument("--target_datas", type=str, default="all")
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--video_is_middle", action="store_true")
    p.add_argument("--controlnet_name", type=str, default="none",
                   help="condition processor: none|canny|tile|content|<registered> "
                        "(register custom via musev_torch.io.processors); the "
                        "ONNX-backed ones are not ported yet (ROADMAP queue 1, item 12)")
    p.add_argument("--processor_onnx", action="append", default=None,
                   help="not ported yet (ROADMAP queue 1, item 12)")
    p.add_argument("--dwpose_det_onnx", type=str,
                   default=os.environ.get("MUSEV_DWPOSE_DET"),
                   help="not ported yet (ROADMAP queue 1, item 12)")
    p.add_argument("--dwpose_pose_onnx", type=str,
                   default=os.environ.get("MUSEV_DWPOSE_POSE"),
                   help="not ported yet (ROADMAP queue 1, item 12)")
    p.add_argument("--sam_encoder_onnx", type=str,
                   default=os.environ.get("MUSEV_SAM_ENCODER"),
                   help="not ported yet (ROADMAP queue 1, item 12)")
    p.add_argument("--sam_decoder_onnx", type=str,
                   default=os.environ.get("MUSEV_SAM_DECODER"),
                   help="not ported yet (ROADMAP queue 1, item 12)")
    p.add_argument("--face_detector_onnx", type=str,
                   default=os.environ.get("MUSEV_FACE_DET"),
                   help="not ported yet (ROADMAP queue 1, item 12)")
    p.add_argument("--lora_path", action="append", default=None,
                   help="LoRA safetensors, repeatable; 'path' or 'path:scale'")
    p.add_argument("--textual_inversion", action="append", default=None,
                   help="textual-inversion embedding, repeatable; 'path' or "
                        "'path:trigger'")
    p.add_argument("--lcm_lora_path", type=str, default=None)
    p.add_argument("--lcm", action="store_true")
    p.add_argument("--need_hist_match", action="store_true")
    p.add_argument("--record_mid_video", action="store_true",
                   help="serial denoise: carry per-step tail latents/noises "
                        "between windows; not ported yet")
    p.add_argument("--video_overlap", type=int, default=1)
    p.add_argument("--need_video2video", action="store_true")
    p.add_argument("--video_strength", type=float, default=0.8)
    p.add_argument("--n_vision_condition", type=int, default=1)
    p.add_argument("--noise_type", type=str, default="video_fusion")
    p.add_argument("--video_guidance_scale", type=float, default=3.5)
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--guidance_rescale", type=float, default=0.0)
    p.add_argument("--video_num_inference_steps", type=int, default=10)
    p.add_argument("--num_inference_steps", type=int, default=30)
    p.add_argument("--w_ind_noise", type=float, default=0.5)
    p.add_argument("--motion_speed", type=float, default=8.0)
    p.add_argument("--context_frames", type=int, default=12)
    p.add_argument("--context_overlap", type=int, default=4)
    p.add_argument("--controlnet_conditioning_scale", type=float, default=1.0)
    p.add_argument("--negative_prompt", type=str, default="V2")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scheduler", type=str, default="euler")
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--strict_checkpoints", action="store_true",
                   help="raise (instead of log) when a provided checkpoint "
                        "is missing or leaves required param sites at "
                        "random init (loader strict mode)")
    p.add_argument("--dtype", type=str, default=None, choices=["float32", "bfloat16"],
                   help="default: bfloat16 on CUDA, float32 on the CPU; the CUDA "
                        "kernels take bfloat16 only")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch paths)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny random-weight model (smoke tests, no checkpoints)")
    p.add_argument("--parallel", type=str, default="none",
                   choices=["none", "fp", "dp"],
                   help="multi-device topology; only 'none' is ported "
                        "(ROADMAP queue 1, item 15)")
    return p.parse_args(argv)


_NOT_PORTED_FLAGS = (("processor_onnx", 12), ("dwpose_det_onnx", 12), ("dwpose_pose_onnx", 12),
                     ("sam_encoder_onnx", 12), ("sam_decoder_onnx", 12),
                     ("face_detector_onnx", 12))


def _windows(reader, args, height: int, width: int):
    """The source video's windows of ``time_size`` frames, decoded ahead,
    resized to (height, width) where they differ, up to ``max_frames``."""
    from ..io.video import PrefetchingWindows

    count = 0
    limit = args.max_frames or float("inf")
    for win in PrefetchingWindows(reader.windows(args.time_size, sample_rate=args.sample_rate)):
        if count >= limit:
            break
        if (height, width) != win.shape[1:3]:
            from PIL import Image

            win = np.stack([np.asarray(Image.fromarray(f).resize((width, height)))
                            for f in win])
        count += win.shape[0]
        yield win


def main(argv=None) -> List[str]:
    """Run every selected task that has a ``video_path``; returns the paths written."""
    args = parse_args(argv)
    refuse_unported_flags(args, _NOT_PORTED_FLAGS)
    if args.controlnet_name.startswith(_ONNX_PROCESSORS):
        raise NotImplementedError(
            f"--controlnet_name {args.controlnet_name} needs the ONNX host stages, which are "
            "not ported to musev_torch yet (ROADMAP queue 1, item 12)")
    from ..configs.model_registry import get_model_preset, resolve_negative_prompt
    from ..configs.tasks import load_tasks
    from ..io.processors import get_processor
    from ..io.video import VideoReader
    from ..pipelines.loader import build_models, refuse_unported
    from ..pipelines.pipeline import MusevPipeline
    from ..schedulers import create_scheduler

    scheduler = "lcm" if (args.lcm or args.lcm_lora_path) else args.scheduler
    create_scheduler(scheduler, 1)  # an unknown scheduler raises here
    processor = get_processor(args.controlnet_name)
    preset = get_model_preset(
        args.model_name,
        unet_checkpoint=args.unet_checkpoint,
        sd_base_checkpoint=args.sd_base_checkpoint,
        vae_checkpoint=args.vae_checkpoint,
        text_checkpoint=args.text_checkpoint,
        referencenet_checkpoint=args.referencenet_checkpoint,
        clip_vision_checkpoint=args.clip_vision_checkpoint,
        ip_adapter_checkpoint=args.ip_adapter_checkpoint,
        controlnet_checkpoint=args.controlnet_checkpoint,
        pose_guider_checkpoint=args.pose_guider_model_path,
        tokenizer_path=args.tokenizer_path,
        lora_checkpoints=args.lora_path,
        textual_inversion_checkpoints=args.textual_inversion,
        lcm_lora_checkpoint=args.lcm_lora_path,
    )
    refuse_unported(preset)
    if args.tiny:
        preset = _shrink_preset(preset)
    tasks = load_tasks(args.test_data_path)
    models = build_models(preset, device=args.device, dtype=_torch_dtype(args.dtype),
                          strict=args.strict_checkpoints)
    pipe = MusevPipeline(models, scheduler_name=scheduler)

    wanted = None if args.target_datas == "all" else set(args.target_datas.split(","))
    os.makedirs(args.output_dir, exist_ok=True)
    written = []
    for task in tasks:
        name = task.get("name", "task")
        if wanted is not None and name not in wanted:
            continue
        video_path = task.get("video_path")
        if not video_path:
            continue
        prompt = task["prompt"]
        negative = resolve_negative_prompt(task.get("video_negative_prompt", args.negative_prompt))
        with VideoReader(video_path) as reader:
            height = _round16(int(task.get("height", args.height or reader.height)))
            width = _round16(int(task.get("width", args.width or reader.width)))
            cond_path = task.get("condition_images")
            cond = _load_image(cond_path, height, width) if cond_path else None
            refer_path = task.get("refer_image")
            refer = _load_image(refer_path, height, width)[:, 0] if refer_path else None
            seed = int(task.get("seed", args.seed))
            res = pipe.video2video(
                prompt,
                _windows(reader, args, height, width),
                negative,
                controlnet_processor=processor,
                video_is_middle=bool(task.get("video_is_middle", args.video_is_middle)),
                need_video2video=args.need_video2video,
                video_strength=args.video_strength,
                condition_images=cond,
                time_size=args.time_size,
                n_vision_condition=args.n_vision_condition,
                height=height,
                width=width,
                video_num_inference_steps=args.video_num_inference_steps,
                num_inference_steps=args.num_inference_steps,
                video_guidance_scale=args.video_guidance_scale,
                guidance_scale=args.guidance_scale,
                guidance_rescale=args.guidance_rescale,
                context_frames=args.context_frames,
                context_overlap=args.context_overlap,
                noise_type=args.noise_type,
                w_ind_noise=args.w_ind_noise,
                motion_speed=args.motion_speed,
                controlnet_conditioning_scale=args.controlnet_conditioning_scale,
                refer_image=refer,
                seed=seed,
                need_hist_match=args.need_hist_match,
                record_mid_video=args.record_mid_video,
                video_overlap=args.video_overlap,
            )
        out_path = os.path.join(
            args.output_dir,
            f"{args.model_name}_{name}_w={width}_h={height}_t={args.time_size}_s={seed}.mp4",
        )
        frames = (res.videos[0] * 255).astype(np.uint8)
        out_path = write_frames(out_path, frames, args.fps)
        written.append(out_path)
        print(f"wrote {out_path} ({frames.shape[0]} frames)")
    return written


if __name__ == "__main__":
    main()
