"""text2video CLI: task YAML/CSV -> mp4 videos (counterpart of ``musev_tpu/cli/text2video.py``).

The flags, their defaults, the per-task key overrides and the output file
name are the JAX CLI's, with two differences: ``--device`` (default
``cuda``; ``cpu`` runs the plain PyTorch paths) and ``--dtype``, whose
default is the port's own (bfloat16 on CUDA, float32 on the CPU).
``--scheduler`` picks any of the six samplers; ``--lcm`` or
``--lcm_lora_path`` selects ``lcm``, and the loader fuses ``--lora_path``,
``--textual_inversion`` and the LCM-LoRA into the models. Flags whose
branch is not ported yet raise ``NotImplementedError`` before any model is
built; options that ``MusevPipeline.text2video`` does not take yet raise
from there. Each task's clip is written as an mp4 when the native video
library is available, else as PNG frames.

Usage:
  python -m musev_torch.cli.text2video --test_data_path configs/tasks/example.yaml \\
      --output_dir ./output [--model_name musev] [--device cpu --tiny] [flags]
"""

from __future__ import annotations

import argparse
import hashlib
import os
from typing import List

import numpy as np

from ..io.video import native_available, write_video


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="musev_torch text2video")
    p.add_argument("--test_data_path", type=str, required=True,
                   help="task YAML/CSV (configs/tasks/example.yaml format)")
    p.add_argument("--output_dir", type=str, default="./output")
    p.add_argument("--model_name", type=str, default="musev",
                   choices=["musev", "musev_referencenet", "musev_referencenet_pose"])
    p.add_argument("--unet_checkpoint", type=str, default=None)
    p.add_argument("--sd_base_checkpoint", type=str, default=None)
    p.add_argument("--vae_checkpoint", type=str, default=None)
    p.add_argument("--text_checkpoint", type=str, default=None)
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--referencenet_checkpoint", type=str, default=None)
    p.add_argument("--clip_vision_checkpoint", type=str, default=None,
                   help="IP-Adapter image encoder (transformers "
                        "CLIPVisionModelWithProjection weights)")
    p.add_argument("--ip_adapter_checkpoint", type=str, default=None)
    p.add_argument("--ip_adapter_face_checkpoint", type=str, default=None,
                   help="not ported yet (ROADMAP queue 1, item 9)")
    p.add_argument("--controlnet_checkpoint", type=str, default=None)
    p.add_argument("--time_size", type=int, default=12)
    p.add_argument("--n_batch", type=int, default=1)
    p.add_argument("--fps", type=int, default=12)
    p.add_argument("--target_datas", type=str, default="all",
                   help="comma-separated task names, or 'all'")
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--img_length_ratio", type=float, default=1.0)
    p.add_argument("--n_vision_condition", type=int, default=1)
    p.add_argument("--noise_type", type=str, default="video_fusion")
    p.add_argument("--video_guidance_scale", type=float, default=3.5)
    p.add_argument("--video_guidance_scale_end", type=float, default=None)
    p.add_argument("--video_guidance_scale_method", type=str, default="linear")
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--guidance_rescale", type=float, default=0.0,
                   help="CFG rescale; values other than 0 are not ported yet")
    p.add_argument("--video_num_inference_steps", type=int, default=10)
    p.add_argument("--num_inference_steps", type=int, default=30)
    p.add_argument("--w_ind_noise", type=float, default=0.5)
    p.add_argument("--img_weight", type=float, default=1e-3)
    p.add_argument("--motion_speed", type=float, default=8.0)
    p.add_argument("--context_schedule", type=str, default="uniform_v2")
    p.add_argument("--context_frames", type=int, default=12)
    p.add_argument("--context_overlap", type=int, default=4)
    p.add_argument("--negative_prompt", type=str, default="V2")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--scheduler", type=str, default="euler")
    p.add_argument("--lora_path", action="append", default=None,
                   help="LoRA safetensors, repeatable; 'path' or 'path:scale'")
    p.add_argument("--textual_inversion", action="append", default=None,
                   help="textual-inversion embedding, repeatable; 'path' or "
                        "'path:trigger' (default trigger = file stem)")
    p.add_argument("--lcm_lora_path", type=str, default=None,
                   help="LCM-LoRA to fuse; implies --lcm")
    p.add_argument("--lcm", action="store_true",
                   help="use the LCM scheduler (with --lcm_lora_path fused)")
    p.add_argument("--face_det_onnx", type=str, default=None,
                   help="not ported yet (ROADMAP queue 1, item 12)")
    p.add_argument("--face_rec_onnx", type=str, default=None,
                   help="not ported yet (ROADMAP queue 1, item 12)")
    p.add_argument("--face_emb_norm", action="store_true")
    p.add_argument("--need_hist_match", action="store_true")
    p.add_argument("--redraw_condition_image", action="store_true",
                   help="img2img the condition image first; not ported yet")
    p.add_argument("--redraw_strength", type=float, default=0.75)
    p.add_argument("--fix_condition_images", action="store_true")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--dtype", type=str, default=None, choices=["float32", "bfloat16"],
                   help="default: bfloat16 on CUDA, float32 on the CPU; the CUDA "
                        "kernels take bfloat16 only")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch paths)")
    p.add_argument("--strict_checkpoints", action="store_true",
                   help="raise (instead of log) when a provided checkpoint "
                        "is missing or leaves required param sites at "
                        "random init (loader strict mode)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny random-weight model (smoke tests, no checkpoints)")
    p.add_argument("--parallel", type=str, default="none",
                   choices=["none", "fp", "dp"],
                   help="multi-device topology; only 'none' is ported "
                        "(ROADMAP queue 1, item 15)")
    return p.parse_args(argv)


def refuse_unported_flags(args, flags) -> None:
    """Raise NotImplementedError for the first of ``flags`` ((attribute,
    ROADMAP queue 1 item) pairs) that is set, and for ``--parallel``."""
    if args.parallel != "none":
        raise NotImplementedError(
            f"--parallel {args.parallel} is not ported to musev_torch yet "
            "(ROADMAP queue 1, item 15)")
    for attr, item in flags:
        if getattr(args, attr):
            raise NotImplementedError(
                f"--{attr} is not ported to musev_torch yet (ROADMAP queue 1, item {item})")


# flags that are not preset fields; the preset's unported slot (the FaceID
# IP-Adapter) is refused by the loader's ``refuse_unported``
_NOT_PORTED_FLAGS = (("face_det_onnx", 12), ("face_rec_onnx", 12))


def _torch_dtype(name):
    import torch

    return None if name is None else {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _load_image(path: str, height: int, width: int) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((width, height))
    return np.asarray(img)[None, None]  # (1, 1, H, W, 3)


def _round16(x: float) -> int:
    return max(16, int(round(x / 16)) * 16)


def _shrink_preset(preset):
    """Replace every branch config with a tiny variant (random-weight smoke
    runs on the CPU); the JAX CLI's ``_shrink_preset``."""
    import dataclasses

    from ..models.clip_text import CLIPTextConfig
    from ..models.clip_vision import CLIPVisionConfig
    from ..models.controlnet import ControlNetConfig
    from ..models.referencenet import ReferenceNetConfig
    from ..models.vae import VAEConfig

    small = dict(block_out_channels=(16, 16, 32, 32), layers_per_block=1,
                 cross_attention_dim=32, attention_heads=4, norm_num_groups=8)
    preset.unet_cfg = dataclasses.replace(preset.unet_cfg, **small, ip_adapter_dim=32)
    preset.vae_cfg = VAEConfig(block_out_channels=(16, 16, 32, 32),
                               layers_per_block=1, norm_num_groups=8)
    preset.text_cfg = CLIPTextConfig(vocab_size=1000, hidden_size=32,
                                     num_layers=2, num_heads=4,
                                     intermediate_size=64)
    if preset.referencenet_cfg is not None:
        preset.referencenet_cfg = ReferenceNetConfig(
            block_out_channels=(16, 16, 32, 32), layers_per_block=1,
            cross_attention_dim=32, attention_heads=4, norm_num_groups=8)
    if preset.clip_vision_cfg is not None:
        preset.clip_vision_cfg = CLIPVisionConfig(
            image_size=32, patch_size=8, hidden_size=32, num_layers=2,
            num_heads=4, intermediate_size=64, projection_dim=32)
        preset.ip_adapter_clip_dim = 32
    if preset.controlnet_cfg is not None:
        preset.controlnet_cfg = ControlNetConfig(
            block_out_channels=(16, 16, 32, 32),
            cond_embed_channels=(4, 8, 8, 8), layers_per_block=1,
            cross_attention_dim=32, attention_heads=4, norm_num_groups=8)
    return preset


def write_frames(out_path: str, frames: np.ndarray, fps: int) -> str:
    """An mp4 through the native library where it is available, else PNG
    frames in a directory named after the mp4; returns what was written."""
    if native_available():
        write_video(out_path, frames, fps=fps)
        return out_path
    from PIL import Image

    base = out_path[:-4]
    os.makedirs(base, exist_ok=True)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(f"{base}/{i:05d}.png")
    return base


def main(argv=None) -> List[str]:
    """Run every selected task; returns the paths written."""
    args = parse_args(argv)
    refuse_unported_flags(args, _NOT_PORTED_FLAGS)
    from ..autoprompt import generate_prompts
    from ..configs.model_registry import get_model_preset, resolve_negative_prompt
    from ..configs.tasks import load_tasks
    from ..pipelines.loader import build_models, refuse_unported
    from ..pipelines.pipeline import MusevPipeline
    from ..schedulers import create_scheduler

    scheduler = "lcm" if (args.lcm or args.lcm_lora_path) else args.scheduler
    create_scheduler(scheduler, 1)  # an unknown scheduler raises here
    preset = get_model_preset(
        args.model_name,
        unet_checkpoint=args.unet_checkpoint,
        sd_base_checkpoint=args.sd_base_checkpoint,
        vae_checkpoint=args.vae_checkpoint,
        text_checkpoint=args.text_checkpoint,
        tokenizer_path=args.tokenizer_path,
        referencenet_checkpoint=args.referencenet_checkpoint,
        clip_vision_checkpoint=args.clip_vision_checkpoint,
        ip_adapter_checkpoint=args.ip_adapter_checkpoint,
        ip_adapter_face_checkpoint=args.ip_adapter_face_checkpoint,
        controlnet_checkpoint=args.controlnet_checkpoint,
        lora_checkpoints=args.lora_path,
        textual_inversion_checkpoints=args.textual_inversion,
        lcm_lora_checkpoint=args.lcm_lora_path,
    )
    refuse_unported(preset)
    if args.tiny:
        preset = _shrink_preset(preset)
    tasks = generate_prompts(load_tasks(args.test_data_path))
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
        prompt = task["prompt"]
        ratio = float(task.get("img_length_ratio", args.img_length_ratio))
        height = _round16(int(task.get("height", args.height or 256)) * ratio)
        width = _round16(int(task.get("width", args.width or 256)) * ratio)
        seed = int(task.get("seed", args.seed if args.seed is not None else 0))
        negative = resolve_negative_prompt(task.get("video_negative_prompt", args.negative_prompt))

        cond_path = task.get("condition_images")
        cond = _load_image(cond_path, height, width) if cond_path else None
        refer_path = task.get("refer_image")
        refer = _load_image(refer_path, height, width)[:, 0] if refer_path else None
        ip_path = task.get("ipadapter_image")
        ip_img = _load_image(ip_path, height, width)[:, 0] if ip_path else None

        sig = hashlib.md5(prompt.encode()).hexdigest()[:4]
        out_name = (
            f"{args.model_name}_{name}_w={width}_h={height}_t={args.time_size}"
            f"_nb={args.n_batch}_s={seed}_p={sig}"
            f"_w={args.img_weight}_ms={args.motion_speed}"
            f"_g={args.video_guidance_scale}_wi={args.w_ind_noise}.mp4"
        )
        out_path = os.path.join(args.output_dir, out_name)
        if os.path.exists(out_path) and not args.overwrite:
            print(f"skip existing {out_path}")
            continue

        res = pipe.text2video(
            prompt,
            negative,
            height=height,
            width=width,
            video_length=args.time_size,
            n_batch=args.n_batch,
            n_vision_condition=args.n_vision_condition,
            condition_images=cond,
            fix_condition_images=args.fix_condition_images,
            video_num_inference_steps=args.video_num_inference_steps,
            num_inference_steps=args.num_inference_steps,
            video_guidance_scale=args.video_guidance_scale,
            video_guidance_scale_end=args.video_guidance_scale_end,
            video_guidance_scale_method=args.video_guidance_scale_method,
            guidance_scale=args.guidance_scale,
            guidance_rescale=args.guidance_rescale,
            context_schedule=args.context_schedule,
            context_frames=args.context_frames,
            context_overlap=args.context_overlap,
            noise_type=args.noise_type,
            w_ind_noise=args.w_ind_noise,
            img_weight=args.img_weight,
            motion_speed=args.motion_speed,
            seed=seed,
            refer_image=refer,
            ip_adapter_image=ip_img,
            need_hist_match=args.need_hist_match,
            redraw_condition_image=args.redraw_condition_image,
            redraw_strength=args.redraw_strength,
        )
        frames = (res.videos[0] * 255).astype(np.uint8)
        out_path = write_frames(out_path, frames, args.fps)
        written.append(out_path)
        print(f"wrote {out_path} ({frames.shape[0]} frames)")
    return written


if __name__ == "__main__":
    main()
