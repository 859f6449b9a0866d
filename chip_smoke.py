#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA device, nvcc and
PyTorch built for CUDA. Phases, each of which fails the script if it fails:

1. build: compile the port's five CUDA sources from ``musev_torch/csrc``
   (all nvcc at once, with ``-Xptxas -v``) and print the card's name and
   power limit, the registers, spills and any wgmma serialisation note of
   each flash, streaming and short-attention instance, the HGMMA and
   TMA-load (UTMALDG, and its multicast form) instructions in the two flash
   libraries' SASS, and the streaming kernel's plan per head dim (cluster
   size, clusters the card holds against its SMs); fails if a
   flash kernel has no HGMMA or UTMALDG, or the streaming kernel no
   multicast load (where ``cuobjdump`` is missing it says the check was not
   made);
2. kernels: at the paths' shapes (576^2, 24 frames, 12-frame windows
   overlapping by 4, one vision-condition frame, CFG: 78 frame rows, 8
   heads), on q/k/v laid out as the paths' projections lay them out, hold
   each kernel against its plain PyTorch version in bf16 (errors scaled to
   the size of the output) and time it beside the plain version and one
   PyTorch library call: ``flash_attention`` at every site, the split-merge
   route ``flash_attention_parts`` at every site whose KV the JAX package
   splits, ``flash_stream`` at every site of head dim <= 160, the short
   kernel at the temporal sites; the pivots (``pivot_rows`` without and
   with the GroupNorm apply, ``unpivot_rows``) at the temporal sites of the
   window batch and of the pose path, bit for bit (the GroupNorm apply
   within its rounding bound); the norms (K8 ``group_norm`` with and
   without SiLU and its statistics alone, K9 ``layer_norm``) at NORM_SITES
   against their composition run in float64, within one bf16 ulp plus
   2^-16 of the terms' magnitude, timed beside the plain composition (the
   route, the yardstick) and the library's call in bf16 where it computes
   the same function (``F.group_norm`` on the channels-first view of x for
   K8 without SiLU, ``F.layer_norm`` for K9); the bound is one bf16 read
   and one write of x. Each row has the CUDA-event time of the
   wrapper's call (``ms``) and the kernel's own device time per call
   (``device_ms``: torch.profiler's durations of the kernel, matched by
   name, over the timed calls; "not measured" unless the profiler recorded
   every launch), and both times of the library call (``library_ms``,
   ``library_device_ms``: every kernel the call launched);
3. path ``musev``: ``build_models("musev")`` at full width with random bf16
   weights, then ``MusevPipeline.text2video`` at 576x576, 24 frames, with the
   T2I first frame, at the default 10 video + 30 T2I steps; the kernels'
   launch counts are zeroed just before and read just after; a second run is
   profiled for device time by kernel;
   then phase ``cli``: the same clip from checkpoint files through the
   text2video CLI. A ``musev`` model drawn from seed 1 is written to
   disk (its UNet as ``.safetensors`` by this script's own writer, its VAE
   and text encoder by ``torch.save``), and the spatial sites of a seed-2
   UNet as the T2I base; ``musev_torch.cli.text2video.main`` runs a CSV
   task from them with ``--strict_checkpoints`` at the path's operating
   point and writes the clip (an mp4 through the native library, else PNG
   frames through PIL, as the printed line says). Fails
   unless the weights that ``build_models`` loads from those files are bit
   for bit the seeds' (temporal and VAE and text from seed 1, spatial from
   seed 2, bf16), the CLI wrote 25 frames (the condition frame and 24) of
   576x576 that equal ``MusevPipeline.text2video`` on the loaded models
   within the path's rerun spread, and the flash, short and pivot kernels
   launched in the CLI's run and (the wide d = 512 instance too) in the
   profile of the direct clip, which fails if it holds no launches; prints which optional packages import and whether the native
   video library builds;
   then phase ``adapters``, this slice's path, on phase ``cli``'s files:
   it writes a seeded rank-8 kohya LoRA (fp16) over every UNet attention
   projection and every CLIP text attention and MLP linear, an LCM-LoRA
   over the same UNet sites and a 2-vector ``badhandv4`` embedding (bf16),
   and drives the text2video CLI with ``--lcm_lora_path``, ``--lora_path
   <file>:0.8`` and ``--textual_inversion`` at the path's operating point
   with 4 video and 4 T2I steps (the default V2 negative prompt holds the
   trigger). The same adapters then go into a model loaded from the same
   files through ``MusevPipeline``'s ``load_textual_inversion``,
   ``load_lora`` and ``enable_lcm``. Fails unless the table's new rows are
   the file's bit for bit and bind the trigger, every fused weight is
   within one bf16 ulp of bf16(float32(W) + s * delta) computed on the CPU,
   the direct clip's frames equal the CLI's and its profiled rerun's bit
   for bit, and flash, the wide instance, K4, K6 and K7 launched. After
   ``unload_lora`` it prints the weights' drift from before the fuses in
   bf16 ulps, then runs one clip of each other sampler (``euler_ancestral``,
   ``ddim``, ``ddpm``, ``lcm``, ``dpmpp_2m``, and ``euler`` with
   ``s_churn`` 1) at the same operating point twice: finite, and the rerun
   bit for bit;
4. path ``musev_referencenet``: the same for image-to-video from a seeded
   random 576x576 condition image, which is also the ReferenceNet and
   IP-Adapter image, at the default 10 video steps;
5. path ``musev_referencenet_pose``: ``build_models`` at full width, then
   ``MusevPipeline.video2video`` of 24 seeded random 576x576 pose frames
   (``video_is_middle``) in 2 shots of 12, from a seeded random condition
   image (also the ReferenceNet and IP-Adapter image), 10 video steps; the
   ControlNet runs once per UNet call; a second run on zeroed pose frames
   must change the output; a third is profiled;
6. split: one full-width ``musev_referencenet`` UNet call under
   ``MUSEV_FLASH_LONGKV=split`` against the same call under ``carry``,
   beside the call's sensitivity to a 1e-3 perturbation of its input, at
   the path's weights and, for the gate, at weights drawn at N(0, 0.01);
7. reference: one UNet call of a narrow config on the card against the same
   weights in float32 on the CPU (the plain path), without and with the
   sparse-causal temporal mask and the spatial position embedding;
8. onnx, this slice's path: it writes seeded stand-in ONNX graphs at the
   published input and output shapes (``musev_torch.onnx.standins``:
   yolox_l, dw-ll_ucoco_384, SCRFD det_10g, ArcFace, the SAM encoder and
   decoder, a depth net; the real files are not in the repository), then
   (1) drives the video2video CLI on ``musev_referencenet_pose`` with
   ``--controlnet_name dwpose`` and the two dwpose graphs, its source 24
   seeded random 576x576 frames in memory, in 2 shots of 12 at 10 video
   steps with CFG, with PR 9's part (d) flags (``--record_mid_video
   --video_overlap 4 --need_hist_match --guidance_rescale 0.7``), once under
   the profiler: fails unless 25 frames were written, flash (its wide
   instance too), K4, K6 and K7 launched, the processor's maps equal the
   same processor's on the CPU executor in at least POSE_MAP_SHARE of the
   pixels, and the clip moves when the detector's table holds no person
   (a second run); it reports the dwpose seconds per frame (detector and
   pose apart, host and CUDA-event time); (2) extracts the face embedding
   of the seeded condition image with ``FaceEmbExtractor`` on the card,
   within cosine FACE_COS of the CPU executor's, which part (b) of phase 9
   takes; (3) runs ``SamAutomaticMaskProcessor`` (8 x 8 points),
   ``FaceDetectorProcessor`` and a depth ``OnnxImageProcessor`` on one
   frame each against the CPU executor; steps 1-3 also hold each graph's
   raw outputs, before the constant table that decides its boxes, peaks
   or masks, card against CPU on the same feeds within relative L2
   RAW_L2; (4) one full-width ``musev`` UNet
   call at the window batch's shapes with the sparse-causal mask (n_near
   1) and the spatial position embedding: finite, and moved from the same
   weights without them;
9. options, at the default operating point: (a) the
   ``musev_referencenet_pose`` preset's ``text2video`` with 1 + 24 seeded
   pose frames through the ControlNet, the seeded condition image redrawn
   (strength 0.75 of 30 steps), CFG rescale 0.7 and histogram matching:
   finite, bit for bit on a profiled rerun, moved by zeroed pose frames;
   (b) ``musev_referencenet`` with ``IPAdapterPlus`` (16 tokens) and FaceID,
   loaded by ``build_models(strict=True)`` from files the phase writes from
   a seed-3 donor (the UNet without its IP and face projections, a Plus
   file with the Resampler at the published shapes, a FaceID file), the
   loaded tensors bit for bit the donor's, the Resampler and the FaceID
   MLPProjModel on the card within relative L2 1e-2 of their float32 CPU
   plain versions, then image-to-video with phase onnx's extracted face
   embedding, moved when the embedding is zeroed; (c) ``musev`` serial
   denoise over 2 shots with the carries of 4 frames and every step's
   latents, at SERIAL_STEPS video steps: the recordings of the JAX shapes,
   finite frames. (PR 9's part (d), the video2video CLI with the serial
   denoise flags, is phase onnx's dwpose clip now.) Each part reports its
   clip seconds (for (b) and (c) those of its one profiled run), peak
   memory, launches by kernel and the device's busy share; its kernels
   must launch;
10. train, this slice's path: (1) the training route of attention
   (``ops.attention.mem_efficient_sdpa``: the flash kernel with its
   softmax stats forward, a q-chunked float32 backward) at the L0 self and
   ReferenceOnly cond sites of one clip of 13 frames, out and the grads of
   q, k and v in bf16 against autograd through the plain attention in
   float32 (relative L2 <= TOL_REL_L2), timed forward and forward +
   backward beside SDPA with autograd; the pivots under autograd against
   the plain path (K5, K7 and dx bit for bit, K6's dscale and dshift
   within float32 rounding); K4 under autograd (its kernel forward, a
   float32 recompute backward) at the L0 temporal site against autograd
   through its plain version in float32 (relative L2 <= TOL_REL_L2), timed
   beside it; (2) the ``musev`` UNet at full width (its
   parameters counted on the meta device) as float32 master weights,
   ``train_step_opt`` (AdamW, clipping, per-layer grad checkpointing) under
   bf16 autocast on one clip of 1 + 12 seeded latent frames of 72x72 and a
   seeded (1, 77, 768) text embedding, TRAIN_STEPS steps timed, a fourth
   profiled: fails unless every loss and grad is finite, the sampled master
   weights moved, flash with stats, K4, K6, K7, K8 (with SiLU, and its
   statistics for K6) and K9 launched in the steps and K5 in their
   backward, and no norm took its plain composition; prints the step times, peak memory and busy
   share; (3) the masters and the AdamW state saved with
   ``utils.checkpoint.save_state`` and restored: the step after the round
   trip must equal the step without it bit for bit (deterministic
   algorithms on for both); (4) one ``super_train_step`` on the
   ``musev_referencenet_pose`` bundle (UNet, ReferenceNet, IP projection,
   ControlNet; float32 masters, bf16 autocast) with 13 seeded control
   images of 576^2: every grad finite, every param the loss reaches (its
   grad is not None) with a nonzero grad and each module reached, and the
   sampled params after the step equal to p - lr * g bit for bit (the share
   that moved, and the share of the rest whose step is under half their
   float32 spacing, are printed); (5) a
   narrow UNet's loss and grads on the card under autocast against float32
   on the CPU, relative L2 < 5e-2;
11. serve: ``serve.app.OnlineInference.online_t2v_inference`` on the
   ``musev`` models, a request of 24 frames at 576^2 (two shots of 12):
   its frames must equal ``MusevPipeline.text2video`` called directly with
   the same arguments within the ``musev`` path's rerun spread, and the
   path's kernels must launch; then ``utils.inversion.ddim_inversion`` of
   the clip's latents over 10 steps with the UNet's noise prediction:
   finite;
12. parallel, this slice's path (one card, so no collective crosses GPUs):
   (1) the per-rank frame-parallel program (``unet3d_apply_fp`` with
   ``comm=StubComm(n)``, n = 2, 4, 8: one rank's rows, 40 / 20 / 10 of the
   window batch's 78, on this card) of the full-width
   ``musev`` UNet at 576^2 (3 windows of 12 + 1 frames, CFG, seeded bf16
   weights) beside the unsharded call: per n the median CUDA-event ms of 3
   calls after a warm-up, the busy share (one profiled call's kernel time
   over that median),
   the launches of one call by kernel and the flash calls by KV shape (K1:
   self-attention, K3: the ReferenceOnly concat KV), and
   ``fp_collective_model``'s payload bytes and collective calls per step
   (derived, not measured); fails unless every output is finite and of the
   full shape (its values are fakes at the collective points) and K1, K3,
   K4, K6 and K7 launched; (2) the real collectives over an NCCL process
   group of world size 1 (``RealComm``: the halo's ``batch_isend_irecv``
   from the rank to itself, ``all_to_all_single``, all-reduce,
   all-gather), with the UNet redrawn at N(0, 0.01) (see phase split):
   ``unet3d_apply_fp`` against ``unet3d_apply``, at the reference's
   temporal weights and with the temporal layers weighted 1 (98 % of the
   output), in float32 with float32 references for the kernels
   (``float32_references``) within relative L2 FP_FLOAT32_L2, and in bf16
   with the kernels, the program's relative L2 against the float32
   unsharded output at most 1 + FP_BF16_MARGIN times the bf16 unsharded
   call's own (the two bf16 outputs' relative L2 is printed beside 1e-2,
   which it does not meet: ``chip_fp_parity.py`` finds the two parting at
   the first temporal site, by the order of the GroupNorm statistics' sums,
   in every form of them it tries); ``predict_noise`` under ``dp_axis`` bit
   for bit; ``ring_attention`` at the L0 self site against
   ``flash_attention`` over the group (one step: no transfer), and
   ``ring_attention_local`` at n = 2, 4, 8 (every rank's K/V shards on this
   card: the ring's n steps of the K1s kernel and their merges, with no
   transfer), within the kernel tolerances above and with n^2 launches;
   the full-width VAE's frame-sharded decode of 25 frames bit for bit, the
   d = 512 wide kernel launched.

Prints the card line, a ``{"kernels": [...]}`` line, and last the line
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout, it
exits non-zero and prints no result. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import copy
import importlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# exp2 rate of the special-function units, 16 per clock per SM (Shah et al.,
# FlashAttention-3, 2024, section 3.1: 3.9 TFLOPS of exponentials on H100 SXM);
# one exp2 per logit is a floor beside the bound wherever d is below about 63
PEAK_EXP2 = 3.9e12

# (site, projection, B, H, sq, sk, d) in the (B, S, H, D) layout the kernel
# takes. The projection names the path's layout of q/k/v: "qkv" is one fused
# self-attention product (row stride 3*H*D), "q|kv" a query projection beside
# a fused k|v product (row stride 2*H*D: ReferenceOnly, the ReferenceNet fuse
# and cross-attention), "q|k|v" three separate linears (the VAE mid-block,
# the IP-Adapter branch, CLIP vision). The first seven are on both paths, the
# next four on the musev_referencenet path only, the last three on phase
# options' (IP-Adapter-Plus's 16 tokens and FaceID's at both branches, the
# published FaceID file's 4, the Resampler's 16 queries over 257 + 16 keys).
FLASH_SITES = [
    ("L0 ReferenceOnly cond half", "q|kv", 39, 8, 5184, 10368, 40),
    ("L0 self-attn / uncond half", "qkv", 39, 8, 5184, 5184, 40),
    ("L0 cross-attn (77 text tokens)", "q|kv", 78, 8, 5184, 77, 40),
    ("L1 ReferenceOnly cond half", "q|kv", 39, 8, 1296, 2592, 80),
    ("L2 ReferenceOnly cond half", "q|kv", 39, 8, 324, 648, 160),
    ("L3 mid ReferenceOnly cond half", "q|kv", 39, 8, 81, 162, 160),
    ("VAE mid-block (1 head, 16-frame segment)", "q|k|v", 16, 1, 5184, 5184, 512),
    ("L0 ReferenceNet fuse", "q|kv", 78, 8, 5184, 10368, 40),
    ("L1 ReferenceNet fuse", "q|kv", 78, 8, 1296, 2592, 80),
    ("L0 IP-Adapter branch (4 image tokens)", "q|k|v", 78, 8, 5184, 4, 40),
    ("CLIP vision ViT-H/14", "q|k|v", 1, 16, 257, 257, 80),
    ("L0 IP-Adapter-Plus / FaceID branch (16 tokens)", "q|k|v", 78, 8, 5184, 16, 40),
    ("L0 FaceID branch (4 face tokens)", "q|k|v", 78, 8, 5184, 4, 40),
    ("Resampler (16 queries, 257 + 16 keys)", "q|kv", 1, 12, 16, 273, 64),
]
LONGKV_HEAD = "L0 ReferenceNet fuse"  # the reported site of the long-KV designs
# (site, N, T, C, heads): temporal rows of 6 window-rows x h x w pixels
SHORT_SITES = [
    ("L0 temporal", 6 * 72 * 72, 13, 320, 8),
    ("L1 temporal", 6 * 36 * 36, 13, 640, 8),
    ("L2 temporal", 6 * 18 * 18, 13, 1280, 8),
    ("L3 temporal (mid)", 6 * 9 * 9, 13, 1280, 8),
]
# (site, b, T, HW, C): the temporal transformers' pivots, b = rows of the
# window batch (6) or of the pose path's one window per shot (2 CFG halves)
PIVOT_SITES = [
    ("L0 temporal", 6, 13, 72 * 72, 320),
    ("L1 temporal", 6, 13, 36 * 36, 640),
    ("L2 temporal", 6, 13, 18 * 18, 1280),
    ("L3 temporal (mid)", 6, 13, 9 * 9, 1280),
    ("pose L0 temporal", 2, 13, 72 * 72, 320),
]
POSE_HEAD = "pose L0 temporal"  # the reported site of the pivots
# (kernel, site, n, m, c, groups): K8 with SiLU at the L0 resnet (78 frame
# rows of 72^2 x 320), the temporal conv's video GroupNorm (6 window rows x
# 13 frames) and the VAE decode's 16-frame segment (576^2 x 128); without it
# at the L0 spatial transformer; its statistics alone (scale and shift for
# K6) at the L0 temporal transformer; K9 at the spatial transformers' rows
# (m = 1) of L0-L2 and CLIP text's; the first site of each is reported
NORM_SITES = [
    ("group_norm_silu", "L0 resnet", 78, 72 * 72, 320, 32),
    ("group_norm_silu", "L0 temporal conv", 6, 13 * 72 * 72, 320, 32),
    ("group_norm_silu", "VAE decode (16 frames)", 16, 576 * 576, 128, 32),
    ("group_norm", "L0 spatial transformer", 78, 72 * 72, 320, 32),
    ("group_norm_scale_shift", "L0 temporal transformer", 6, 13 * 72 * 72, 320, 32),
    ("layer_norm", "L0 spatial transformer", 78 * 72 * 72, 1, 320, None),
    ("layer_norm", "L1 spatial transformer", 78 * 36 * 36, 1, 640, None),
    ("layer_norm", "L2 spatial transformer", 78 * 18 * 18, 1, 1280, None),
    ("layer_norm", "CLIP text", 2 * 77, 1, 768, None),
]
NORM_SLACK = 2.0**-16  # of the terms' magnitude: float32 sums in another order
# the reference's default operating point (bench.py:48-57): no step cut needed
T2V_ARGS = dict(
    prompt="a girl dancing on the beach", negative_prompt="bad quality",
    height=576, width=576, video_length=24, n_batch=1, n_vision_condition=1,
    context_frames=12, context_overlap=4,
    video_num_inference_steps=10, num_inference_steps=30, seed=0,
)
# the reference's video2video defaults (predictor.py:760-1290): Pose2Video
# from 24 pose frames in shots of 12 (frames and condition image in main())
V2V_ARGS = dict(
    prompt="a girl dancing on the beach", negative_prompt="bad quality",
    video_is_middle=True, time_size=12, n_vision_condition=1, context_frames=12,
    context_overlap=4, video_num_inference_steps=10, video_guidance_scale=3.5,
    controlnet_conditioning_scale=1.0, seed=0,
)
VIDEO_SHAPE = (1, 25, 576, 576, 3)  # the JAX pipeline's: condition frame + 24
KERNELS = ("flash_attention", "flash_attention_parts", "flash_stream", "short_attention",
           "pivot_rows", "pivot_rows_gn", "unpivot_rows", "flash_attention_train",
           "group_norm", "group_norm_silu", "group_norm_scale_shift", "layer_norm")
# the norms' calls that took their plain composition (none on the paths)
NORM_PLAIN = ("group_norm_plain", "group_norm_scale_shift_plain", "layer_norm_plain")
# the CUDA functions each wrapper launches, as the profiler names them
FLASH_FUNCS = ("flash_fwd_wgmma_kernel", "flash_fwd_wide_kernel")
GN_FUNCS = ("gn_stats_kernel", "gn_finalize_kernel", "gn_apply_kernel")
DEVICE_FUNCS = dict(flash_attention=FLASH_FUNCS, flash_attention_parts=FLASH_FUNCS,
                    flash_stream=("flash_stream_kernel",), short_attention=("short_attn_kernel",),
                    pivot_rows=("relayout_kernel",), pivot_rows_gn=("relayout_kernel",),
                    unpivot_rows=("relayout_kernel",), flash_attention_train=FLASH_FUNCS,
                    group_norm=GN_FUNCS, group_norm_silu=GN_FUNCS,
                    group_norm_scale_shift=GN_FUNCS[:2], layer_norm=("ln_rows_kernel",))
STREAM_HEAD_DIMS = (40, 64, 80, 160)  # one per instance
# Kernel against plain version, both scaled to what is compared: the kernels
# round P and the output to bf16 (8-bit mantissa, relative rounding error up
# to 2^-9 ~ 2e-3 per element), the plain versions keep float32 throughout.
# A softmax scale a few percent off moves the output by several percent.
TOL_REL_L2 = 1e-2  # ||got - want|| / ||want||
TOL_MAX_RATIO = 2e-2  # max |got - want| / max |want|
PLAIN_LOGIT_BYTES = 2 << 30  # chunk the plain version's fp32 logits to 2 GiB
SPLIT_WEIGHT_SCALE = 0.01  # weights of the split check's UNet call (see phase_split)
# phase adapters: the clips' video and T2I steps, the LoRAs' rank, the
# embedding's trigger (in the V2 negative prompt), the other samplers
ADAPTER_STEPS = 4
LORA_RANK = 8
TRIGGER = "badhandv4"
SAMPLERS = (("euler_ancestral", {}), ("ddim", {}), ("ddpm", {}), ("lcm", {}), ("dpmpp_2m", {}),
            ("euler", {"s_churn": 1.0}))
# phase options: the serial-denoise part's video steps (cut from 10 to fit
# the script's time), the carries' overlap
SERIAL_STEPS = 5
OVERLAP = 4
# phase onnx: card against the CPU executor, float32 on both (the phase
# prints the TF32 flags; they were off on the card). Each stand-in graph's
# raw outputs, before its constant table is added, by relative L2: float32
# rounding in another summation order, compounded over a graph's layers,
# where TF32 would give about 1e-3 and a wrong op O(1). The processors'
# results: pose and SAM maps by the share of equal pixels (a rounding flip
# of one keypoint moves a few dozen pixels of a 576 x 576 map), the face
# embedding by cosine, the depth map (min-max normalised, uint8) in grey
# levels (a rounding flip moves a pixel by one)
RAW_L2 = 1e-4
POSE_MAP_SHARE = 0.9999
FACE_COS = 0.99999
SAM_SHARE = 0.9999
DEPTH_GREY = 1
# the UNet options of ROADMAP item 11, driven by phase onnx and phase reference
ITEM11_FLAGS = dict(temporal_self_attn_mask="sparse_causal", temporal_attn_n_near=1,
                    need_spatial_position_emb=True)
# phase train: the training attention at the L0 sites of one clip of 1 + 12
# frames (no CFG), the clip's latents, the AdamW steps taken and timed; the
# forward and backward of attention do about 3.5 times the forward's
# operations (the backward's five products against the forward's two)
TRAIN_ATTN_SITES = [
    ("L0 self-attn (training)", "qkv", 13, 8, 5184, 5184, 40),
    ("L0 ReferenceOnly cond half (training)", "q|kv", 13, 8, 5184, 10368, 40),
]
TRAIN_CLIP = (1, 13, 72, 72, 4)
TRAIN_STEPS = 3
TRAIN_FWD_BWD_OPS = 3.5
TRAIN_NARROW = dict(block_out_channels=(80, 160, 320, 320), layers_per_block=1,
                    cross_attention_dim=64, attention_heads=2, norm_num_groups=8)
# phase serve: the request's frames, the DDIM inversion's steps
SERVE_FRAMES = 24
INVERSION_STEPS = 10
# phase parallel: the stub ranks' counts, the timed calls after a warm-up,
# the window batch (3 windows x 2 CFG halves of 12 + 1 frames: 78 rows)
FP_STUB_DEVICES = (2, 4, 8)
FP_RUNS = 3
FP_WINDOWS = 3
# the NCCL-1 check of the frame-parallel program against the unsharded
# call: relative L2 in float32 (kernels replaced by float32 references),
# and in bf16 the program's error against the float32 unsharded call at
# most (1 + margin) times the unsharded bf16 call's own
FP_FLOAT32_L2 = 1e-4
FP_BF16_MARGIN = 0.05


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def compare(name: str, got, want) -> dict:
    """Errors of ``got`` against ``want``; fails past either tolerance."""
    want = want.float()
    diff = got.float() - want
    err = diff.abs().max().item()
    ratio = err / want.abs().max().item()
    rel_l2 = (diff.norm() / want.norm()).item()
    print(f"{name}: max abs err {err:.2e}, / max|want| {ratio:.2e} (tol {TOL_MAX_RATIO}), "
          f"relative L2 {rel_l2:.2e} (tol {TOL_REL_L2})")
    if not (ratio <= TOL_MAX_RATIO and rel_l2 <= TOL_REL_L2):
        fail(f"{name} disagrees with its plain version")
    return dict(max_abs_err=err, max_err_ratio=ratio, rel_l2=rel_l2)


def flash_inputs(torch, gen, proj: str, b: int, h: int, sq: int, sk: int, d: int):
    """Random bf16 q, k, v of (B, S, H, D) laid out as ``proj`` names."""
    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen, dtype=torch.bfloat16)

    c = h * d
    if proj == "qkv":
        assert sq == sk
        q, k, v = rand(b, sq, 3 * c).chunk(3, dim=-1)
    elif proj == "q|kv":
        q = rand(b, sq, c)
        k, v = rand(b, sk, 2 * c).chunk(2, dim=-1)
    else:
        q, k, v = rand(b, sq, c), rand(b, sk, c), rand(b, sk, c)
    return tuple(x.unflatten(-1, (h, d)) for x in (q, k, v))


def cuda_ms(torch, fn, warmup: int = 2, iters: int = 5) -> float:
    """Median CUDA-event time of ``fn`` in ms: the wrapper's whole call,
    its host work (allocation, checks, the launch) included."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn, funcs=None, per_call: int = 0, iters: int = 5, tries: int = 3):
    """Device time per call of ``fn`` in ms from torch.profiler: the summed
    durations of the CUDA functions named in ``funcs`` (of every kernel
    where None) over ``iters`` calls (after one unprofiled call), over
    ``iters``; and the launches recorded in each try. A try counts only if
    the profiler recorded ``per_call`` launches a call (where given, else a
    whole number a call); else the function is profiled again, and after
    ``tries`` tries the time is None (not measured), the last try's table
    printed."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = device_rows(torch, prof)
        hits = [r for r in rows if funcs is None or any(f in r[0] for f in funcs)]
        n = sum(r[2] for r in hits)
        seen.append(n)
        whole = n == iters * per_call if per_call else n > 0 and n % iters == 0
        if whole:
            return sum(r[1] for r in hits) / iters, seen
    print(f"device time not measured: {seen} launches recorded over {iters} calls of "
          f"{funcs or 'the library call'} (expected "
          f"{iters * per_call if per_call else f'a multiple of {iters}'}); the last try's "
          "kernels:")
    for name, ms, n in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"  {ms:9.3f} ms x{n:<5d} {name[:110]}")
    return None, seen


def timed(torch, name: str, fn, per_call: int = 1) -> dict:
    """``ms`` (CUDA events around the call: the wrapper's host work
    included) and ``device_ms`` (the kernel alone, ``per_call`` launches a
    call) of one wrapper's call, with ``device_records``, the launches the
    profiler recorded over 5 calls in each try."""
    dev, seen = device_ms(torch, fn, DEVICE_FUNCS[name], per_call)
    return dict(ms=cuda_ms(torch, fn), device_ms=dev, device_records=seen)


def library_timed(torch, fn) -> dict:
    """``library_ms`` and ``library_device_ms`` (every kernel it launches)
    of one PyTorch library call, or None for both where there is none."""
    if fn is None:
        return dict(library_ms=None, library_device_ms=None)
    dev, seen = device_ms(torch, fn)
    return dict(library_ms=cuda_ms(torch, fn), library_device_ms=dev,
                library_device_records=seen)


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.3f} ms"


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def kernel_counters():
    """Each kernel's (wrapper, launch-count attribute) by its name in the
    ``kernels`` line; ``pivot_rows`` counts K5 and K6 apart, and the flash
    kernel's launches with stats under autograd (the training route) are
    ``MemEfficientAttention``'s."""
    from musev_torch.ops.attention import MemEfficientAttention
    from musev_torch.ops.kernels.flash_attention import flash_attention, flash_attention_parts
    from musev_torch.ops.kernels.flash_stream import flash_stream
    from musev_torch.ops.kernels.norm import group_norm, group_norm_scale_shift, layer_norm
    from musev_torch.ops.kernels.pivot import pivot_rows, unpivot_rows
    from musev_torch.ops.kernels.short_attention import short_attention_packed

    return dict(zip(KERNELS + NORM_PLAIN, (
        (flash_attention, "launches"), (flash_attention_parts, "launches"),
        (flash_stream, "launches"), (short_attention_packed, "launches"),
        (pivot_rows, "launches"), (pivot_rows, "gn_launches"), (unpivot_rows, "launches"),
        (MemEfficientAttention, "launches"), (group_norm, "launches"),
        (group_norm, "silu_launches"), (group_norm_scale_shift, "launches"),
        (layer_norm, "launches"), (group_norm, "plain_calls"),
        (group_norm_scale_shift, "plain_calls"), (layer_norm, "plain_calls"))))


def zero_counts() -> None:
    for w, attr in kernel_counters().values():
        setattr(w, attr, 0)


def read_counts() -> dict:
    return {name: getattr(w, attr) for name, (w, attr) in kernel_counters().items()}


def ptxas_report(text: str) -> dict:
    """Registers, stack and spills per kernel from ``nvcc -Xptxas -v``
    output, keyed by the kernel's name and template arguments."""
    import re

    report, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            base = (re.search(r"(flash_fwd_\w+?_kernel)", mangled)
                    or re.search(r"\d([A-Za-z]\w*?_kernel)", mangled))
            args = re.findall(r"Li(\d+)E", mangled)
            name = f"{base.group(1) if base else mangled}<{','.join(args)}>"
            report[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            report[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[name]["registers"] = int(m.group(1))
    return report


def sass_counts(lib: Path) -> dict:
    """HGMMA, TMA-load (UTMALDG) and multicast TMA-load instructions per
    flash kernel in the SASS of a built library, or None where the toolkit
    has no cuobjdump."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            base = re.search(r"(flash_\w+?_kernel)", m.group(1))
            args = re.findall(r"Li(\d+)E", m.group(1))
            name = f"{base.group(1)}<{','.join(args)}>" if base else None
            if name:
                counts[name] = dict(HGMMA=0, UTMALDG=0, UTMALDG_MULTICAST=0)
        elif name:
            for op in ("HGMMA", "UTMALDG"):
                counts[name][op] += bool(re.search(rf"\b{op}\b", line))
            counts[name]["UTMALDG_MULTICAST"] += bool(re.search(r"\bUTMALDG\S*MULTICAST", line))
    return counts


def phase_build(torch):
    """Builds every source (all nvcc at once, with ``-Xptxas -v``); prints
    the card, each flash, streaming and short-attention instance's
    registers and spills and ptxas's warnings and notes from that build of
    the loaded libraries, the HGMMA and UTMALDG counts of both flash
    libraries' SASS, and the streaming kernel's plans; fails if a flash
    kernel lacks HGMMA or UTMALDG or the streaming kernel multicast."""
    from musev_torch.ops.kernels import _build
    from musev_torch.ops.kernels.flash_stream import plan

    t0 = time.time()
    outputs = _build.build(_build.SOURCES)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    regs = {}
    for source in ("flash_attention", "flash_stream", "short_attention"):
        ptxas_out = outputs.get(source)
        if ptxas_out is None:
            print(f"ptxas report not made: {source} was built before this run")
            continue
        regs.update(ptxas_report(ptxas_out))
        for line in ptxas_out.splitlines():  # warnings, and wgmma serialisation notes
            if "warning" in line.lower() or "Performance Loss" in line:
                print(f"ptxas {source}: {line.strip()[:200]}")
    for name, r in regs.items():
        print(f"ptxas {name}: {r}")
    sass = {}
    for source in ("flash_attention", "flash_stream"):
        counts = sass_counts(_build.library_path(source))
        if counts is None:
            print("SASS check not made: the toolkit has no cuobjdump")
            sass = None
            break
        for name, n in counts.items():
            print(f"SASS {name}: {n['HGMMA']} HGMMA, {n['UTMALDG']} UTMALDG "
                  f"({n['UTMALDG_MULTICAST']} multicast)")
        if not counts or any(n["HGMMA"] == 0 or n["UTMALDG"] == 0 for n in counts.values()):
            fail(f"a {source} kernel lacks HGMMA or UTMALDG instructions: {counts}")
        if source == "flash_stream" and any(n["UTMALDG_MULTICAST"] == 0
                                            for n in counts.values()):
            fail(f"a flash_stream kernel has no multicast TMA load: {counts}")
        sass.update(counts)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {}
    for d in STREAM_HEAD_DIMS:
        p = plans[d] = plan(d)
        print(f"flash_stream d={d}: cluster of {p['cluster_size']} CTAs x {p['rows_per_cta']} "
              f"rows; {p['active_clusters']} active clusters x {p['cluster_size']} = "
              f"{p['active_clusters'] * p['cluster_size']} of {sms} SMs")
    print(f"phase build: {time.time() - t0:.1f} s")
    return card, dict(ptxas=regs, sass=sass, stream_plans=plans, sms=sms)


def phase_kernels(torch):
    """Returns {kernel name: [row per site]}."""
    import torch.nn.functional as F

    from musev_torch.ops.attention import split_part
    from musev_torch.ops.kernels.flash_attention import (
        flash_attention,
        flash_attention_parts,
        flash_attention_plain,
    )
    from musev_torch.ops.kernels.flash_stream import MAX_HEAD_DIM as STREAM_MAX_D
    from musev_torch.ops.kernels.flash_stream import flash_stream
    from musev_torch.ops.kernels.short_attention import (
        short_attention_packed,
        short_attention_plain,
    )

    t0 = time.time()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {name: [] for name in KERNELS}
    floors = {}  # computed, not measured: kept out of the kernels line
    for site, proj, b, h, sq, sk, d in FLASH_SITES:
        q, k, v = flash_inputs(torch, gen, proj, b, h, sq, sk, d)
        chunk = max(1, min(b, PLAIN_LOGIT_BYTES // (h * sq * sk * 4)))
        want = flash_attention_plain(q[:chunk], k[:chunk], v[:chunk])

        def plain_all():
            for i in range(0, b, chunk):
                flash_attention_plain(q[i:i + chunk], k[i:i + chunk], v[i:i + chunk])

        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        plain_ms = cuda_ms(torch, plain_all, warmup=1, iters=3)
        lib = library_timed(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt))
        bms, by = bound_ms(4.0 * b * h * sq * sk * d, 2.0 * b * h * d * (2 * sq + 2 * sk))
        exp_ms = floors[site] = b * h * sq * sk / PEAK_EXP2 * 1e3  # one exp2 per logit
        part = split_part(sk, d)
        runs = [("flash_attention", lambda: flash_attention(q, k, v))]
        if part is not None:
            runs.append(("flash_attention_parts",
                         lambda: flash_attention_parts(q, k, v, part=part)))
        if d <= STREAM_MAX_D:
            runs.append(("flash_stream", lambda: flash_stream(q, k, v)))
        for name, fn in runs:
            errs = compare(f"{name} {site} ({proj})", fn()[:chunk], want)
            t = timed(torch, name, fn, -(-sk // part) if name == "flash_attention_parts" else 1)
            extra = dict(part=part, n_parts=-(-sk // part)) if name == "flash_attention_parts" \
                else {}
            rows[name].append(dict(site=site, projection=proj, shape=[b, h, sq, sk, d], **errs,
                                   **t, plain_ms=plain_ms, **lib,
                                   bound_ms=bms, bound_by=by, **extra))
            print(f"{name} {site} (B,H,sq,sk,d)={(b, h, sq, sk, d)}: {t['ms']:.3f} ms, "
                  f"device {fmt_ms(t['device_ms'])}, plain {plain_ms:.3f} ms, sdpa "
                  f"{lib['library_ms']:.3f} ms, device {fmt_ms(lib['library_device_ms'])}, "
                  f"bound {bms:.3f} ms ({by}), exp2 floor {exp_ms:.3f} ms")
        del q, k, v, qt, kt, vt, want
        torch.cuda.empty_cache()

    for site, n, t, c, heads in SHORT_SITES:
        qkv = torch.randn(n, t, 3 * c, device=dev, generator=gen, dtype=torch.bfloat16)
        q, k, v = qkv.chunk(3, dim=-1)  # the fused projection's views, as on the path
        out = short_attention_packed(q, k, v, heads)
        want = short_attention_plain(q, k, v, heads)
        errs = compare(f"short_attention {site}", out, want)
        qt, kt, vt = (x.unflatten(-1, (heads, -1)).transpose(1, 2) for x in (q, k, v))
        tm = timed(torch, "short_attention", lambda: short_attention_packed(q, k, v, heads))
        plain_ms = cuda_ms(torch, lambda: short_attention_plain(q, k, v, heads))
        lib = library_timed(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt))
        bms, by = bound_ms(4.0 * n * t * t * c, 2.0 * 4 * n * t * c)
        rows["short_attention"].append(dict(site=site, shape=[n, t, c, heads], **errs,
                                            **tm, plain_ms=plain_ms, **lib,
                                            bound_ms=bms, bound_by=by))
        print(f"short_attention {site} (N,T,C,heads)={(n, t, c, heads)}: {tm['ms']:.3f} ms, "
              f"device {fmt_ms(tm['device_ms'])}, plain {plain_ms:.3f} ms, sdpa "
              f"{lib['library_ms']:.3f} ms, device {fmt_ms(lib['library_device_ms'])}, "
              f"bound {bms:.3f} ms ({by})")
        del qkv, q, k, v, qt, kt, vt, out, want
    pivot_sites(torch, gen, rows)
    norm_sites(torch, gen, rows)
    print(f"phase kernels: {time.time() - t0:.1f} s")
    return rows, floors


def pivot_sites(torch, gen, rows: dict) -> None:
    """K5, K6 and K7 at PIVOT_SITES: x is the contiguous (b, T, HW, C) video
    and scale/shift the (b, C) GroupNorm affine broadcast over T, as the
    temporal transformer gives them; y the contiguous (b, HW, T, C) rows.
    K5 and K7 must match their plain versions bit for bit; K6 rounds its
    float32 product apart from the add where the plain version may fuse
    them, so it may differ by one bf16 ulp of the output plus one float32
    ulp of x * scale. The bound is bytes: x read and y written once (and
    scale, shift as (b, T, C) float32)."""
    from musev_torch.ops.kernels.pivot import (
        pivot_rows,
        pivot_rows_plain,
        unpivot_rows,
        unpivot_rows_plain,
    )

    def ulp(x, mantissa_bits):
        return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - mantissa_bits)

    for site, b, t, hw, c in PIVOT_SITES:
        x = torch.randn(b, t, hw, c, device="cuda", generator=gen, dtype=torch.bfloat16)
        y = torch.randn(b, hw, t, c, device="cuda", generator=gen, dtype=torch.bfloat16)
        scale, shift = (torch.randn(b, 1, c, device="cuda", generator=gen).expand(b, t, c)
                        for _ in range(2))
        nbytes = 2.0 * 2 * x.numel()
        cases = [
            ("pivot_rows", lambda: pivot_rows(x), lambda: pivot_rows_plain(x),
             lambda: x.transpose(1, 2).contiguous(), nbytes),
            ("pivot_rows_gn", lambda: pivot_rows(x, scale, shift),
             lambda: pivot_rows_plain(x, scale, shift), None, nbytes + 2.0 * 4 * b * t * c),
            ("unpivot_rows", lambda: unpivot_rows(y), lambda: unpivot_rows_plain(y),
             lambda: y.transpose(1, 2).contiguous(), nbytes),
        ]
        for name, fn, plain, lib, nb in cases:
            got, want = fn(), plain()
            err = (got.float() - want.float()).abs()
            if name == "pivot_rows_gn":
                product = (x.float() * scale[:, :, None]).transpose(1, 2)
                ok = bool((err <= ulp(want.float(), 7) + ulp(product, 23)).all())
                rule = "<= 1 bf16 ulp + 1 fp32 ulp of x*scale"
                del product
            else:
                ok = torch.equal(got, want)
                rule = "bit for bit"
            max_err = err.max().item()
            del got, want, err
            print(f"{name} {site}: max abs err {max_err:.2e} ({rule}: {'ok' if ok else 'FAILED'})")
            if not ok:
                fail(f"{name} disagrees with its plain version at {site}")
            tm, plain_ms = timed(torch, name, fn), cuda_ms(torch, plain)
            lt = library_timed(torch, lib)
            bms, by = bound_ms(0.0, nb)
            rows[name].append(dict(site=site, shape=[b, t, hw, c], max_abs_err=max_err, **tm,
                                   plain_ms=plain_ms, **lt, bound_ms=bms, bound_by=by))
            lib_txt = "none" if lib is None else (
                f"{lt['library_ms']:.3f} ms, device {fmt_ms(lt['library_device_ms'])}")
            print(f"{name} {site} (b,T,HW,C)={(b, t, hw, c)}: {tm['ms']:.3f} ms, device "
                  f"{fmt_ms(tm['device_ms'])}, plain {plain_ms:.3f} ms, "
                  f"transpose().contiguous() {lib_txt}, bound {bms:.3f} ms ({by})")
        del x, y, scale, shift


def norm_sites(torch, gen, rows: dict) -> None:
    """K8 and K9 at NORM_SITES on bf16 x of unit spread about 0.3 with bf16
    weights 1 + N(0, 0.5) and biases N(0, 0.5), as the wrapper takes them:
    within one bf16 ulp of their composition run in float64 on the same x,
    plus NORM_SLACK of the terms' magnitude (scale and shift within
    NORM_SLACK of theirs); timed beside the plain composition in bf16 (the
    route before the kernels) and the library's call in bf16 where it
    computes the same function: ``F.group_norm`` on the channels-first view
    of x (its own layout copy included) for K8 without SiLU,
    ``F.layer_norm`` for K9. The
    bound is bytes: x read once and written once in bf16 (read once for the
    statistics alone), so a two-pass GroupNorm reaches at most 67 %."""
    import torch.nn.functional as F

    from musev_torch.ops.kernels.norm import (
        group_norm,
        group_norm_plain,
        group_norm_scale_shift,
        group_norm_scale_shift_plain,
        layer_norm,
        layer_norm_plain,
    )

    def ulp(x, mantissa_bits):
        return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - mantissa_bits)

    for name, site, n, m, c, groups in NORM_SITES:
        x = (0.3 + torch.randn(n, m, c, device="cuda", generator=gen)).bfloat16()
        w = (1 + 0.5 * torch.randn(c, device="cuda", generator=gen)).bfloat16()
        b = (0.5 * torch.randn(c, device="cuda", generator=gen)).bfloat16()
        silu = name == "group_norm_silu"
        xd = x.double()
        if name == "layer_norm":
            fn = lambda: layer_norm(x, w, b)  # noqa: E731
            plain = lambda: layer_norm_plain(x, w, b)  # noqa: E731
            lib = lambda: F.layer_norm(x, (c,), w, b)  # noqa: E731
            want = F.layer_norm(xd, (c,), w.double(), b.double(), 1e-5)
            var, mean = torch.var_mean(xd, dim=-1, correction=0, keepdim=True)
            mag = (xd.abs() + mean.abs()) * torch.rsqrt(var + 1e-5) * w.double().abs() \
                + b.double().abs()
            nbytes, per_call = 2.0 * 2 * x.numel(), 1
        else:
            var, mean = torch.var_mean(xd.view(n, m, groups, -1), dim=(1, 3), correction=0)
            scale = (torch.rsqrt(var + 1e-5)[..., None] * w.double().view(groups, -1)).view(n, c)
            shift = b.double() - mean.repeat_interleave(c // groups, dim=1) * scale
            lib = None
            if name == "group_norm":
                lib = lambda: F.group_norm(x.permute(0, 2, 1), groups, w, b)  # noqa: E731
            if name == "group_norm_scale_shift":
                fn = lambda: group_norm_scale_shift(x, w, b, groups, 1e-5)  # noqa: E731
                plain = lambda: group_norm_scale_shift_plain(x, w, b, groups, 1e-5)  # noqa: E731
                nbytes, per_call = 2.0 * x.numel(), 2
            else:
                fn = lambda: group_norm(x, w, b, groups, 1e-5, silu=silu)  # noqa: E731
                plain = lambda: group_norm_plain(x, w, b, groups, 1e-5, silu=silu)  # noqa: E731
                want = xd * scale[:, None] + shift[:, None]
                want = F.silu(want) if silu else want
                terms = b.double().abs() + (b.double() - shift).abs()  # bias, mean * scale
                mag = xd.abs() * scale[:, None].abs() + terms[:, None]
                nbytes, per_call = 2.0 * 2 * x.numel(), 3
        got = fn()
        if name == "group_norm_scale_shift":
            ok = bool(((got[0] - scale).abs() <= NORM_SLACK * scale.abs()).all()
                      and ((got[1] - shift).abs()
                           <= NORM_SLACK * (b.double().abs() + (b.double() - shift).abs())).all())
            max_err = max((got[0] - scale).abs().max().item(), (got[1] - shift).abs().max().item())
            rule = "scale, shift within 2^-16"
        else:
            err = (got.double() - want).abs()
            ok = bool((err <= ulp(want, 7) + NORM_SLACK * mag).all())
            max_err = err.max().item()
            rule = "<= 1 bf16 ulp + 2^-16 of the terms"
            del want, mag, err
        del got, xd
        print(f"{name} {site}: max abs err {max_err:.2e} ({rule}: {'ok' if ok else 'FAILED'})")
        if not ok:
            fail(f"{name} disagrees with its plain version at {site}")
        tm, plain_ms = timed(torch, name, fn, per_call), cuda_ms(torch, plain)
        lt = library_timed(torch, lib)
        bms, by = bound_ms(0.0, nbytes)
        share = None if tm["device_ms"] is None else bms / tm["device_ms"]
        rows[name].append(dict(site=site, shape=[n, m, c], groups=groups, max_abs_err=max_err,
                               **tm, plain_ms=plain_ms, **lt, bound_ms=bms, bound_by=by,
                               share=share))
        lib_txt = "none" if lib is None else (
            f"{lt['library_ms']:.3f} ms, device {fmt_ms(lt['library_device_ms'])}")
        share_txt = "not measured" if share is None else f"{100 * share:.1f} %"
        print(f"{name} {site} (n,m,c)={(n, m, c)}: {tm['ms']:.3f} ms, device "
              f"{fmt_ms(tm['device_ms'])}, plain {plain_ms:.3f} ms, library {lib_txt}, "
              f"bound {bms:.3f} ms ({by}), share {share_txt}")
        del x, w, b
        torch.cuda.empty_cache()


def phase_path(torch, preset: str, method: str, args: dict, need: tuple):
    """``MusevPipeline.<method>`` of ``preset`` at full width; fails unless
    the video has the JAX pipeline's shape, is finite in [0, 1], every
    kernel in ``need`` launched, and no norm took its plain composition.
    Returns (record, models, result)."""
    import numpy as np

    from musev_torch.pipelines.loader import build_models
    from musev_torch.pipelines.pipeline import MusevPipeline

    t0 = time.time()
    models = build_models(preset, seed=0)
    torch.cuda.synchronize()
    t_build = time.time() - t0
    run = getattr(MusevPipeline(models), method)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t1 = time.time()
    res = run(**args)
    torch.cuda.synchronize()
    t_run = time.time() - t1
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    vid = res.videos
    print(f"phase path {preset}: build_models {t_build:.1f} s, {method} {t_run:.2f} s, "
          f"peak device memory {peak_gb:.1f} GB, launches {launches}, video {vid.shape}")
    if vid.shape != VIDEO_SHAPE:
        fail(f"{preset} {method} gave shape {vid.shape}, expected {VIDEO_SHAPE}")
    if not np.isfinite(vid).all() or vid.min() < 0.0 or vid.max() > 1.0:
        fail(f"{preset} {method} gave non-finite values or values outside [0, 1]")
    for name in need:
        if launches[name] <= 0:
            fail(f"the {preset} path launched {name} no time")
    if any(launches[name] for name in NORM_PLAIN):
        fail(f"the {preset} path ran a norm's plain composition: {launches}")
    profile, again = profile_path(torch, run, args)
    rerun_change = float(np.abs(again.latents - res.latents).max())
    rerun_frames = int(np.abs(to_uint8(again.videos).astype(np.int16) - to_uint8(res.videos)).max())
    print(f"phase path {preset}: the profiled rerun moves the latents by up to "
          f"{rerun_change:.3e} and the uint8 frames by up to {rerun_frames}")
    return dict(method=method, build_models_s=t_build, clip_s=t_run, peak_gb=peak_gb,
                launches=launches, rerun_latent_change=rerun_change,
                rerun_frame_change=rerun_frames, profile=profile), models, res


def to_uint8(videos):
    """The frames the CLIs write: the first video of (B, T, H, W, 3) in [0, 1]."""
    import numpy as np

    return (videos[0] * 255).astype(np.uint8)


def importable(name: str) -> bool:
    try:
        importlib.import_module(name)
    except ImportError:
        return False
    return True


def in_sd_base(key: str) -> bool:
    """Whether an SD1.5 base holds this ``musev`` UNet key: not the temporal
    layers, the frame embedding or ``transformer_in``."""
    return not any(s in key for s in ("temp_", "frame_embedding", "transformer_in"))


def drive_cli(torch, tmp: Path, out: str, files: dict, args: dict, need: tuple, phase: str,
              extra=()) -> dict:
    """``musev_torch.cli.text2video.main`` on a one-task CSV at the operating
    point ``args`` from the checkpoint ``files`` (``--strict_checkpoints``)
    plus the flags ``extra``, the kernels' counts zeroed just before; fails
    unless it wrote one clip of the path's frames and launched every kernel
    in ``need``. Returns the frames as written, the CLI's wall and clip
    seconds, the launch counts and the peak device memory."""
    import numpy as np

    from musev_torch.cli import text2video as cli
    from musev_torch.io.video import VideoReader, native_available
    from musev_torch.pipelines.pipeline import MusevPipeline

    (tmp / "tasks.csv").write_text(f"name,prompt\ncli,{args['prompt']}\n")
    argv = ["--test_data_path", str(tmp / "tasks.csv"), "--output_dir", str(tmp / out),
            "--strict_checkpoints", "--height", str(args["height"]),
            "--width", str(args["width"]), "--time_size", str(args["video_length"]),
            "--context_frames", str(args["context_frames"]),
            "--context_overlap", str(args["context_overlap"]),
            "--num_inference_steps", str(args["num_inference_steps"]),
            "--video_num_inference_steps", str(args["video_num_inference_steps"]),
            "--seed", str(args["seed"]), *extra]
    for slot, f in files.items():
        argv += [f"--{slot}", str(f)]
    kept, clip_s = {}, []
    real_write, real_t2v = cli.write_video, MusevPipeline.text2video

    def keep(path, frames, fps):  # the mp4 is lossy: hold the frames as written
        kept[path] = frames.copy()
        real_write(path, frames, fps=fps)

    def timed_t2v(self, *a, **k):
        t = time.time()
        out = real_t2v(self, *a, **k)
        torch.cuda.synchronize()
        clip_s.append(time.time() - t)
        return out

    cli.write_video, MusevPipeline.text2video = keep, timed_t2v
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    try:
        t1 = time.time()
        written = cli.main(argv)
        torch.cuda.synchronize()
        cli_s = time.time() - t1
    finally:
        cli.write_video, MusevPipeline.text2video = real_write, real_t2v
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    if len(written) != 1:
        fail(f"the CLI wrote {written}, not one clip")
    native = native_available()
    if native:
        with VideoReader(written[0]) as r:
            mp4 = (r.num_frames, r.height, r.width)
        frames = kept[written[0]]
    else:
        from PIL import Image

        pngs = sorted(Path(written[0]).glob("*.png"))
        frames = np.stack([np.asarray(Image.open(p)) for p in pngs])
        mp4 = None
    print(f"{phase}: CLI {cli_s:.1f} s (clip {clip_s[0]:.2f} s), peak device memory "
          f"{peak_gb:.1f} GB, wrote {Path(written[0]).name} "
          f"({'native mp4' if native else 'PNG frames through PIL'}), frames "
          f"{frames.shape}, mp4 read back (frames, H, W) {mp4}, launches {launches}")
    want_frames = (VIDEO_SHAPE[1], *VIDEO_SHAPE[2:])
    if frames.shape != want_frames or (mp4 is not None and mp4 != want_frames[:3]):
        fail(f"the CLI wrote frames {frames.shape} (mp4 {mp4}), expected {want_frames}")
    for name in need:
        if launches[name] <= 0:
            fail(f"the text2video CLI launched {name} no time")
    return dict(frames=frames, cli_s=cli_s, clip_s=clip_s[0], launches=launches,
                peak_gb=peak_gb)


def check_profile_launches(profile: dict, what: str) -> None:
    """Fails unless the profile recorded launches of flash, its wide d = 512
    instance, K4 and the pivots (one kernel name for K6 and K7)."""
    seen = profile.get("port_kernel_launches")
    if not seen:
        fail(f"the profile of {what} recorded no launches, so the wide d = 512 instance is "
             "unchecked")
    missed = [k for k in ("flash_fwd_wgmma_kernel", "flash_fwd_wide_kernel", "short_attn_kernel",
                          "relayout_kernel") if seen[k] <= 0]
    if missed:
        fail(f"{what} launched {missed} no time: {seen}")


def phase_cli(torch, tmp: Path, rerun_frames: int, need: tuple):
    """The text2video CLI at the path's operating point from checkpoint files
    written into ``tmp`` (see the module docstring); returns its record and
    the files, by preset field."""
    import numpy as np

    from musev_torch.configs.model_registry import get_model_preset, resolve_negative_prompt
    from musev_torch.io.video import native_available, native_error
    from musev_torch.pipelines.loader import build_models
    from musev_torch.pipelines.pipeline import MusevPipeline
    from musev_torch.utils.checkpoint import write_safetensors

    packages = {name: importable(name) for name in ("safetensors", "yaml", "PIL", "transformers")}
    native = native_available()
    print(f"phase cli: packages {packages}; native video library (make -C native) "
          f"{'built' if native else 'unavailable: ' + str(native_error())}")
    writer = "native mp4" if native else "PNG frames through PIL"
    t2v_args = dict(T2V_ARGS, negative_prompt=resolve_negative_prompt("V2"))
    files = dict(unet_checkpoint=tmp / "unet.safetensors", vae_checkpoint=tmp / "vae.pth",
                 text_checkpoint=tmp / "text.pth",
                 sd_base_checkpoint=tmp / "sd_base.safetensors")
    t0 = time.time()
    donor = build_models("musev", seed=1)
    write_safetensors(files["unet_checkpoint"], donor.unet.state_dict())
    for slot, module in (("vae_checkpoint", donor.vae), ("text_checkpoint", donor.text_encoder)):
        torch.save({k: v.contiguous().cpu() for k, v in module.state_dict().items()}, files[slot])
    del donor
    base = build_models("musev", seed=2).unet.state_dict()
    write_safetensors(files["sd_base_checkpoint"],
                      {k: v for k, v in base.items() if in_sd_base(k)})
    del base
    torch.cuda.empty_cache()
    write_s = time.time() - t0
    gb = {k: round(f.stat().st_size / 1e9, 3) for k, f in files.items()}
    print(f"phase cli: checkpoints written in {write_s:.1f} s, GB {gb}")

    run = drive_cli(torch, tmp, "out", files, T2V_ARGS, need, "phase cli")
    frames, launches = run["frames"], run["launches"]
    cli_s, clip_s, peak_gb = run["cli_s"], run["clip_s"], run["peak_gb"]

    t2 = time.time()
    preset = get_model_preset("musev", **{k: str(f) for k, f in files.items()})
    models = build_models(preset, strict=True)
    torch.cuda.synchronize()
    load_s = time.time() - t2
    profile, res = profile_path(torch, MusevPipeline(models).text2video, t2v_args)
    diff = int(np.abs(frames.astype(np.int16) - to_uint8(res.videos)).max())
    print(f"phase cli: load {load_s:.1f} s; frames against MusevPipeline.text2video on the "
          f"loaded models: max |diff| {diff} (the path's rerun spread {rerun_frames})")
    if diff > rerun_frames:
        fail(f"the CLI's frames differ from the direct call by {diff} > {rerun_frames}")
    check_profile_launches(profile, "the clip on the loaded models")

    # bit for bit: temporal sites, VAE and text from seed 1, spatial sites from seed 2
    loaded = {name: getattr(models, name).state_dict() for name in ("unet", "vae", "text_encoder")}
    wrong, n_checked = [], {1: 0, 2: 0}
    for seed in (1, 2):
        ref = build_models("musev", seed=seed)
        for name, sd in loaded.items():
            ref_sd = getattr(ref, name).state_dict()
            for k, v in sd.items():
                from_base = name == "unet" and in_sd_base(k)
                if (seed == 2) != from_base:
                    continue
                n_checked[seed] += 1
                if v.dtype != ref_sd[k].dtype or not torch.equal(v, ref_sd[k]):
                    wrong.append(f"{name}.{k}")
        del ref, ref_sd
    dtype = models.dtype
    del models, loaded
    torch.cuda.empty_cache()
    print(f"phase cli: loaded {dtype} tensors checked bit for bit: {n_checked[1]} against seed "
          f"1, {n_checked[2]} against seed 2; {len(wrong)} differ"
          f"{': ' + ', '.join(wrong[:5]) if wrong else ''}")
    if wrong:
        fail(f"the loaded weights differ from the seeds' at {len(wrong)} tensors")
    record = dict(packages=packages, native_video=native, video_writer=writer,
                  safetensors_writer="musev_torch.utils.checkpoint.write_safetensors",
                  checkpoint_gb=gb,
                  write_checkpoints_s=write_s, load_checkpoints_s=load_s, cli_s=cli_s,
                  clip_s=clip_s, peak_gb=peak_gb, launches=launches,
                  frames=list(frames.shape), max_frame_diff=diff, rerun_frame_change=rerun_frames,
                  tensors_checked=n_checked, dtype=str(dtype), profile=profile)
    print("phase cli: " + json.dumps({k: record[k] for k in (
        "write_checkpoints_s", "load_checkpoints_s", "cli_s", "clip_s", "peak_gb",
        "video_writer", "safetensors_writer", "max_frame_diff")}))
    return record, {k: str(f) for k, f in files.items()}


def lora_sites(unet, text_encoder):
    """The LoRA targets of phase adapters, as torch keys: every UNet attention
    projection (to_q/k/v/out, spatial and temporal) and every CLIP text
    attention and MLP linear."""
    import re

    from musev_torch.models.sd_weights import clip_text_key_map, unet3d_key_map

    params = dict(unet.named_parameters())
    unet_sites = [tk for tk, _, kind in unet3d_key_map(unet.cfg) if kind == "linear"
                  and re.search(r"\.attn[12]\.to_(q|k|v|out\.0)$", tk) and f"{tk}.weight" in params]
    text_sites = [tk for tk, _, kind in clip_text_key_map(text_encoder.cfg) if kind == "linear"]
    return unet_sites, text_sites


def kohya_lora(torch, targets, seed: int) -> dict:
    """A seeded rank-LORA_RANK kohya LoRA in float16 over ``targets``
    ((prefix, module, torch keys) triples), factors N(0, 0.02), alpha rank/2."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for prefix, module, sites in targets:
        for tk in sites:
            out, inn = module.get_parameter(f"{tk}.weight").shape
            key = prefix + tk.replace(".", "_")
            sd[f"{key}.lora_down.weight"] = (torch.randn(LORA_RANK, inn, generator=gen)
                                             * 0.02).half()
            sd[f"{key}.lora_up.weight"] = (torch.randn(out, LORA_RANK, generator=gen)
                                           * 0.02).half()
            sd[f"{key}.alpha"] = torch.tensor(LORA_RANK / 2, dtype=torch.float16)
    return sd


def bf16_ulps(torch, got, want, at=None):
    """|got - want| in units of the bf16 spacing at |at| (default ``want``;
    float32 tensors)."""
    mag = (want if at is None else at).abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return (got - want).abs() / (torch.finfo(torch.bfloat16).eps * torch.exp2(torch.floor(
        torch.log2(mag))))


def phase_adapters(torch, tmp: Path, files: dict, need: tuple) -> dict:
    """This slice's path: the LCM + LoRA + textual-inversion clip through the
    text2video CLI, then the same adapters by ``MusevPipeline``'s methods
    (each fuse against its plain version on the CPU), every other sampler
    and the unfuse (see the module docstring). Returns its record."""
    import numpy as np

    from musev_torch.configs.model_registry import get_model_preset, resolve_negative_prompt
    from musev_torch.models.sd_weights import load_safetensors
    from musev_torch.pipelines.loader import build_models
    from musev_torch.pipelines.pipeline import MusevPipeline
    from musev_torch.utils.checkpoint import write_safetensors

    args = dict(T2V_ARGS, video_num_inference_steps=ADAPTER_STEPS,
                num_inference_steps=ADAPTER_STEPS, negative_prompt=resolve_negative_prompt("V2"))
    plain = build_models(get_model_preset("musev", **files), strict=True)
    unet_sites, text_sites = lora_sites(plain.unet, plain.text_encoder)
    unet_targets = ("lora_unet_", plain.unet, unet_sites)
    t0 = time.time()
    adapters = dict(lora=tmp / "style.safetensors", lcm=tmp / "lcm_lora.safetensors",
                    ti=tmp / f"{TRIGGER}.safetensors")
    write_safetensors(adapters["lora"], kohya_lora(
        torch, [unet_targets, ("lora_te_", plain.text_encoder, text_sites)], seed=11))
    write_safetensors(adapters["lcm"], kohya_lora(torch, [unet_targets], seed=12))
    emb = (torch.randn(2, plain.text_encoder.cfg.hidden_size,
                       generator=torch.Generator().manual_seed(13)) * 0.02).to(torch.bfloat16)
    write_safetensors(adapters["ti"], {"emb_params": emb})
    write_s = time.time() - t0
    print(f"phase adapters: LoRA over {len(unet_sites)} UNet attention projections and "
          f"{len(text_sites)} CLIP linears, LCM-LoRA over the same UNet sites (rank {LORA_RANK}, "
          f"kohya, fp16), a 2-vector {TRIGGER!r} embedding (bf16); written in {write_s:.1f} s")

    # 1. the slice's path through the CLI: --lcm_lora_path selects the lcm sampler
    run = drive_cli(torch, tmp, "out_adapters", files, args, need, "phase adapters", extra=(
        "--lcm_lora_path", str(adapters["lcm"]), "--lora_path", f"{adapters['lora']}:0.8",
        "--textual_inversion", str(adapters["ti"])))

    # 2. the same adapters through the pipeline's methods, each fuse against
    # bf16(float32(W) + s * delta) with the delta computed on the CPU
    snap_keys = [("unet", tk) for tk in unet_sites] + [("text_encoder", tk) for tk in text_sites]

    def snapshot():
        return {(m, tk): getattr(plain, m).get_parameter(f"{tk}.weight").detach().to(
            "cpu", torch.float32, copy=True) for m, tk in snap_keys}

    original = snapshot()
    states = [original]  # the LoRA-touched weights before, between and after the fuses
    pipe = MusevPipeline(plain)
    pipe.load_textual_inversion(str(adapters["ti"]))
    table = plain.text_encoder.text_model.embeddings.token_embedding.weight
    vocab = plain.text_encoder.cfg.vocab_size
    ti_equal = bool(torch.equal(table[vocab:].cpu(), emb))
    bound = plain.tokenizer.encode(args["negative_prompt"])
    print(f"phase adapters: embedding rows {tuple(table[vocab:].shape)} equal the file's bit for "
          f"bit: {ti_equal}; the negative prompt's ids hold the trigger's "
          f"{[i for i in bound if i >= vocab]}")
    if not ti_equal or [vocab, vocab + 1] != [i for i in bound if i >= vocab][:2]:
        fail("the textual inversion did not append the file's rows or bind its trigger")
    fuse = {}
    for name, scale, prefixes in (("lora", 0.8, {"unet": "lora_unet_",
                                                  "text_encoder": "lora_te_"}),
                                  ("lcm", 1.0, {"unet": "lora_unet_"})):
        before = snapshot()
        torch.cuda.synchronize()
        t1 = time.time()
        if name == "lora":
            pipe.load_lora(str(adapters[name]), scale)
        else:
            pipe.enable_lcm(str(adapters[name]), scale)
        torch.cuda.synchronize()
        fuse_s = time.time() - t1
        sd = load_safetensors(str(adapters[name]))
        after = snapshot()
        worst, n_off, n_el = 0.0, 0, 0
        for (m, tk), w0 in before.items():
            if m not in prefixes:
                if not torch.equal(after[(m, tk)], w0):
                    fail(f"the {name} fuse changed {m}.{tk}, which it does not name")
                continue
            key = prefixes[m] + tk.replace(".", "_")
            down = sd[f"{key}.lora_down.weight"].float()
            delta = float(sd[f"{key}.alpha"]) / down.shape[0] * (
                sd[f"{key}.lora_up.weight"].float() @ down)
            want = (w0 + scale * delta).to(plain.dtype).float()
            ulps = bf16_ulps(torch, after[(m, tk)], want)
            worst = max(worst, float(ulps.max()))
            n_off += int((ulps > 0).sum())
            n_el += want.numel()
        fuse[name] = dict(seconds=fuse_s, elements=n_el, off_by_one_ulp=n_off, worst_ulps=worst)
        states.append(after)
        print(f"phase adapters: {name} fuse {fuse_s:.3f} s over {n_el} weights; against the CPU's "
              f"bf16(float32(W) + {scale} * delta): {n_off} differ, by at most {worst:.0f} ulp")
        if worst > 1:
            fail(f"the {name} fuse is {worst} bf16 ulps from its plain version (limit 1)")

    zero_counts()
    t2 = time.time()
    res = pipe.text2video(**args)
    torch.cuda.synchronize()
    direct_s = time.time() - t2
    direct_launches = read_counts()
    diff = int(np.abs(run["frames"].astype(np.int16) - to_uint8(res.videos)).max())
    profile, again = profile_path(torch, pipe.text2video, args)
    rerun = int(np.abs(to_uint8(again.videos).astype(np.int16) - to_uint8(res.videos)).max())
    print(f"phase adapters: direct clip {direct_s:.2f} s, launches {direct_launches}; frames "
          f"against the CLI's max |diff| {diff}; the profiled rerun moves the frames by up to "
          f"{rerun}")
    if diff or rerun:
        fail(f"the direct clip differs from the CLI's by {diff} or from its rerun by {rerun}")
    check_profile_launches(profile, "the direct LCM + LoRA + TI clip")
    for name in ("flash_attention", "short_attention", "pivot_rows_gn", "unpivot_rows"):
        if direct_launches[name] <= 0:
            fail(f"the direct LCM + LoRA + TI clip launched {name} no time")

    # 3. every other sampler on the card (the adapters unfused, the embedding kept)
    t3 = time.time()
    pipe.unload_lora()
    torch.cuda.synchronize()
    unfuse_s = time.time() - t3
    states.append(snapshot())
    # the drift in bf16 ulps at the largest magnitude the weight took, since
    # each of the four roundings (two fuses, two unfuses) is half an ulp at the
    # weight's magnitude at that point (in ulps of the weight before, a weight
    # near 0 that the fuses made large drifts without bound), and absolute
    drift = {}
    for m in ("unet", "text_encoder"):
        keys = [k for k in original if k[0] == m]
        drift[m] = dict(
            ulps_at_peak=max(float(bf16_ulps(torch, states[-1][k], original[k], torch.stack(
                [st[k].abs() for st in states]).amax(0)).max()) for k in keys),
            max_abs=max(float((states[-1][k] - original[k]).abs().max()) for k in keys))
    changed = sum(int((states[-1][k] != w0).sum()) for k, w0 in original.items())
    n_total = sum(w0.numel() for w0 in original.values())
    print(f"phase adapters: unload_lora {unfuse_s:.3f} s; {changed} of {n_total} weights differ "
          f"from before the fuses; the largest drift, in bf16 ulps at the largest magnitude "
          f"the weight took and absolute: {drift}")
    samplers = {}
    for name, kw in SAMPLERS:
        spipe = MusevPipeline(plain, scheduler_name=name, scheduler_kwargs=kw)
        t4 = time.time()
        first = spipe.text2video(**args)
        torch.cuda.synchronize()
        clip_s = time.time() - t4
        second = spipe.text2video(**args)
        same = bool(np.array_equal(first.latents, second.latents)
                    and np.array_equal(first.videos, second.videos))
        finite = bool(np.isfinite(first.latents).all() and np.isfinite(first.videos).all())
        label = name + ("" if not kw else f" {kw}")
        samplers[label] = dict(clip_s=clip_s, rerun_bit_for_bit=same, finite=finite)
        print(f"phase adapters: sampler {label}: clip {clip_s:.2f} s, finite {finite}, rerun bit "
              f"for bit {same}, video {first.videos.shape}")
        if not (same and finite) or first.videos.shape != VIDEO_SHAPE:
            fail(f"sampler {label}: finite {finite}, rerun bit for bit {same}, "
                 f"shape {first.videos.shape}")
    del pipe, spipe, plain, res, again, first, second, states, original
    torch.cuda.empty_cache()
    record = dict(steps=ADAPTER_STEPS, lora_rank=LORA_RANK, unet_sites=len(unet_sites),
                  text_sites=len(text_sites), write_adapters_s=write_s, cli_s=run["cli_s"],
                  clip_s=run["clip_s"], peak_gb=run["peak_gb"], launches=run["launches"],
                  direct_clip_s=direct_s, direct_launches=direct_launches, fuse=fuse,
                  ti_rows_bit_for_bit=ti_equal, max_frame_diff=diff, rerun_frame_change=rerun,
                  unfuse_s=unfuse_s, unfuse_changed=changed, unfuse_weights=n_total,
                  unfuse_drift_ulps=drift, samplers=samplers, profile=profile)
    print("phase adapters: " + json.dumps({k: record[k] for k in (
        "cli_s", "clip_s", "peak_gb", "direct_clip_s", "fuse", "unfuse_drift_ulps")}))
    return record


def phase_pose_control(torch, models, args: dict, res, rerun_change: float) -> float:
    """The pose path again on zeroed pose frames: fails unless the latents
    move by more than 1e-3 and by more than ten times the same run's rerun
    difference, so that the ControlNet acts. Returns the largest change."""
    import numpy as np

    from musev_torch.pipelines.pipeline import MusevPipeline

    t0 = time.time()
    zeroed = MusevPipeline(models).video2video(
        **dict(args, video_frames=np.zeros_like(args["video_frames"])))
    change = float(np.abs(zeroed.latents - res.latents).max())
    floor = max(1e-3, 10 * rerun_change)
    print(f"phase pose control: zeroed pose frames move the latents by up to {change:.3e} "
          f"(must exceed {floor:.3e}), {time.time() - t0:.1f} s")
    if not change > floor:
        fail("zeroing the pose frames left the video2video output unchanged")
    return change


def device_rows(torch, prof):
    """(kernel name, summed device ms, launches) of every device event the
    profiler recorded, read from its kineto events directly:
    ``key_averages()`` builds Python objects for every event first, which
    took 22-23 s of host time after each profiled clip. Every device time
    in the script is read here."""
    results = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if results is None:
        fail("torch.profiler kept no kineto results: device time cannot be read")
    ms, count = {}, {}
    for e in results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        d = e.duration_ns() / 1e6
        if d > 0:
            ms[e.name()] = ms.get(e.name(), 0.0) + d
            count[e.name()] = count.get(e.name(), 0) + 1
    return [(k, ms[k], count[k]) for k in ms]


def profile_path(torch, run, args):
    """The path once more under torch.profiler: device time by kernel and
    the device's busy share of the wall time (single stream, no overlap).
    Returns (record, the run's result)."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.time()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = run(**args)
        torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    t1 = time.time()
    rows = sorted(device_rows(torch, prof), key=lambda r: -r[1])
    tabulate_s = time.time() - t1
    busy_ms = sum(r[1] for r in rows)
    if busy_ms == 0:
        print("phase path profile: the profiler recorded no device time (not measured)")
        return dict(wall_ms=wall_ms, device_ms=None), res
    print(f"phase path profile: wall {wall_ms:.0f} ms (profiled), device busy "
          f"{busy_ms:.0f} ms = {busy_ms / wall_ms:.1%}, tabulated in {tabulate_s:.2f} s; "
          "top kernels:")
    for key, ms, n in rows[:12]:
        print(f"  {ms:9.1f} ms {ms / busy_ms:6.1%} x{n:<6d} {key[:110]}")
    names = ("flash_fwd_wgmma_kernel", "flash_fwd_wide_kernel", "flash_stream_kernel",
             "short_attn_kernel", "relayout_kernel")
    mine = {name: sum(r[1] for r in rows if name in r[0]) for name in names}
    calls = {name: sum(r[2] for r in rows if name in r[0]) for name in names}
    print(f"  port kernels: ms {mine}, launches {calls}")
    return dict(wall_ms=wall_ms, device_ms=busy_ms, tabulate_s=tabulate_s, port_kernels_ms=mine,
                port_kernel_launches=calls,
                top=[dict(kernel=k, ms=ms, count=n) for k, ms, n in rows[:25]]), res


def phase_split(torch, models) -> dict:
    """One full-width musev_referencenet UNet call (78 frame rows of 72x72
    latents, ReferenceNet embeddings of one reference image, 4 IP tokens)
    under MUSEV_FLASH_LONGKV=split against the same call under carry: only
    the 8 long-KV sites (L0 ReferenceOnly cond half, L0 fuse) differ.

    Each comparison is printed beside the call's sensitivity floor: the
    same call under carry with its input perturbed by 1e-3 N(0, 1). At the
    path's N(0, 0.02) weights the random full-width UNet is chaotic (the
    floor is about 1e-1, above any tolerance a bf16 kernel change can be
    held to), so the gate is taken with the UNet and ReferenceNet redrawn
    at N(0, 0.01)."""
    from musev_torch.models.referencenet import referencenet_apply
    from musev_torch.models.unet3d import unet3d_apply
    from musev_torch.pipelines.loader import init_random_

    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(2)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen, dtype=torch.bfloat16)

    rows = 6  # 3 windows x 2 CFG halves
    sample, cond = rand(rows, 12, 72, 72, 4), rand(rows, 1, 72, 72, 4)
    text, clip = rand(rows, 77, 768), rand(rows, 4, 768)
    noise = rand(rows, 12, 72, 72, 4)
    ref_latent, ref_ctx = rand(1, 72, 72, 4), rand(1, 4, 768)
    record = {}
    for scale in (0.02, SPLIT_WEIGHT_SCALE):
        if scale != 0.02:  # the path's models were drawn at N(0, 0.02)
            for module in (models.unet, models.referencenet):
                init_random_(module, gen, scale=scale)
        with torch.inference_mode():
            down, mid = referencenet_apply(models.referencenet, ref_latent, 0.0, ref_ctx)
            kw = dict(condition_latents=cond, gen_index=tuple(range(1, 13)), cond_index=(0,),
                      do_cfg=True,
                      down_block_refer_embs=[e.expand(rows, *e.shape[1:]) for e in down],
                      mid_block_refer_emb=mid.expand(rows, *mid.shape[1:]), vision_clip_emb=clip)
            out, ms, launches = {}, {}, {}
            for impl, x in (("carry", sample), ("split", sample),
                            ("carry, input + 1e-3 noise", sample + 1e-3 * noise)):
                os.environ["MUSEV_FLASH_LONGKV"] = impl.split(",")[0]
                zero_counts()
                t1 = time.time()
                out[impl] = unet3d_apply(models.unet, x, 500.0, text, **kw).float()
                torch.cuda.synchronize()
                ms[impl] = (time.time() - t1) * 1e3
                launches[impl] = read_counts()
            os.environ.pop("MUSEV_FLASH_LONGKV")

        def rel(key):
            return ((out[key] - out["carry"]).norm() / out["carry"].norm()).item()

        err, floor = rel("split"), rel("carry, input + 1e-3 noise")
        finite = bool(torch.isfinite(out["split"]).all())
        record[f"N(0, {scale})"] = dict(relative_l2=err, sensitivity_floor=floor,
                                        finite=finite, ms=ms, launches=launches)
        print(f"phase split, weights N(0, {scale}): UNet call carry {ms['carry']:.0f} ms, "
              f"split {ms['split']:.0f} ms (host clock), relative L2 split vs carry "
              f"{err:.2e}, sensitivity floor (carry, input + 1e-3 noise) {floor:.2e}; "
              f"launches carry {launches['carry']}, split {launches['split']}")
    gate = record[f"N(0, {SPLIT_WEIGHT_SCALE})"]
    print(f"phase split: gate at N(0, {SPLIT_WEIGHT_SCALE}) relative L2 "
          f"{gate['relative_l2']:.2e} (tol 5e-2), {time.time() - t0:.1f} s")
    if not (gate["finite"] and gate["relative_l2"] <= 5e-2):
        fail(f"the split route disagrees with carry on the UNet call: {gate['relative_l2']}")
    if gate["launches"]["split"]["flash_attention_parts"] <= 0:
        fail("the split UNet call launched the stats kernel no time")
    return record


def timed_run(torch, fn):
    """``fn()`` with the kernels' counts zeroed just before and the peak
    device memory reset: (result, seconds, launches, peak GB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.time()
    res = fn()
    torch.cuda.synchronize()
    return res, time.time() - t0, read_counts(), torch.cuda.max_memory_allocated() / 1e9


def check_clip(res, what: str, need: tuple, launches: dict, shape=None) -> None:
    """Fails unless the clip has ``shape`` (default the path's), is finite in
    [0, 1] with finite latents, and every kernel in ``need`` launched."""
    import numpy as np

    shape = shape or VIDEO_SHAPE
    vid = res.videos
    if vid.shape != shape:
        fail(f"{what} gave shape {vid.shape}, expected {shape}")
    finite = np.isfinite(vid).all() and np.isfinite(res.latents).all()
    if not finite or vid.min() < 0.0 or vid.max() > 1.0:
        fail(f"{what} gave non-finite values or values outside [0, 1]")
    for name in need:
        if launches[name] <= 0:
            fail(f"{what} launched {name} no time")


def part_record(clip_s, launches, peak_gb, profile, **extra) -> dict:
    busy = profile.get("device_ms")
    share = None if busy is None else busy / profile["wall_ms"]
    return dict(clip_s=clip_s, peak_gb=peak_gb, launches=launches, busy_share=share,
                profile=profile, **extra)


def profiled_part(torch, run, args):
    """``run(**args)`` once under torch.profiler with the kernels' counts
    zeroed just before: (result, profile, seconds of the profiled run, not
    of the profile's tabulation after it, launches, peak GB)."""
    (profile, res), _, launches, peak_gb = timed_run(torch, lambda: profile_path(torch, run, args))
    return res, profile, profile["wall_ms"] / 1e3, launches, peak_gb


def option_controlnet(torch, image, pose, need) -> dict:
    """Part (a): ControlNet text2video with the redraw, rescale and
    histogram matching; bit for bit on the profiled rerun, moved by zeroed
    pose frames."""
    import numpy as np

    from musev_torch.pipelines.loader import build_models
    from musev_torch.pipelines.pipeline import MusevPipeline

    pipe = MusevPipeline(build_models("musev_referencenet_pose", seed=0))
    args = dict(T2V_ARGS, condition_images=image, control_images=pose,
                redraw_condition_image=True, redraw_strength=0.75, guidance_rescale=0.7,
                need_hist_match=True)
    res, clip_s, launches, peak_gb = timed_run(torch, lambda: pipe.text2video(**args))
    check_clip(res, "the ControlNet text2video", need, launches)
    profile, again = profile_path(torch, pipe.text2video, args)
    same = bool(np.array_equal(again.latents, res.latents)
                and np.array_equal(again.videos, res.videos))
    zeroed = pipe.text2video(**dict(args, control_images=np.zeros_like(pose)))
    change = float(np.abs(zeroed.latents - res.latents).max())
    print(f"phase options (a) ControlNet text2video: clip {clip_s:.2f} s, peak {peak_gb:.1f} GB, "
          f"launches {launches}; rerun bit for bit {same}; zeroed pose frames move the latents "
          f"by up to {change:.3e}")
    if not same or not change > 1e-3:
        fail(f"the ControlNet text2video: rerun bit for bit {same}, zeroed-pose change {change}")
    del pipe
    torch.cuda.empty_cache()
    return part_record(clip_s, launches, peak_gb, profile, rerun_bit_for_bit=same,
                       zeroed_pose_latent_change=change)


def rel_l2(torch, got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return ((got - want).norm() / want.norm()).item()


def option_ip_plus(torch, tmp: Path, image, face_emb, need) -> dict:
    """Part (b): IP-Adapter-Plus and FaceID from files written from a donor,
    loaded strictly; the projections against their float32 CPU plain
    versions; image-to-video with a face embedding (run under the
    profiler), moved when it is zeroed."""
    import numpy as np

    from musev_torch.cli.text2video import enable_face
    from musev_torch.configs.model_registry import get_model_preset
    from musev_torch.models.clip_vision import clip_vision_encode, preprocess_clip_image
    from musev_torch.models.sd_weights import ip_adapter_site_paths
    from musev_torch.pipelines.loader import build_models
    from musev_torch.pipelines.pipeline import MusevPipeline
    from musev_torch.utils.checkpoint import write_safetensors

    def preset(**paths):
        p = get_model_preset("musev_referencenet", ip_adapter_model_name="IPAdapterPlus",
                             ip_adapter_tokens=16, **paths)
        enable_face(p, "faceid")
        return p

    t0 = time.time()
    donor = build_models(preset(), seed=3)
    unet_sd = {k: v for k, v in donor.unet.state_dict().items()
               if not k.endswith(("to_k_ip.weight", "to_v_ip.weight"))}
    files = dict(unet_checkpoint=tmp / "unet.safetensors",
                 ip_adapter_checkpoint=tmp / "ip-adapter-plus.bin",
                 ip_adapter_face_checkpoint=tmp / "ip-adapter-faceid.bin")
    write_safetensors(files["unet_checkpoint"], unet_sd)
    state = donor.unet.state_dict()
    for slot, proj, prefix in (("ip_adapter_checkpoint", donor.ip_proj, ""),
                               ("ip_adapter_face_checkpoint", donor.ip_face_proj,
                                "ip_adapter_face_")):
        numbered = {f"{2 * i + 1}.{name}.weight": state[f"{site}.{prefix}{name}.weight"].cpu()
                    for i, site in enumerate(ip_adapter_site_paths(donor.unet.cfg))
                    for name in ("to_k_ip", "to_v_ip")}
        torch.save({"image_proj": {k: v.cpu() for k, v in proj.state_dict().items()},
                    "ip_adapter": numbered}, files[slot])
    write_s = time.time() - t0
    t1 = time.time()
    models = build_models(preset(**{k: str(f) for k, f in files.items()}), seed=4, strict=True)
    torch.cuda.synchronize()
    load_s = time.time() - t1
    wrong, n = [], 0
    for name in ("unet", "ip_proj", "ip_face_proj"):
        want = getattr(donor, name).state_dict()
        for k, v in getattr(models, name).state_dict().items():
            n += 1
            if v.dtype != want[k].dtype or not torch.equal(v, want[k]):
                wrong.append(f"{name}.{k}")
    del donor, state, unet_sd
    torch.cuda.empty_cache()
    shapes = {k: tuple(v.shape) for k, v in models.ip_proj.state_dict().items()
              if k in ("latents", "proj_in.weight", "layers.0.0.to_kv.weight")}
    print(f"phase options (b): files written in {write_s:.1f} s, loaded strictly in {load_s:.1f} "
          f"s; {n} loaded tensors checked bit for bit against the donor's, {len(wrong)} differ"
          f"{': ' + ', '.join(wrong[:5]) if wrong else ''}; Resampler {models.ip_proj.cfg}, "
          f"shapes {shapes}")
    if wrong:
        fail(f"the loaded IP-Adapter-Plus / FaceID weights differ at {len(wrong)} tensors")

    # the projections on the card against their float32 CPU plain versions
    with torch.inference_mode():
        pixels = preprocess_clip_image(torch.as_tensor(image[:, 0], device=models.device),
                                       models.clip_vision.cfg.image_size)
        tokens, _ = clip_vision_encode(models.clip_vision, pixels.to(models.dtype),
                                       penultimate=True)
        emb = torch.as_tensor(face_emb, device=models.device, dtype=models.dtype)
        errs = {}
        for name, module, x in (("resampler", models.ip_proj, tokens),
                                ("mlp_proj", models.ip_face_proj, emb)):
            plain = copy.deepcopy(module).to("cpu", torch.float32)
            errs[name] = rel_l2(torch, module(x), plain(x.float().cpu()))
    print(f"phase options (b): on the card against float32 on the CPU, relative L2 {errs} "
          f"(tol 1e-2)")
    if not all(e <= 1e-2 for e in errs.values()):
        fail(f"the Resampler or the FaceID projection disagrees with its plain version: {errs}")

    pipe = MusevPipeline(models)
    args = dict(T2V_ARGS, condition_images=image, face_emb=face_emb)
    res, profile, clip_s, launches, peak_gb = profiled_part(torch, pipe.text2video, args)
    check_clip(res, "the IP-Adapter-Plus + FaceID clip", need, launches)
    zeroed = pipe.text2video(**dict(args, face_emb=np.zeros_like(face_emb)))
    change = float(np.abs(zeroed.latents - res.latents).max())
    print(f"phase options (b) IP-Adapter-Plus + FaceID image-to-video: clip {clip_s:.2f} s "
          f"(profiled), "
          f"peak {peak_gb:.1f} GB, launches {launches}; a zeroed face embedding moves the "
          f"latents by up to {change:.3e}")
    if not change > 1e-3:
        fail("zeroing the face embedding left the clip unchanged")
    del pipe, models
    torch.cuda.empty_cache()
    return part_record(clip_s, launches, peak_gb, profile, write_files_s=write_s,
                       load_strict_s=load_s, tensors_bit_for_bit=n, plain_rel_l2=errs,
                       zeroed_face_latent_change=change)


def option_serial(torch, need) -> dict:
    """Part (c): ``musev`` serial denoise over 2 shots with the carries and
    every step's latents, at SERIAL_STEPS video steps, run once under the
    profiler."""
    import numpy as np

    from musev_torch.pipelines.loader import build_models
    from musev_torch.pipelines.pipeline import MusevPipeline

    pipe = MusevPipeline(build_models("musev", seed=0))
    args = dict(T2V_ARGS, n_batch=2, video_num_inference_steps=SERIAL_STEPS,
                record_mid_video=True, video_overlap=OVERLAP, need_middle_latents=True)
    res, profile, clip_s, launches, peak_gb = profiled_part(torch, pipe.text2video, args)
    frames = 2 * T2V_ARGS["video_length"]
    check_clip(res, "the serial-denoise clip", need, launches,
               shape=(1, frames + 1, *VIDEO_SHAPE[2:]))
    h = VIDEO_SHAPE[2] // 8
    carry = (SERIAL_STEPS + 1, 1, OVERLAP, h, h, 4)
    mid = (SERIAL_STEPS, 1, frames, *VIDEO_SHAPE[2:])
    got = dict(mid_video_latents=res.mid_video_latents.shape,
               mid_video_noises=res.mid_video_noises.shape, videos_mid=res.videos_mid.shape)
    print(f"phase options (c) serial denoise, 2 shots, {SERIAL_STEPS} steps: clip {clip_s:.2f} s "
          f"(profiled), peak {peak_gb:.1f} GB, launches {launches}, recordings {got}")
    if got != dict(mid_video_latents=carry, mid_video_noises=carry, videos_mid=mid) or not (
            np.isfinite(res.videos_mid).all() and np.isfinite(res.mid_video_noises).all()):
        fail(f"the serial-denoise recordings {got}, expected carries {carry} and mid {mid}")
    del pipe, res
    torch.cuda.empty_cache()
    return part_record(clip_s, launches, peak_gb, profile, steps=SERIAL_STEPS,
                       recordings={k: list(v) for k, v in got.items()})


class FramesReader:
    """``VideoReader``'s interface over frames in memory (the card's machine
    has no libav for the native reader)."""

    def __init__(self, frames):
        self.frames = frames
        self.num_frames, self.height, self.width = frames.shape[:3]

    def windows(self, time_size: int, overlap: int = 0, sample_rate: int = 1):
        for lo in range(0, self.num_frames, time_size - overlap):
            yield self.frames[lo:lo + time_size:sample_rate]

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def drive_v2v_cli(torch, tmp: Path, image, source, argv_extra: list, profiled: bool,
                  processor_hook=None):
    """The video2video CLI on the pose preset at the path's operating point
    with the serial denoise, histogram matching and CFG rescale (part (d)
    of PR 9), its source the frames ``source`` in memory (the card's machine
    has no libav), ``argv_extra`` appended; under the profiler where
    ``profiled``. ``processor_hook(name, processor)`` may wrap the
    processor the CLI takes. Fails unless one clip of 25 frames of 576x576
    was written. Returns (frames, profile or None, seconds, launches, peak
    GB)."""
    import numpy as np
    from PIL import Image

    import musev_torch.io.processors as processors
    import musev_torch.io.video as video_io
    from musev_torch.cli import video2video as cli

    Image.fromarray(image[0, 0].astype(np.uint8)).save(tmp / "condition.png")
    (tmp / "v2v.csv").write_text(
        "name,prompt,video_path,condition_images,refer_image\n"
        f"pose,{V2V_ARGS['prompt']},in-memory,{tmp / 'condition.png'},{tmp / 'condition.png'}\n")
    argv = ["--test_data_path", str(tmp / "v2v.csv"), "--output_dir", str(tmp / "v2v_out"),
            "--model_name", "musev_referencenet_pose", "--record_mid_video", "--video_overlap",
            str(OVERLAP), "--need_hist_match", "--guidance_rescale", "0.7", "--negative_prompt",
            V2V_ARGS["negative_prompt"], *argv_extra]
    real_reader, real_write, real_get, kept = (video_io.VideoReader, cli.write_frames,
                                               processors.get_processor, [])

    def keep(path, frames, fps):  # the frames as the writer gets them
        kept.append(frames.copy())
        return real_write(path, frames, fps)

    def get(name):
        fn = real_get(name)
        return fn if processor_hook is None else processor_hook(name, fn)

    video_io.VideoReader, cli.write_frames = (lambda path: FramesReader(source)), keep
    processors.get_processor = get
    try:
        if profiled:
            written, profile, cli_s, launches, peak_gb = profiled_part(
                torch, lambda: cli.main(argv), {})
        else:
            written, cli_s, launches, peak_gb = timed_run(torch, lambda: cli.main(argv))
            profile = None
    finally:
        video_io.VideoReader, cli.write_frames = real_reader, real_write
        processors.get_processor = real_get
    if len(written) != 1 or len(kept) != 1:
        fail(f"the video2video CLI wrote {written}, not one clip")
    want = (VIDEO_SHAPE[1], *VIDEO_SHAPE[2:])
    if kept[0].shape != want:
        fail(f"the video2video CLI wrote frames {kept[0].shape}, expected {want}")
    return kept[0], profile, cli_s, launches, peak_gb


def phase_options(torch, tmp: Path, image, pose_frames, face_emb, need) -> dict:
    """PR 9's path (see the module docstring, phase 9): the three parts'
    records; part (b) takes ``face_emb``, phase onnx's extracted
    embedding."""
    import numpy as np

    t0 = time.time()
    pose = np.concatenate([pose_frames[:1], pose_frames], axis=0)[None]  # 1 + 24 maps
    parts = {
        "options: ControlNet text2video": option_controlnet(torch, image, pose, need),
        "options: IP-Adapter-Plus + FaceID": option_ip_plus(torch, tmp, image, face_emb, need),
        "options: serial denoise": option_serial(torch, need),
    }
    print(f"phase options: {time.time() - t0:.1f} s; " + json.dumps(
        {k: {f: v[f] for f in ("clip_s", "peak_gb", "busy_share")} for k, v in parts.items()}))
    return parts


class TimedRuns:
    """Wraps an OnnxModel's ``run``: host seconds (the call ends in a copy
    to the host) and CUDA-event milliseconds of each call, and a copy of
    the first call's feeds (``feeds``)."""

    def __init__(self, torch, model):
        self.torch, self.real, self.host_s, self.event_ms = torch, model.run, [], []
        self.feeds = None
        model.run = self

    def __call__(self, feeds):
        import numpy as np

        torch = self.torch
        if self.feeds is None:
            self.feeds = {k: np.array(v) for k, v in feeds.items()}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = self.real(feeds)
        end.record()
        torch.cuda.synchronize()
        self.host_s.append(time.perf_counter() - t0)
        self.event_ms.append(start.elapsed_time(end))
        return out

    def summary(self, frames: int) -> dict:
        return dict(calls=len(self.host_s), s_per_frame=sum(self.host_s) / frames,
                    event_ms_per_frame=sum(self.event_ms) / frames)


def head_model(path: str):
    """The stand-in graph at ``path`` with its outputs replaced by what it
    computes before each constant table is added (the scaled input of each
    ``table`` Add), or as it is where it has no table: the values that a
    fault of the executor on the card would move, and that the tables hide
    from the decoded boxes, keypoints and masks."""
    from dataclasses import replace

    from musev_torch.onnx.proto import load_model

    model = load_model(path)
    g = model.graph
    producer = {o: n for n in g.nodes for o in n.outputs}
    heads = [producer[n.inputs[0]].inputs[0] for n in g.nodes
             if n.op_type == "Add" and n.inputs[1].startswith("table")]
    return replace(model, graph=replace(g, outputs=heads)) if heads else model


def raw_l2(paths: dict, timers: dict) -> dict:
    """{graph: the largest relative L2 distance over its ``head_model``
    outputs between the card's executor and the CPU's}, each graph fed the
    first feeds its ``TimedRuns`` saw on the card."""
    import numpy as np

    from musev_torch.onnx.runtime import OnnxModel

    out = {}
    for name, timer in timers.items():
        model = head_model(paths[name])
        got = OnnxModel(model).run(timer.feeds)
        want = OnnxModel(model, device="cpu").run(timer.feeds)
        out[name] = max(float(np.linalg.norm(g.astype(np.float64) - w) / np.linalg.norm(w))
                        for g, w in zip(got, want))
    return out


def check_raw(step: str, raw: dict) -> None:
    print(f"phase onnx ({step}): raw outputs card against CPU, relative L2 {raw} "
          f"(tol {RAW_L2})")
    bad = {k: v for k, v in raw.items() if not v <= RAW_L2}
    if bad:
        fail(f"the executor on the card disagrees with the CPU's on {bad}")


def share_equal(a, b) -> float:
    """Share of pixels whose three channels are equal."""
    return float((a == b).all(-1).mean())


def onnx_dwpose_clip(torch, tmp: Path, paths: dict, image, source, need) -> dict:
    """Step 1: the dwpose video2video clip through the CLI at full width
    (part (d)'s flags), profiled; the processor's maps against the same
    processor on the CPU executor; the clip again with the detector's table
    empty, which must move it."""
    import numpy as np

    from musev_torch.io.dwpose import DWPoseProcessor
    from musev_torch.onnx.runtime import OnnxModel

    seen = {"frames": [], "maps": [], "s": 0.0}
    timers = {}

    def hook(name, proc):
        timers["det"], timers["pose"] = TimedRuns(torch, proc.det), TimedRuns(torch, proc.pose)

        def run(frames):
            t0 = time.perf_counter()
            maps = proc(frames)
            seen["s"] += time.perf_counter() - t0
            seen["frames"].append(np.array(frames))
            seen["maps"].append(maps)
            return maps
        return run

    argv = ["--controlnet_name", "dwpose", "--dwpose_det_onnx", paths["yolox"],
            "--dwpose_pose_onnx", paths["rtmpose"]]
    frames, profile, cli_s, launches, peak_gb = drive_v2v_cli(
        torch, tmp, image, source, argv, profiled=True, processor_hook=hook)
    check_profile_launches(profile, "the dwpose video2video CLI")
    for name in need:
        if launches[name] <= 0:
            fail(f"the dwpose video2video CLI launched {name} no time")
    wide = profile.get("port_kernel_launches", {}).get("flash_fwd_wide_kernel", 0)
    src = np.concatenate(seen["frames"])
    maps = np.concatenate(seen["maps"])
    n = len(src)
    t0 = time.time()
    cpu = DWPoseProcessor(OnnxModel.from_file(paths["yolox"], device="cpu"),
                          OnnxModel.from_file(paths["rtmpose"], device="cpu"))
    cpu_maps = cpu(src)
    cpu_s = time.time() - t0
    shares = [share_equal(a, b) for a, b in zip(maps, cpu_maps)]
    card_pose = cpu_pose = None
    with torch.inference_mode():
        card = DWPoseProcessor(OnnxModel.from_file(paths["yolox"]),
                               OnnxModel.from_file(paths["rtmpose"]))
        card_pose, cpu_pose = card.detect_frame(src[0]), cpu.detect_frame(src[0])
    kp_err = float(np.abs(card_pose.bodies - cpu_pose.bodies).max() * VIDEO_SHAPE[2])
    det = dict(processor_s_per_frame=seen["s"] / n, detector=timers["det"].summary(n),
               pose=timers["pose"].summary(n))
    busy = (profile.get("device_ms") or 0.0) / profile["wall_ms"]
    print(f"phase onnx (1) dwpose video2video CLI: {cli_s:.2f} s (profiled, models built "
          f"inside), peak {peak_gb:.1f} GB, launches {launches}, wide flash launches {wide}, "
          f"busy {busy:.1%}; {n} source frames "
          f"through dwpose, per frame {json.dumps(det)}; card against the CPU executor "
          f"({cpu_s:.1f} s): equal pixels min {min(shares):.5f} (tol {POSE_MAP_SHARE}), body "
          f"keypoints of frame 0 within {kp_err:.2e} px; map pixels drawn "
          f"{float(maps.any(-1).mean()):.3f}")
    if n != VIDEO_SHAPE[1] - 1 or not maps.any():
        fail(f"the dwpose processor saw {n} frames, or drew nothing")
    if min(shares) < POSE_MAP_SHARE:
        fail(f"the dwpose maps on the card disagree with the CPU executor's: {min(shares)}")
    raw = raw_l2(paths, {"yolox": timers["det"], "rtmpose": timers["pose"]})
    check_raw(1, raw)
    empty, _, empty_s, _, _ = drive_v2v_cli(
        torch, tmp, image, source, ["--controlnet_name", "dwpose", "--dwpose_det_onnx",
                                    paths["yolox_empty"], "--dwpose_pose_onnx",
                                    paths["rtmpose"]], profiled=False)
    change = int(np.abs(empty.astype(np.int16) - frames).max())
    mean_change = float(np.abs(empty.astype(np.float32) - frames).mean())
    print(f"phase onnx (1): with no person in the detector's table the clip ({empty_s:.2f} s) "
          f"moves by up to {change} grey levels, {mean_change:.2f} on average")
    if not change >= 8:
        fail("an empty detection left the dwpose clip unchanged")
    return part_record(cli_s, launches, peak_gb, profile, frames=list(frames.shape),
                       dwpose=det, cpu_dwpose_s=cpu_s, map_share_min=min(shares),
                       keypoint_err_px=kp_err, raw_rel_l2=raw, wide_flash_launches=wide,
                       empty_detection_change=dict(max=change, mean=mean_change,
                                                   clip_s=empty_s))


def onnx_face(torch, paths: dict, image):
    """Step 2: the face embedding of part (b)'s condition image on the card
    against the CPU executor's. Returns (embedding, record)."""
    import numpy as np

    from musev_torch.io.face_emb import build_face_emb_extractor

    img = image[:, 0].astype(np.uint8)
    card = build_face_emb_extractor(paths["scrfd"], paths["arcface"])
    timers = [TimedRuns(torch, card.det), TimedRuns(torch, card.rec)]
    card(img)  # the first call uploads the weights
    for t in timers:
        t.host_s.clear(), t.event_ms.clear()
    t0 = time.perf_counter()
    emb = card(img)
    card_s = time.perf_counter() - t0
    cpu = build_face_emb_extractor(paths["scrfd"], paths["arcface"], device="cpu")(img)
    cos = float((emb * cpu).sum() / np.linalg.norm(emb) / np.linalg.norm(cpu))
    raw = raw_l2(paths, dict(zip(("scrfd", "arcface"), timers)))
    rec = dict(s_per_image=card_s, detector=timers[0].summary(1), recognition=timers[1].summary(1),
               cosine_vs_cpu=cos, norm=float(np.linalg.norm(emb)), raw_rel_l2=raw)
    print(f"phase onnx (2) face embedding: {json.dumps(rec)} (tol cosine {FACE_COS})")
    if emb.shape != (1, 512) or not np.isfinite(emb).all() or cos < FACE_COS:
        fail(f"the face embedding on the card: shape {emb.shape}, cosine {cos} to the CPU's")
    check_raw(2, raw)
    return emb, rec


def onnx_processors(torch, paths: dict, frame) -> dict:
    """Step 3: SAM (8 x 8 points), the face detector and a depth
    OnnxImageProcessor on one frame, card against the CPU executor."""
    import numpy as np

    from musev_torch.io.processors import OnnxImageProcessor
    from musev_torch.io.sam import FaceDetectorProcessor, SamAutomaticMaskProcessor
    from musev_torch.onnx.runtime import OnnxModel

    def models(*names, device=None):
        return [OnnxModel.from_file(paths[n], device=device) for n in names]

    makers = {
        "sam": (("sam_encoder", "sam_decoder"), lambda e, d: SamAutomaticMaskProcessor(e, d)),
        "face_detector": (("yolox",), FaceDetectorProcessor),
        "depth": (("depth",), lambda m: OnnxImageProcessor(m, "depth")),
    }
    record = {}
    for name, (graphs, make) in makers.items():
        card_models = models(*graphs)
        timers = [TimedRuns(torch, m) for m in card_models]
        proc = make(*card_models)
        proc(frame[None])  # the first call uploads the weights
        for t in timers:
            t.host_s.clear(), t.event_ms.clear()
        t0 = time.perf_counter()
        got = proc(frame[None])[0]
        card_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        want = make(*models(*graphs, device="cpu"))(frame[None])[0]
        cpu_s = time.perf_counter() - t1
        share, grey = share_equal(got, want), int(np.abs(got.astype(np.int16) - want).max())
        raw = raw_l2(paths, dict(zip(graphs, timers)))
        record[name] = dict(s_per_frame=card_s, cpu_s=cpu_s, equal_share=share, max_grey=grey,
                            drawn=float(got.any(-1).mean()), raw_rel_l2=raw,
                            graphs={g: t.summary(1) for g, t in zip(graphs, timers)})
        print(f"phase onnx (3) {name}: {json.dumps(record[name])}")
        ok = grey <= DEPTH_GREY if name == "depth" else share >= SAM_SHARE
        if not ok or not got.any():
            fail(f"the {name} processor on the card disagrees with the CPU or drew nothing")
        check_raw(3, raw)
    return record


def onnx_item11(torch) -> dict:
    """Step 4: one full-width musev UNet call at the window batch's shapes
    with the sparse-causal mask and the spatial position embedding, against
    the same weights with both off (the temporal transformers weighted 1)."""
    from musev_torch.models.unet3d import UNet3D, musev_config, unet3d_apply
    from musev_torch.pipelines.loader import init_random_

    from musev_torch.models.unet_blocks import TemporalTransformer

    gen = torch.Generator(device="cuda").manual_seed(11)
    on = UNet3D(musev_config(**ITEM11_FLAGS)).to("cuda", torch.bfloat16).eval()
    init_random_(on, gen, scale=0.02)
    # the reference's temporal_weight of 1e-5 scales the temporal branch
    # below bf16's rounding of the residual: weight it 1 so that the mask
    # and the embedding can show
    for m in on.modules():
        if isinstance(m, TemporalTransformer):
            m.temporal_weight.data.fill_(1.0)
    off = UNet3D(musev_config()).to("cuda", torch.bfloat16).eval()
    missing, unexpected = off.load_state_dict(on.state_dict(), strict=False)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen, dtype=torch.bfloat16)

    rows = 6  # 3 windows x 2 CFG halves
    sample, cond, text = rand(rows, 12, 72, 72, 4), rand(rows, 1, 72, 72, 4), rand(rows, 77, 768)
    kw = dict(condition_latents=cond, gen_index=tuple(range(1, 13)), cond_index=(0,),
              do_cfg=True)
    out, ms, launches = {}, {}, {}
    with torch.inference_mode():
        for name, unet in (("item 11 on", on), ("item 11 on", on), ("off", off), ("off", off)):
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            out[name] = unet3d_apply(unet, sample, 500.0, text, **kw).float()
            torch.cuda.synchronize()
            ms[name], launches[name] = (time.time() - t0) * 1e3, read_counts()
    finite = bool(torch.isfinite(out["item 11 on"]).all())
    diff = ((out["item 11 on"] - out["off"]).norm() / out["off"].norm()).item()
    print(f"phase onnx (4) item 11: full-width musev UNet call with {ITEM11_FLAGS} "
          f"{ms['item 11 on']:.0f} ms, without {ms['off']:.0f} ms (host clock, second call); "
          f"finite {finite}, relative L2 to the call without them {diff:.3e}; "
          f"{len(unexpected)} spatial tensors dropped for the plain UNet; launches "
          f"{launches}")
    if not finite or not diff > 1e-3 or missing:
        fail(f"the item-11 UNet call: finite {finite}, change {diff}, missing {missing}")
    del on, off, out
    torch.cuda.empty_cache()
    return dict(ms=ms, relative_l2_vs_off=diff, finite=finite, launches=launches,
                spatial_tensors=len(unexpected))


def phase_onnx(torch, tmp: Path, image, source, need):
    """Phase onnx (see the module docstring): the stand-in graphs, then the
    four steps. Returns (record, the extracted face embedding)."""
    from musev_torch.onnx import standins

    t0 = time.time()
    paths = standins.write_standins(str(tmp))
    write_s = time.time() - t0
    tf32 = dict(cudnn=torch.backends.cudnn.allow_tf32, matmul=torch.backends.cuda.matmul.allow_tf32)
    print(f"phase onnx: stand-in graphs written in {write_s:.1f} s "
          f"({sum(os.path.getsize(p) for p in paths.values()) / 1e6:.0f} MB); TF32 {tf32}; "
          f"cv2 importable: {importable('cv2')}")
    record = dict(write_graphs_s=write_s, tf32=tf32, cv2=importable("cv2"))
    record["dwpose clip"] = onnx_dwpose_clip(torch, tmp, paths, image, source, need)
    face_emb, record["face embedding"] = onnx_face(torch, paths, image)
    record["processors"] = onnx_processors(torch, paths, source[0])
    record["item 11"] = onnx_item11(torch)
    record["s"] = time.time() - t0
    print(f"phase onnx: {record['s']:.1f} s")
    return record, face_emb


def phase_reference(torch):
    """A narrow UNet (head dims 40/80/160, as on the path) on the card in
    bf16 against the same weights on the CPU in float32, without and with
    the sparse-causal temporal mask and the spatial position embedding.
    Returns {config: relative L2 error}."""
    from musev_torch.models.unet3d import UNet3D, UNet3DConfig, unet3d_apply
    from musev_torch.pipelines.loader import init_random_

    t0 = time.time()
    narrow = dict(block_out_channels=(80, 160, 320, 320), layers_per_block=1,
                  cross_attention_dim=64, attention_heads=2, norm_num_groups=8)
    errs = {}
    for name, flags in (("plain", {}), ("sparse_causal + spatial emb", ITEM11_FLAGS)):
        cfg = UNet3DConfig(**narrow, **flags)
        gen = torch.Generator().manual_seed(1)
        cpu = UNet3D(cfg)
        init_random_(cpu, gen, scale=0.05)
        if flags:  # weigh the temporal branch 1, not 1e-5, so that item 11 shows in bf16
            for key, value in cpu.state_dict().items():
                if key.endswith("temporal_weight") and "temp_conv" not in key:
                    value.fill_(1.0)
        cpu.eval()
        gpu = UNet3D(cfg)
        gpu.load_state_dict(cpu.state_dict())
        gpu = gpu.to("cuda", torch.bfloat16).eval()
        sample = torch.randn(2, 5, 16, 16, 4, generator=gen)
        cond = torch.randn(2, 1, 16, 16, 4, generator=gen)
        text = torch.randn(2, 9, 64, generator=gen)
        kw = dict(gen_index=tuple(range(1, 6)), cond_index=(0,), do_cfg=True)
        with torch.inference_mode():
            want = unet3d_apply(cpu, sample, 500.0, text, condition_latents=cond, **kw)
            got = unet3d_apply(gpu, sample.cuda().bfloat16(), 500.0, text.cuda().bfloat16(),
                               condition_latents=cond.cuda().bfloat16(), **kw).float().cpu()
        errs[name] = ((got - want).norm() / want.norm()).item()
    print(f"phase reference: narrow UNet bf16 card vs fp32 CPU, relative L2 error {errs} "
          f"(tol 5e-2), {time.time() - t0:.1f} s")
    if not all(e <= 5e-2 for e in errs.values()):
        fail(f"narrow UNet on the card disagrees with the CPU: relative error {errs}")
    return errs


def rel_l2_parts(torch, parts) -> float:
    """Relative L2 of ``got`` against ``want`` over (got, want) pairs taken together."""
    num = sum(((g.float() - w.float()) ** 2).sum().item() for g, w in parts)
    den = sum((w.float() ** 2).sum().item() for _, w in parts)
    return (num / den) ** 0.5


def train_attention(torch, gen) -> list:
    """The training route of attention (``mem_efficient_sdpa``: the flash
    kernel with its stats forward, the chunked float32 backward) at
    TRAIN_ATTN_SITES in bf16: out, dq, dk and dv against autograd through
    the plain attention in float32 (batch row by batch row, for its logits'
    memory), relative L2 <= TOL_REL_L2; the forward's and forward +
    backward's times beside SDPA's with autograd, and their bounds. Returns
    the kernel rows of ``flash_attention_train``."""
    import torch.nn.functional as F

    from musev_torch.ops.attention import mem_efficient_sdpa
    from musev_torch.ops.kernels.flash_attention import flash_attention_plain

    rows = []
    for site, proj, b, h, sq, sk, d in TRAIN_ATTN_SITES:
        q, k, v = (x.detach().requires_grad_() for x in
                   flash_inputs(torch, gen, proj, b, h, sq, sk, d))
        do = torch.randn(b, sq, h, d, device="cuda", generator=gen, dtype=torch.bfloat16)
        out = mem_efficient_sdpa(q, k, v)
        grads = torch.autograd.grad(out, (q, k, v), do)
        pairs = {name: [] for name in ("out", "dq", "dk", "dv")}
        for i in range(b):
            qi, ki, vi = (x[i:i + 1].detach().float().requires_grad_() for x in (q, k, v))
            oi = flash_attention_plain(qi, ki, vi)
            want = (oi, *torch.autograd.grad(oi, (qi, ki, vi), do[i:i + 1].float()))
            for name, got, w in zip(pairs, (out, *grads), want):
                pairs[name].append((got[i:i + 1], w.detach()))
            del qi, ki, vi, oi, want
        errs = {name: rel_l2_parts(torch, parts) for name, parts in pairs.items()}
        max_err = max((g.float() - w).abs().max().item() for g, w in pairs["out"])
        del pairs, out, grads
        print(f"flash_attention_train {site}: relative L2 against float32 autograd through the "
              f"plain path {errs} (tol {TOL_REL_L2})")
        if not all(e <= TOL_REL_L2 for e in errs.values()):
            fail(f"the training attention's grads disagree with the plain path at {site}")

        def fwd():
            return mem_efficient_sdpa(q, k, v)

        def fwd_bwd():
            return torch.autograd.grad(mem_efficient_sdpa(q, k, v), (q, k, v), do)

        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa_fwd_bwd():
            return torch.autograd.grad(F.scaled_dot_product_attention(qt, kt, vt), (q, k, v), dot)

        def plain_all():
            with torch.no_grad():
                for i in range(b):
                    flash_attention_plain(q[i:i + 1], k[i:i + 1], v[i:i + 1])

        t = timed(torch, "flash_attention_train", fwd)
        with torch.no_grad():
            lib = library_timed(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt))
        fb_dev, fb_seen = device_ms(torch, fwd_bwd)
        lib_fb_dev, lib_fb_seen = device_ms(torch, sdpa_fwd_bwd)
        flops = 4.0 * b * h * sq * sk * d
        bms, by = bound_ms(flops, 2.0 * b * h * d * (2 * sq + 2 * sk))
        fb_bms, fb_by = bound_ms(TRAIN_FWD_BWD_OPS * flops, 2.0 * b * h * d * (4 * sq + 4 * sk))
        row = dict(site=site, projection=proj, shape=[b, h, sq, sk, d], rel_l2=errs,
                   max_abs_err=max_err, **t, plain_ms=cuda_ms(torch, plain_all, warmup=1, iters=3),
                   **lib, bound_ms=bms, bound_by=by,
                   fwd_bwd_ms=cuda_ms(torch, fwd_bwd), fwd_bwd_device_ms=fb_dev,
                   fwd_bwd_device_records=fb_seen, sdpa_fwd_bwd_ms=cuda_ms(torch, sdpa_fwd_bwd),
                   sdpa_fwd_bwd_device_ms=lib_fb_dev, sdpa_fwd_bwd_device_records=lib_fb_seen,
                   fwd_bwd_bound_ms=fb_bms, fwd_bwd_bound_by=fb_by)
        rows.append(row)
        print(f"flash_attention_train {site} (B,H,sq,sk,d)={(b, h, sq, sk, d)}: forward "
              f"{row['ms']:.3f} ms, device {fmt_ms(row['device_ms'])}, plain {row['plain_ms']:.3f} "
              f"ms, sdpa {row['library_ms']:.3f} ms, bound {bms:.3f} ms ({by}); forward + "
              f"backward {row['fwd_bwd_ms']:.3f} ms, device {fmt_ms(fb_dev)}, sdpa "
              f"{row['sdpa_fwd_bwd_ms']:.3f} ms, device {fmt_ms(lib_fb_dev)}, bound "
              f"{fb_bms:.3f} ms ({fb_by})")
        del q, k, v, do, qt, kt, vt, dot
        torch.cuda.empty_cache()
    return rows


def train_pivots(torch, gen) -> dict:
    """The pivots under autograd at the training path's L0 temporal site
    (one clip of 13 frames): K5 (backward K7), K7 (backward K5) and K6
    (backward K7 and float32 sums) against autograd through the plain
    versions; the moves and dx bit for bit, K6's dscale and dshift within
    float32 rounding of their sums over the pixels (relative L2 1e-5)."""
    from musev_torch.ops.kernels.pivot import pivot_rows, pivot_rows_plain, unpivot_rows

    b, t, hw, c = 1, TRAIN_CLIP[1], 72 * 72, 320
    x = torch.randn(b, t, hw, c, device="cuda", generator=gen, dtype=torch.bfloat16)
    scale, shift = (torch.randn(b, 1, c, device="cuda", generator=gen) for _ in range(2))
    g = torch.randn(b, hw, t, c, device="cuda", generator=gen, dtype=torch.bfloat16)
    record = {}
    for kind in ("pivot", "unpivot", "pivot_gn"):
        src = x.transpose(1, 2).contiguous() if kind == "unpivot" else x
        gy = g.transpose(1, 2).contiguous() if kind == "unpivot" else g

        def run(plain):
            xs = src.clone().requires_grad_()
            ss, hs = scale.clone().requires_grad_(), shift.clone().requires_grad_()
            if kind == "pivot":
                y = pivot_rows_plain(xs) if plain else pivot_rows(xs)
            elif kind == "unpivot":
                y = xs.transpose(1, 2).contiguous() if plain else unpivot_rows(xs)
            else:
                y = (pivot_rows_plain if plain else pivot_rows)(
                    xs, ss.expand(b, t, c), hs.expand(b, t, c))
            y.backward(gy)
            return xs.grad, ss.grad, hs.grad

        (dx, ds, dh), (dx_w, ds_w, dh_w) = run(False), run(True)
        rec = dict(dx_bit_for_bit=torch.equal(dx, dx_w))
        if kind == "pivot_gn":
            rec.update(dscale_rel_l2=rel_l2(torch, ds, ds_w), dshift_rel_l2=rel_l2(torch, dh, dh_w))
        record[kind] = rec
        ok = rec["dx_bit_for_bit"] and all(v <= 1e-5 for k_, v in rec.items() if "rel" in k_)
        print(f"train pivots {kind} (b,T,HW,C)={(b, t, hw, c)} under autograd: {rec}")
        if not ok:
            fail(f"the {kind} grads disagree with autograd through the plain path")
    return record


def train_short(torch, gen) -> dict:
    """K4 under autograd (``_ShortAttention``: the kernel's forward, a
    float32 recompute of the plain version for the backward) at the
    training path's L0 temporal site (one clip: 72x72 pixel rows of 13
    frames, C 320, 8 heads; views of one fused projection): out and the
    projection's grad against autograd through the plain version in float32,
    relative L2 <= TOL_REL_L2; forward + backward timed beside autograd
    through the plain version."""
    from musev_torch.ops.kernels.short_attention import (
        short_attention_packed,
        short_attention_plain,
    )

    n, t, c, heads = 72 * 72, TRAIN_CLIP[1], 320, 8
    qkv = torch.randn(n, t, 3 * c, device="cuda", generator=gen,
                      dtype=torch.bfloat16).requires_grad_()
    do = torch.randn(n, t, c, device="cuda", generator=gen, dtype=torch.bfloat16)
    out = short_attention_packed(*qkv.chunk(3, dim=-1), heads)
    (grad,) = torch.autograd.grad(out, qkv, do)
    qkv32 = qkv.detach().float().requires_grad_()
    want = short_attention_plain(*qkv32.chunk(3, dim=-1), heads)
    (want_grad,) = torch.autograd.grad(want, qkv32, do.float())
    rec = dict(shape=[n, t, c, heads], kind=type(out.grad_fn).__name__,
               out_rel_l2=rel_l2(torch, out, want), grad_rel_l2=rel_l2(torch, grad, want_grad))

    def fwd_bwd(fn, x, g):
        return torch.autograd.grad(fn(*x.chunk(3, dim=-1), heads), x, g)

    rec.update(fwd_bwd_ms=cuda_ms(torch, lambda: fwd_bwd(short_attention_packed, qkv, do)),
               plain_fwd_bwd_ms=cuda_ms(torch, lambda: fwd_bwd(short_attention_plain, qkv, do)))
    print(f"train short_attention (N,T,C,heads)={(n, t, c, heads)} under autograd: {rec}")
    if rec["kind"] != "_ShortAttentionBackward" or not max(
            rec["out_rel_l2"], rec["grad_rel_l2"]) <= TOL_REL_L2:
        fail(f"K4 under autograd disagrees with autograd through the plain version: {rec}")
    return rec


def train_narrow(torch) -> dict:
    """A narrow UNet's loss and grads on the card (float32 masters, the loss
    under bf16 autocast; 32x32 latents, so the L0 attention takes the flash
    training route) against float32 on the CPU, the same draws: relative L2
    < 5e-2, the gate of phase reference."""
    from musev_torch.models.unet3d import UNet3D, UNet3DConfig
    from musev_torch.pipelines.loader import init_random_
    from musev_torch.train import TrainSpec, diffusion_loss

    cfg = UNet3DConfig(**TRAIN_NARROW)
    cpu = UNet3D(cfg)
    init_random_(cpu, torch.Generator().manual_seed(1), scale=0.05)
    gpu = UNet3D(cfg)
    gpu.load_state_dict(cpu.state_dict())
    gpu.cuda()
    data = torch.Generator().manual_seed(2)
    latents = torch.randn(1, 5, 32, 32, 4, generator=data)
    text = torch.randn(1, 9, 64, generator=data)
    spec = TrainSpec(unet_cfg=cfg, n_vision_cond=1)
    want = diffusion_loss(cpu, spec, latents, text, torch.Generator().manual_seed(3))
    want.backward()
    with torch.autocast("cuda", torch.bfloat16):
        got = diffusion_loss(gpu, spec, latents.cuda(), text.cuda(),
                             torch.Generator().manual_seed(3))
    got.backward()
    loss_err = abs(got.item() - want.item()) / abs(want.item())
    grad_err = rel_l2_parts(torch, [(g.grad.cpu(), c.grad) for g, c in
                                    zip(gpu.parameters(), cpu.parameters())])
    print(f"phase train (5): narrow UNet loss and grads, card under bf16 autocast against "
          f"float32 on the CPU: loss {loss_err:.2e}, grads relative L2 {grad_err:.2e} (tol 5e-2)")
    if not (loss_err < 5e-2 and grad_err < 5e-2):
        fail(f"the narrow UNet's training on the card disagrees with the CPU: {grad_err}")
    return dict(loss_rel_err=loss_err, grads_rel_l2=grad_err)


def phase_train(torch, tmp: Path) -> dict:
    """This slice's path (see the module docstring, phase 10). Returns its
    record; ``launches`` are those of the TRAIN_STEPS timed steps."""
    import math

    from musev_torch.models.unet3d import UNet3D
    from musev_torch.pipelines.loader import build_models
    from musev_torch.train import (
        SuperTrainSpec,
        TrainSpec,
        make_optimizer,
        super_train_step,
        train_step_opt,
    )
    from musev_torch.utils.checkpoint import restore_state, save_state

    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(11)
    record = dict(attention=train_attention(torch, gen), pivots=train_pivots(torch, gen),
                  short=train_short(torch, gen))

    # (2) the musev UNet at full width: float32 masters, the loss under autocast
    unet = build_models("musev", seed=0).unet.float()
    torch.cuda.empty_cache()
    cfg = unet.cfg
    with torch.device("meta"):
        n_params = sum(p.numel() for p in UNet3D(cfg).parameters())
    data = torch.Generator().manual_seed(12)
    latents = torch.randn(TRAIN_CLIP, generator=data).cuda()
    text = torch.randn(1, 77, cfg.cross_attention_dim, generator=data).cuda()
    spec = TrainSpec(unet_cfg=cfg, n_vision_cond=1)
    opt = make_optimizer(spec, unet.parameters())
    params = list(unet.parameters())
    sample = params[::16]
    before = [p.detach().clone() for p in sample]

    def step(seed):
        with torch.autocast("cuda", torch.bfloat16):
            return train_step_opt(unet, opt, spec, latents, text,
                                  torch.Generator().manual_seed(seed))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    times, losses = [], []
    for i in range(TRAIN_STEPS):
        t1 = time.time()
        losses.append(step(100 + i).item())
        torch.cuda.synchronize()
        times.append(time.time() - t1)
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finite = all(math.isfinite(x) for x in losses) and all(
        bool(torch.isfinite(p.grad).all()) for p in params)
    moved = sum(not torch.equal(a, p.detach()) for a, p in zip(before, sample))
    del before
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    print(f"phase train (2): musev UNet {n_params / 1e9:.3f} B params (meta count), float32 "
          f"masters, AdamW with clipping, clip {TRAIN_CLIP}: losses {losses}, step times "
          f"{[round(x, 3) for x in times]} s (median {statistics.median(times):.3f}), peak "
          f"{peak_gb:.1f} GB, launches per step {per_step}; finite {finite}, {moved} of "
          f"{len(sample)} sampled params moved")
    if not finite:
        fail("a training loss or grad is not finite")
    if moved != len(sample):
        fail(f"the AdamW steps left {len(sample) - moved} of {len(sample)} sampled params")
    for name in ("flash_attention_train", "short_attention", "pivot_rows_gn", "unpivot_rows",
                 "pivot_rows", "group_norm_silu", "group_norm_scale_shift", "layer_norm"):
        if launches[name] <= 0:
            fail(f"the training steps launched {name} no time")
    if any(launches[name] for name in NORM_PLAIN):
        fail(f"the training steps ran a norm's plain composition: {launches}")
    profile, _ = profile_path(torch, lambda: step(200), {})

    # (3) the checkpoint: the state after the profiled step, one more step
    # with and without the round trip, deterministic algorithms on for both
    path = tmp / "train_state.safetensors"
    t2 = time.time()
    save_state(path, {"unet": unet.state_dict(), "optimizer": opt.state_dict()})
    save_s = time.time() - t2
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        step(300)
        after = [p.detach().clone() for p in params]
        t3 = time.time()
        state = restore_state(path)
        unet.load_state_dict(state["unet"])
        opt.load_state_dict(state["optimizer"])
        del state
        torch.cuda.synchronize()
        load_s = time.time() - t3
        step(300)
        same = all(torch.equal(a, p.detach()) for a, p in zip(after, params))
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    ckpt_gb = path.stat().st_size / 1e9
    path.unlink()
    print(f"phase train (3): checkpoint {ckpt_gb:.2f} GB written in {save_s:.1f} s, restored in "
          f"{load_s:.1f} s; the step after the round trip bit for bit: {same}")
    if not same:
        fail("the step after the checkpoint's round trip differs from the step without it")
    del unet, opt, params, sample, after
    torch.cuda.empty_cache()

    # (4) the conditioned bundle of musev_referencenet_pose: one SGD step
    models = build_models("musev_referencenet_pose", seed=0)
    bundle = {name: getattr(models, name).float()
              for name in ("unet", "referencenet", "ip_proj", "controlnet")}
    del models
    torch.cuda.empty_cache()
    h, w = TRAIN_CLIP[2:4]
    clip_dim = bundle["ip_proj"].proj.in_features
    batch = dict(latents=latents, text_emb=text,
                 refer_latents=torch.randn(1, h, w, 4, generator=data).cuda(),
                 clip_pooled=torch.randn(1, clip_dim, generator=data).cuda(),
                 control_images=torch.rand(1, TRAIN_CLIP[1], 8 * h, 8 * w, 3,
                                           generator=data).cuda())
    sspec = SuperTrainSpec(unet_cfg=bundle["unet"].cfg,
                           referencenet_cfg=bundle["referencenet"].cfg,
                           controlnet_cfg=bundle["controlnet"].cfg)
    samples = {n: list(m.parameters())[::16] for n, m in bundle.items()}
    befores = {n: [p.detach().clone() for p in ps] for n, ps in samples.items()}

    def super_step():
        with torch.autocast("cuda", torch.bfloat16):
            return super_train_step(bundle, sspec, batch, torch.Generator().manual_seed(13))

    super_loss, super_s, super_launches, super_peak = timed_run(torch, super_step)
    grads = {}
    for n, m in bundle.items():
        named = list(m.named_parameters())
        reached = [(k, p) for k, p in named if p.grad is not None]
        grads[n] = dict(
            params=len(named), reached=len(reached),
            finite=all(bool(torch.isfinite(p.grad).all()) for _, p in reached),
            zero=[k for k, p in reached if not bool(p.grad.any())])
    # the sampled params after the step are p - lr * g bit for bit (_sgd's
    # rounding); a param stays where lr * |g| is under half its float32
    # spacing in every element
    applied, moved, below = {}, {}, {}
    for n, ps in samples.items():
        applied[n] = all(torch.equal(p.detach(), b - p.grad.to(b.dtype) * sspec.learning_rate)
                         for b, p in zip(befores[n], ps) if p.grad is not None)
        stayed = [(b, p) for b, p in zip(befores[n], ps) if torch.equal(b, p.detach())]
        moved[n] = 1.0 - len(stayed) / len(ps)
        below[n] = sum(bool((p.grad.float().abs() * sspec.learning_rate
                             < torch.abs(torch.nextafter(b, torch.full_like(b, math.inf)) - b) / 2
                             ).all()) for b, p in stayed if p.grad is not None) / max(len(stayed), 1)
    print(f"phase train (4): super_train_step on the musev_referencenet_pose bundle: loss "
          f"{super_loss.item():.4f}, {super_s:.2f} s, peak {super_peak:.1f} GB, launches "
          f"{super_launches}; grads per module {grads}; sampled params after the step equal "
          f"p - lr * g {applied}; share moved {moved}; share of the unmoved whose lr * |g| is "
          f"under half the float32 spacing in every element {below}")
    if any(super_launches[name] for name in NORM_PLAIN):
        fail(f"the super bundle's step ran a norm's plain composition: {super_launches}")
    ok = math.isfinite(super_loss.item()) and all(
        g["finite"] and g["reached"] > 0 and not g["zero"] for g in grads.values())
    if not ok or not all(applied.values()):
        fail(f"the super bundle's step is not finite, reached a module in part or was not "
             f"applied: {grads}, {applied}")
    del bundle, batch, samples, befores
    torch.cuda.empty_cache()

    record.update(
        unet_params=n_params, clip=list(TRAIN_CLIP), losses=losses, step_s=times,
        median_step_s=statistics.median(times), peak_gb=peak_gb, launches=launches,
        launches_per_step=per_step, profile=profile,
        busy_share=None if profile.get("device_ms") is None
        else profile["device_ms"] / profile["wall_ms"],
        checkpoint=dict(gb=ckpt_gb, save_s=save_s, load_s=load_s, bit_for_bit=same),
        super=dict(loss=super_loss.item(), s=super_s, peak_gb=super_peak,
                   launches=super_launches, grads=grads, applied=applied, moved_share=moved,
                   unmoved_below_spacing_share=below),
        narrow=train_narrow(torch), s=time.time() - t0)
    print(f"phase train: {record['s']:.1f} s")
    return record


def phase_serve(torch, rerun_frames: int, need: tuple) -> dict:
    """The serving callables (see the module docstring, phase 11). Returns
    its record."""
    import numpy as np

    from musev_torch.models.unet3d import unet3d_apply
    from musev_torch.pipelines.loader import build_models
    from musev_torch.pipelines.pipeline import MusevPipeline
    from musev_torch.schedulers.ancestral import DDIMScheduler
    from musev_torch.serve.app import OnlineInference
    from musev_torch.utils.inversion import ddim_inversion

    t0 = time.time()
    pipe = MusevPipeline(build_models("musev", seed=0))
    server = OnlineInference(pipe, fps=12, time_size=12)
    prompt, size = T2V_ARGS["prompt"], T2V_ARGS["height"]
    frames, serve_s, launches, peak_gb = timed_run(torch, lambda: server.online_t2v_inference(
        prompt, None, seed=0, w=size, h=size, video_length=SERVE_FRAMES))
    shots = -(-SERVE_FRAMES // server.time_size)
    res = pipe.text2video(prompt, height=size, width=size, video_length=server.time_size,
                          n_batch=shots, condition_images=None, seed=0)
    n_cond = res.videos.shape[1] - shots * server.time_size
    want = (res.videos[0, :n_cond + SERVE_FRAMES] * 255).astype(np.uint8)
    diff = int(np.abs(frames.astype(np.int16) - want).max()) if frames.shape == want.shape \
        else None
    print(f"phase serve: online_t2v_inference of {SERVE_FRAMES} frames at {size}^2 in {shots} "
          f"shots: {serve_s:.2f} s, peak {peak_gb:.1f} GB, frames {frames.shape}, launches "
          f"{launches}; against MusevPipeline.text2video called directly: max |diff| {diff} "
          f"(the path's rerun spread {rerun_frames})")
    if frames.shape != (n_cond + SERVE_FRAMES, size, size, 3) or diff is None \
            or diff > rerun_frames:
        fail(f"the served frames {frames.shape} differ from the direct call by {diff}")
    for name in need:
        if launches[name] <= 0:
            fail(f"the served clip launched {name} no time")

    text_c, _ = pipe.encode_prompt_pair([prompt], [""])
    sched = DDIMScheduler.create(INVERSION_STEPS)
    latents = torch.from_numpy(res.latents).cuda().to(pipe.m.dtype)
    t1 = time.time()
    with torch.inference_mode():
        traj = ddim_inversion(sched, latents, lambda x, t: unet3d_apply(pipe.m.unet, x, t, text_c))
        finite = all(bool(torch.isfinite(x.float()).all()) for x in traj)
    torch.cuda.synchronize()
    inv_s = time.time() - t1
    print(f"phase serve: ddim_inversion of the clip's latents {tuple(latents.shape)} over "
          f"{INVERSION_STEPS} steps: {inv_s:.2f} s, {len(traj)} latents, finite {finite}")
    if not finite:
        fail("the DDIM inversion gave non-finite latents")
    del pipe, server, res, traj, latents
    torch.cuda.empty_cache()
    record = dict(clip_s=serve_s, peak_gb=peak_gb, launches=launches, frames=list(frames.shape),
                  max_frame_diff=diff, rerun_frame_change=rerun_frames, inversion_s=inv_s,
                  inversion_steps=INVERSION_STEPS, s=time.time() - t0)
    print(f"phase serve: {record['s']:.1f} s")
    return record


@contextlib.contextmanager
def float32_references(torch):
    """Float32 stand-ins for the kernels (which take bf16 only), for a
    float32 reference call of the UNet on the card: SDPA for flash
    attention (a library call, here only as a reference), the plain
    versions of the short-attention kernel, the pivots and the norms; TF32
    off."""
    import torch.nn.functional as F

    from musev_torch.models import common, unet_blocks
    from musev_torch.ops import attention as attention_mod
    from musev_torch.ops.kernels import norm
    from musev_torch.ops.kernels.pivot import pivot_rows_plain, unpivot_rows_plain
    from musev_torch.ops.kernels.short_attention import short_attention_plain
    from musev_torch.parallel import frame_parallel

    def sdpa(q, k, v, scale=None):
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), scale=scale).transpose(1, 2)

    patches = [(attention_mod, "flash_attention", sdpa),
               (unet_blocks, "short_attention_packed", short_attention_plain)]
    patches += [(common, name, getattr(norm, f"{name}_plain"))
                for name in ("group_norm", "group_norm_scale_shift", "layer_norm")]
    for mod in (unet_blocks, frame_parallel):
        patches += [(mod, "pivot_rows", pivot_rows_plain), (mod, "unpivot_rows", unpivot_rows_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def phase_parallel(torch, tmp: Path) -> dict:
    """The multi-device topologies on one card (see the module docstring,
    phase 12). Returns its record."""
    import numpy as np
    import torch.distributed as dist

    from musev_torch.models.unet3d import UNet3D, musev_config, unet3d_apply
    from musev_torch.models.unet_blocks import TemporalConvLayer, TemporalTransformer
    from musev_torch.models.vae import AutoencoderKL, VAEConfig, vae_decode_video
    from musev_torch.ops import attention as attention_mod
    from musev_torch.ops.context import make_window_plan
    from musev_torch.ops.kernels.flash_attention import flash_attention
    from musev_torch.parallel import frame_parallel as fp
    from musev_torch.parallel.mesh import make_mesh, set_mesh
    from musev_torch.parallel.ring_attention import ring_attention, ring_attention_local
    from musev_torch.pipelines import denoiser
    from musev_torch.pipelines.loader import init_random_
    from musev_torch.schedulers.euler_discrete import EulerDiscreteScheduler

    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(12)
    unet = UNet3D(musev_config()).to("cuda", torch.bfloat16).eval()
    init_random_(unet, gen, scale=0.02)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen, dtype=torch.bfloat16)

    rows, frames = 2 * FP_WINDOWS, 12
    sample, cond, text = rand(rows, frames, 72, 72, 4), rand(rows, 1, 72, 72, 4), \
        rand(rows, 77, 768)
    kw = dict(condition_latents=cond, gen_index=tuple(range(1, frames + 1)), cond_index=(0,),
              do_cfg=True)
    by_shape = {}
    real_flash = attention_mod.flash_attention

    def classified(q, k, v, scale=None):
        # each call launches once on CUDA: K1 self-attention, K3 the longer
        # concat KV, and the short KV of cross-attention
        kind = "K1" if k.shape[1] == q.shape[1] else ("K3" if k.shape[1] > q.shape[1]
                                                      else "short KV")
        by_shape[kind] = by_shape.get(kind, 0) + 1
        return real_flash(q, k, v, scale=scale)

    record = dict(stub={})
    calls = [("unsharded", lambda: unet3d_apply(unet, sample, 500.0, text, **kw))]
    for n in FP_STUB_DEVICES:
        calls.append((f"stub n={n}", lambda n=n: fp.unet3d_apply_fp(
            unet, sample, 500.0, text, comm=fp.StubComm(n), **kw)))
    attention_mod.flash_attention = classified
    try:
        with torch.inference_mode():
            for name, call in calls:
                by_shape.clear()
                zero_counts()
                out = call()
                torch.cuda.synchronize()
                launches, shapes = read_counts(), dict(by_shape)
                finite = bool(torch.isfinite(out.float()).all())
                if out.shape != (rows, frames + 1, 72, 72, 4) or not finite:
                    fail(f"phase parallel {name}: output {tuple(out.shape)}, finite {finite}")
                ms = cuda_ms(torch, call, warmup=0, iters=FP_RUNS)
                # busy: the profiled call's kernel time over the unprofiled
                # calls' event span (the profiler's own host work would
                # stretch its wall)
                profile, _ = profile_path(torch, lambda: call(), {})
                busy = None if profile["device_ms"] is None else profile["device_ms"] / ms
                entry = dict(ms=ms, busy_share=busy, launches=launches, flash_by_kv=shapes,
                             profile_wall_ms=profile["wall_ms"],
                             profile_device_ms=profile["device_ms"])
                if name != "unsharded":
                    n = int(name.split("=")[1])
                    meta_local = 2 * -(-FP_WINDOWS * (frames + 1) // n)
                    entry.update(rows_per_device=meta_local, derived=fp.fp_collective_model(
                        unet.cfg, t=frames + 1, h0=72, w0=72, n=n, n_windows=FP_WINDOWS,
                        do_cfg=True, n_vc=1, itemsize=2))
                    need = dict(K1=shapes.get("K1", 0), K3=shapes.get("K3", 0),
                                K4=launches["short_attention"], K6=launches["pivot_rows_gn"],
                                K7=launches["unpivot_rows"])
                    entry["kernel_launches"] = need
                    for kernel, count in need.items():
                        if count <= 0:
                            fail(f"phase parallel {name} launched {kernel} no time")
                record["stub"][name] = entry
                d = entry.get("derived")
                print(f"phase parallel {name}: {entry.get('rows_per_device', rows * 13)} rows "
                      f"on the card, {ms:.1f} ms a UNet call (median of {FP_RUNS}), busy "
                      f"{'not measured' if busy is None else f'{busy:.1%}'}; launches a call "
                      f"{launches}, flash by KV {shapes}"
                      + ("" if d is None else
                         f"; derived per step: {d['bytes_per_step'] / 1e6:.1f} MB over "
                         f"{d['collectives_per_step']} collectives {d['counts_by_kind']}"))
                del out
    finally:
        attention_mod.flash_attention = real_flash
    torch.cuda.empty_cache()

    # the real collectives over an NCCL group of one rank
    dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl_init", rank=0,
                            world_size=1)
    try:
        init_random_(unet, gen, scale=SPLIT_WEIGHT_SCALE)
        fp_mesh = make_mesh((1,), ("fp",))
        fp_check, nccl_launches = {}, None
        # at the reference's temporal weights (1e-5) and with the temporal
        # layers weighted 1 (98 % of the output there): the program over
        # NCCL against the unsharded call, in float32 with float32
        # references for the kernels (the semantics), and in bf16 with the
        # kernels, each bf16 output against the float32 unsharded one
        for weighting in ("reference", "temporal 1"):
            if weighting == "temporal 1":
                for m in unet.modules():
                    if isinstance(m, (TemporalTransformer, TemporalConvLayer)):
                        m.temporal_weight.data.fill_(1.0)
            with torch.inference_mode():
                zero_counts()
                with set_mesh(fp_mesh):
                    got = fp.unet3d_apply_fp(unet, sample, 500.0, text, axis="fp", **kw).float()
                torch.cuda.synchronize()
                nccl_launches = read_counts()
                want = unet3d_apply(unet, sample, 500.0, text, **kw).float()
                with float32_references(torch):
                    unet32 = copy.deepcopy(unet).float()
                    kw32 = dict(kw, condition_latents=cond.float())
                    want32 = unet3d_apply(unet32, sample.float(), 500.0, text.float(), **kw32)
                    with set_mesh(fp_mesh):
                        got32 = fp.unet3d_apply_fp(unet32, sample.float(), 500.0, text.float(),
                                                   axis="fp", **kw32)
                    del unet32
            if not (torch.isfinite(got).all() and torch.isfinite(got32).all()):
                fail(f"the frame-parallel program over NCCL ({weighting}) is not finite")
            fp_check[weighting] = dict(
                float32=rel_l2(torch, got32, want32),
                bf16_unsharded_vs_float32=rel_l2(torch, want, want32),
                bf16_fp_vs_float32=rel_l2(torch, got, want32),
                bf16_fp_vs_unsharded=rel_l2(torch, got, want))
            del got, want, got32, want32
            torch.cuda.empty_cache()
        print("phase parallel NCCL-1 fp: unet3d_apply_fp against unet3d_apply, "
              + "; ".join(f"{w}: float32 relative L2 {c['float32']:.3e} (tol "
                          f"{FP_FLOAT32_L2}); bf16 against float32 {c['bf16_fp_vs_float32']:.4e}"
                          f", the unsharded call's {c['bf16_unsharded_vs_float32']:.4e} (tol "
                          f"x{1 + FP_BF16_MARGIN}); bf16 against bf16 "
                          f"{c['bf16_fp_vs_unsharded']:.3e} (within 1e-2: "
                          f"{c['bf16_fp_vs_unsharded'] <= 1e-2})" for w, c in fp_check.items())
              + f"; launches {nccl_launches}")
        for w, c in fp_check.items():
            if not (c["float32"] <= FP_FLOAT32_L2 and c["bf16_fp_vs_float32"]
                    <= (1 + FP_BF16_MARGIN) * c["bf16_unsharded_vs_float32"]):
                fail(f"the frame-parallel program over NCCL disagrees ({w}): {c}")

        dp_mesh = make_mesh((1,), ("dp",))
        latents = torch.randn(1, 24, 72, 72, 4, device="cuda", generator=gen) * 14.6
        text_uc, text_c = rand(1, 77, 768), rand(1, 77, 768)
        spec = dict(unet_cfg=unet.cfg, scheduler=EulerDiscreteScheduler.create(10),
                    plan=make_window_plan(24, 12, context_overlap=4),
                    guidance=np.full((10,), 3.5, np.float32), n_vision_cond=1)
        with torch.inference_mode():
            outs = {}
            for name, axes in (("dp", dict(dp_axis="dp")), ("none", {})):
                with set_mesh(dp_mesh):
                    outs[name] = denoiser.predict_noise(
                        unet, denoiser.DenoiseSpec(**spec, **axes), latents, 0, text_uc,
                        text_c, condition_latents=cond[:1].float())
        dp_equal = bool(torch.equal(outs["dp"], outs["none"]))
        print(f"phase parallel NCCL-1 dp: predict_noise under dp_axis bit for bit {dp_equal}")
        if not dp_equal:
            fail("predict_noise under dp_axis differs from the call without it")
        del outs

        q, k, v = flash_inputs(torch, gen, "qkv", 39, 8, 5184, 5184, 40)
        with torch.inference_mode():
            ring_attention.launches = 0
            ring_out = ring_attention(q, k, v, dist.group.WORLD)
            torch.cuda.synchronize()
            ring_launches = {1: ring_attention.launches}
            whole = flash_attention(q, k, v)
            ring_err = {1: compare("phase parallel NCCL-1 ring_attention (L0 self)", ring_out,
                                   whole)}
            # the ring's n-step loop and merges at n > 1, every rank's K/V
            # shards on this card (no transfer crosses ranks)
            for n in FP_STUB_DEVICES:
                ks, vs = k.chunk(n, dim=1), v.chunk(n, dim=1)
                ring_attention.launches = 0
                ring_out = torch.cat([ring_attention_local(q.chunk(n, dim=1)[r], ks, vs, r)
                                      for r in range(n)], dim=1)
                torch.cuda.synchronize()
                ring_launches[n] = ring_attention.launches
                ring_err[n] = compare(f"phase parallel ring_attention_local n={n} (L0 self)",
                                      ring_out, whole)
        if any(ring_launches[n] != n * n for n in ring_launches):
            fail(f"ring attention launched its kernel {ring_launches} times (n^2 a ring)")
        del q, k, v, ring_out, whole

        vae = AutoencoderKL(VAEConfig()).to("cuda", torch.bfloat16).eval()
        init_random_(vae, gen, scale=0.02)
        vae_lat = rand(1, 25, 72, 72, 4)
        with torch.inference_mode():
            zero_counts()
            sharded = vae_decode_video(vae, vae_lat, 16, mesh=dp_mesh, axis="dp")
            torch.cuda.synchronize()
            vae_launches = read_counts()
            whole = vae_decode_video(vae, vae_lat, 16)
        vae_equal = bool(torch.equal(sharded, whole))
        print(f"phase parallel NCCL-1 VAE: the frame-sharded decode of 25 frames bit for bit "
              f"{vae_equal}, launches {vae_launches}")
        if not vae_equal or vae_launches["flash_attention"] <= 0:
            fail(f"the sharded VAE decode: equal {vae_equal}, launches {vae_launches}")
        del vae, sharded, whole
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    record.update(nccl_fp=fp_check, nccl_fp_launches=nccl_launches,
                  nccl_dp_bit_for_bit=dp_equal,
                  ring={n: dict(ring_err[n], launches=ring_launches[n]) for n in ring_err},
                  nccl_vae_bit_for_bit=vae_equal, nccl_vae_launches=vae_launches,
                  s=time.time() - t0)
    print(f"phase parallel: {record['s']:.1f} s")
    return record


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if not (ROOT / "musev_torch" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repository (musev_torch/ missing)")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    t0 = time.time()
    card, build = phase_build(torch)
    rows, exp2_floors = phase_kernels(torch)
    need = ("flash_attention", "short_attention", "pivot_rows_gn", "unpivot_rows",
            "group_norm", "group_norm_silu", "group_norm_scale_shift", "layer_norm")
    paths = {}
    paths["musev"], models, _ = phase_path(torch, "musev", "text2video", T2V_ARGS, need)
    del models
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="_cli_phase_", dir=ROOT) as tmp:
        paths["cli"], files = phase_cli(torch, Path(tmp), paths["musev"]["rerun_frame_change"],
                                        need)
        paths["adapters"] = phase_adapters(torch, Path(tmp), files, need)
    rng = np.random.default_rng(0)
    image = rng.uniform(0, 255, (1, 1, 576, 576, 3)).astype(np.float32)
    paths["musev_referencenet"], models, _ = phase_path(
        torch, "musev_referencenet", "text2video", dict(T2V_ARGS, condition_images=image), need)
    split = phase_split(torch, models)
    del models
    torch.cuda.empty_cache()
    pose_frames = rng.integers(0, 256, (24, 576, 576, 3), dtype=np.uint8)
    v2v_args = dict(V2V_ARGS, video_frames=pose_frames, condition_images=image,
                    refer_image=image[:, 0], ip_adapter_image=image[:, 0])
    pose = "musev_referencenet_pose"
    paths[pose], models, res = phase_path(torch, pose, "video2video", v2v_args, need)
    paths[pose]["zeroed_pose_latent_change"] = phase_pose_control(
        torch, models, v2v_args, res, paths[pose]["rerun_latent_change"])
    del models, res
    torch.cuda.empty_cache()
    ref_err = phase_reference(torch)
    with tempfile.TemporaryDirectory(prefix="_onnx_phase_", dir=ROOT) as tmp:
        onnx, face_emb = phase_onnx(torch, Path(tmp), image, pose_frames, need)
    paths["onnx: dwpose video2video CLI"] = onnx["dwpose clip"]
    with tempfile.TemporaryDirectory(prefix="_options_phase_", dir=ROOT) as tmp:
        options = phase_options(torch, Path(tmp), image, pose_frames, face_emb, need)
    paths.update(options)
    with tempfile.TemporaryDirectory(prefix="_train_phase_", dir=ROOT) as tmp:
        paths["train"] = phase_train(torch, Path(tmp))
    rows["flash_attention_train"] = paths["train"].pop("attention")
    paths["serve"] = phase_serve(torch, paths["musev"]["rerun_frame_change"], need)
    with tempfile.TemporaryDirectory(prefix="_parallel_phase_", dir=ROOT) as tmp:
        parallel = phase_parallel(torch, Path(tmp))

    # launches: this slice's path (phase parallel's frame-parallel UNet call
    # over NCCL) for the kernels it runs (flash, K4, K6, K7); phase train's
    # timed AdamW steps for flash with stats under autograd and K5; phase
    # onnx's dwpose clip for the others; the split UNet call for the
    # split-merge route, which no path takes under the default carry
    split_counts = split[f"N(0, {SPLIT_WEIGHT_SCALE})"]["launches"]["split"]
    path_counts = dict(onnx["dwpose clip"]["launches"])
    path_counts["flash_attention_parts"] = split_counts["flash_attention_parts"]
    for name in ("flash_attention_train", "pivot_rows"):
        path_counts[name] = paths["train"]["launches"][name]
    for name in ("flash_attention", "short_attention", "pivot_rows_gn", "unpivot_rows"):
        path_counts[name] = parallel["nccl_fp_launches"][name]
    stub8 = parallel["stub"][f"stub n={FP_STUB_DEVICES[-1]}"]["launches"]
    by_path = {name: dict({p: paths[p]["launches"][name] for p in paths},
                          **{"split UNet call": split_counts[name],
                             f"parallel: one stub rank's UNet call, n = {FP_STUB_DEVICES[-1]}":
                                 stub8[name],
                             "parallel: NCCL-1 fp UNet call":
                                 parallel["nccl_fp_launches"][name]})
               for name in KERNELS}

    def entry(name, source, replaces, head_site=None, **extra):
        sites = rows[name]
        head = next((r for r in sites if r["site"] == head_site), sites[0])
        return dict(name=name, route="cuda", source=source, replaces=replaces, **extra,
                    launches=path_counts[name], launches_by_path=by_path[name],
                    max_abs_err=max(r["max_abs_err"] for r in sites),
                    ms=head["ms"], device_ms=head["device_ms"], plain_ms=head["plain_ms"],
                    bound_ms=head["bound_ms"],
                    bound_by=head["bound_by"], library_ms=head["library_ms"],
                    library_device_ms=head["library_device_ms"], site=head["site"], sites=sites)

    flash_py = "musev_tpu/ops/pallas/flash_attention.py"
    pivot_py = "scripts/bench_fused_transpose.py"
    kernels = [
        entry("flash_attention", "musev_torch/csrc/flash_attention.cu", f"{flash_py}:77,297"),
        entry("flash_attention_parts", "musev_torch/csrc/flash_attention.cu", f"{flash_py}:77",
              LONGKV_HEAD, variant="with_stats=True, merged by _merge_parts (:589)"),
        entry("flash_stream", "musev_torch/csrc/flash_stream.cu", f"{flash_py}:165",
              LONGKV_HEAD, plan=build["stream_plans"]),
        entry("short_attention", "musev_torch/csrc/short_attention.cu",
              "musev_tpu/ops/pallas/short_attention.py:39"),
        entry("pivot_rows", "musev_torch/csrc/pivot.cu", f"{pivot_py}:70", POSE_HEAD,
              variant="without scale/shift: the inference paths fuse the GroupNorm apply "
              "(K6); the training path's backward runs it (K7's backward)"),
        entry("pivot_rows_gn", "musev_torch/csrc/pivot.cu", f"{pivot_py}:75", POSE_HEAD),
        entry("unpivot_rows", "musev_torch/csrc/pivot.cu", f"{pivot_py}:113", POSE_HEAD),
        entry("flash_attention_train", "musev_torch/csrc/flash_attention.cu",
              f"{flash_py}:77,297", variant="with_stats=True (:79-80) as the forward of "
              "ops.attention.MemEfficientAttention, the training route; its backward is "
              "plain PyTorch"),
        entry("group_norm_silu", "musev_torch/csrc/norm.cu", "none (XLA's GroupNorm)",
              variant="K8: statistics, their merge, the apply with SiLU"),
        entry("group_norm", "musev_torch/csrc/norm.cu", "none (XLA's GroupNorm)",
              variant="K8 without SiLU"),
        entry("group_norm_scale_shift", "musev_torch/csrc/norm.cu", "none (XLA's GroupNorm)",
              variant="K8's statistics and merge alone: scale and shift for K6"),
        entry("layer_norm", "musev_torch/csrc/norm.cu", "none (XLA's LayerNorm)",
              variant="K9"),
    ]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        dict(card=card, device=device, build=build, kernels=kernels,
             computed_exp2_floor_ms=exp2_floors, paths=paths, split=split,
             reference_rel_err=ref_err, onnx={k: v for k, v in onnx.items()
                                              if k != "dwpose clip"},
             parallel=parallel, total_s=time.time() - t0), indent=1))
    print(f"total {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
