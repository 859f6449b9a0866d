#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA device, nvcc and
PyTorch built for CUDA. Phases, each of which fails the script if it fails:

1. build: compile the port's four CUDA sources from ``musev_torch/csrc``
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
   within its rounding bound). Each row has the CUDA-event time of the
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
   weights in float32 on the CPU (the plain path).

Prints the card line, a ``{"kernels": [...]}`` line, and last the line
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout, it
exits non-zero and prints no result. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import importlib
import json
import os
import statistics
import struct
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
# last four on the musev_referencenet path only.
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
           "pivot_rows", "pivot_rows_gn", "unpivot_rows")
# the CUDA functions each wrapper launches, as the profiler names them
FLASH_FUNCS = ("flash_fwd_wgmma_kernel", "flash_fwd_wide_kernel")
DEVICE_FUNCS = dict(flash_attention=FLASH_FUNCS, flash_attention_parts=FLASH_FUNCS,
                    flash_stream=("flash_stream_kernel",), short_attention=("short_attn_kernel",),
                    pivot_rows=("relayout_kernel",), pivot_rows_gn=("relayout_kernel",),
                    unpivot_rows=("relayout_kernel",))
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
        hits = [e for e in prof.key_averages() if e.self_device_time_total > 0
                and (funcs is None or any(f in e.key for f in funcs))]
        n = sum(e.count for e in hits)
        seen.append(n)
        whole = n == iters * per_call if per_call else n > 0 and n % iters == 0
        if whole:
            return sum(e.self_device_time_total for e in hits) / iters / 1e3, seen
    print(f"device time not measured: {seen} launches recorded over {iters} calls of "
          f"{funcs or 'the library call'} (expected "
          f"{iters * per_call if per_call else f'a multiple of {iters}'}); the last try:\n"
          f"{prof.key_averages().table(row_limit=8)}")
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
    ``kernels`` line; ``pivot_rows`` counts K5 and K6 apart."""
    from musev_torch.ops.kernels.flash_attention import flash_attention, flash_attention_parts
    from musev_torch.ops.kernels.flash_stream import flash_stream
    from musev_torch.ops.kernels.pivot import pivot_rows, unpivot_rows
    from musev_torch.ops.kernels.short_attention import short_attention_packed

    return dict(zip(KERNELS, ((flash_attention, "launches"), (flash_attention_parts, "launches"),
                              (flash_stream, "launches"), (short_attention_packed, "launches"),
                              (pivot_rows, "launches"), (pivot_rows, "gn_launches"),
                              (unpivot_rows, "launches"))))


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
    outputs = _build.build(["flash_attention", "short_attention", "flash_stream", "pivot"])
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


def phase_path(torch, preset: str, method: str, args: dict, need: tuple):
    """``MusevPipeline.<method>`` of ``preset`` at full width; fails unless
    the video has the JAX pipeline's shape, is finite in [0, 1], and every
    kernel in ``need`` launched. Returns (record, models, result)."""
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


SAFETENSORS_DTYPES = {"float32": "F32", "float16": "F16", "bfloat16": "BF16"}


def write_safetensors(path: Path, state_dict: dict) -> None:
    """The safetensors format, written tensor by tensor: a little-endian u64
    header size, a JSON header of each tensor's dtype, shape and byte range
    (padded with spaces to 8 bytes), then the raw bytes in that order; the
    port reads the format itself, so its proof writes it without the
    ``safetensors`` package too."""
    import torch

    header, offset = {}, 0
    for name, t in state_dict.items():
        nbytes = t.numel() * t.element_size()
        header[name] = dict(dtype=SAFETENSORS_DTYPES[str(t.dtype).split(".")[-1]],
                            shape=list(t.shape), data_offsets=[offset, offset + nbytes])
        offset += nbytes
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in state_dict.values():  # the standard layout, whatever the memory format
            f.write(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy())




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
                  safetensors_writer="chip_smoke.write_safetensors", checkpoint_gb=gb,
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
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages() if e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    if busy_ms == 0:
        print("phase path profile: the profiler recorded no device time (not measured)")
        return dict(wall_ms=wall_ms, device_ms=None), res
    print(f"phase path profile: wall {wall_ms:.0f} ms (profiled), device busy "
          f"{busy_ms:.0f} ms = {busy_ms / wall_ms:.1%}; top kernels:")
    for key, ms, n in rows[:12]:
        print(f"  {ms:9.1f} ms {ms / busy_ms:6.1%} x{n:<6d} {key[:110]}")
    names = ("flash_fwd_wgmma_kernel", "flash_fwd_wide_kernel", "flash_stream_kernel",
             "short_attn_kernel", "relayout_kernel")
    mine = {name: sum(r[1] for r in rows if name in r[0]) for name in names}
    calls = {name: sum(r[2] for r in rows if name in r[0]) for name in names}
    print(f"  port kernels: ms {mine}, launches {calls}")
    return dict(wall_ms=wall_ms, device_ms=busy_ms, port_kernels_ms=mine,
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


def phase_reference(torch):
    """A narrow UNet (head dims 40/80/160, as on the path) on the card in
    bf16 against the same weights on the CPU in float32."""
    from musev_torch.models.unet3d import UNet3D, UNet3DConfig, unet3d_apply
    from musev_torch.pipelines.loader import init_random_

    t0 = time.time()
    cfg = UNet3DConfig(block_out_channels=(80, 160, 320, 320), layers_per_block=1,
                       cross_attention_dim=64, attention_heads=2, norm_num_groups=8)
    gen = torch.Generator().manual_seed(1)
    cpu = UNet3D(cfg)
    init_random_(cpu, gen, scale=0.05)
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
    rel = ((got - want).norm() / want.norm()).item()
    print(f"phase reference: narrow UNet bf16 card vs fp32 CPU, relative L2 error "
          f"{rel:.2e} (tol 5e-2), {time.time() - t0:.1f} s")
    if not rel <= 5e-2:
        fail(f"narrow UNet on the card disagrees with the CPU: relative error {rel}")
    return rel


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
    need = ("flash_attention", "short_attention", "pivot_rows_gn", "unpivot_rows")
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

    # launches: this slice's path (the LCM + LoRA + TI clip through the CLI)
    # for the kernels it runs; the split UNet call for the split-merge route,
    # which no path takes under the default carry
    split_counts = split[f"N(0, {SPLIT_WEIGHT_SCALE})"]["launches"]["split"]
    path_counts = dict(paths["adapters"]["launches"],
                       flash_attention_parts=split_counts["flash_attention_parts"])
    by_path = {name: dict({p: paths[p]["launches"][name] for p in paths},
                          **{"split UNet call": split_counts[name]})
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
              variant="without scale/shift; the paths fuse the GroupNorm apply (K6)"),
        entry("pivot_rows_gn", "musev_torch/csrc/pivot.cu", f"{pivot_py}:75", POSE_HEAD),
        entry("unpivot_rows", "musev_torch/csrc/pivot.cu", f"{pivot_py}:113", POSE_HEAD),
    ]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        dict(card=card, device=device, build=build, kernels=kernels,
             computed_exp2_floor_ms=exp2_floors, paths=paths, split=split,
             reference_rel_err=ref_err, total_s=time.time() - t0), indent=1))
    print(f"total {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
