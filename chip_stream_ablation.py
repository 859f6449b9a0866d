#!/usr/bin/env python3
"""Ablation of the streaming kernel's cluster design on one NVIDIA GPU.

    python3 chip_stream_ablation.py

Run from the root of a checkout on a machine with a CUDA device and nvcc.
Builds variants of ``musev_torch/csrc/flash_stream.cu`` made by text
substitution (each beside a copy of ``flash_common.cuh``, under ``OUT``, all
nvcc at once), prints each variant's ptxas registers and spills, the fences
in its SASS and its clusters against the card's SMs, and times each against
``flash_attention`` (K3) at the long-KV and short-KV sites, K3 timed just
before each so that the card's drift cancels in the ratio:

- ``final``: the source as it is (the fixed cluster size per head dim);
- ``cn1`` .. ``cn4``: every instance in clusters of 1 to 4 CTAs, each K/V
  tile issued whole by CTA kv mod CN;
- ``cn2_split`` .. ``cn4_split``: the same, each CTA issuing a share of
  every tile (slab s of tile kv by CTA (kv + s) mod CN);
- ``consumer_release``: the fixed plan without the forwarding thread; lane
  r of every consumer warp releases the slot on CTA r's barrier itself
  (4 x NC x CN arrivals a use), and the issuing thread waits on that barrier;
- ``consumer_release_cluster_scope``: the same with
  ``mbarrier.arrive.release.cluster``.

Times are device times (torch.profiler, every launch recorded) and CUDA-event
times. Each variant is checked against K3 (relative L2 <= 1e-2). Results go
to ``stream_ablation.json`` beside ``OUT``, in the directory where
``chip_smoke.py`` writes its record.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "stream_ablation"
SITES = [  # (site, projection, B, H, sq, sk, d), as chip_smoke.FLASH_SITES
    ("L0 ReferenceOnly cond half", "q|kv", 39, 8, 5184, 10368, 40),
    ("L0 ReferenceNet fuse", "q|kv", 78, 8, 5184, 10368, 40),
    ("L0 cross-attn (77 text tokens)", "q|kv", 78, 8, 5184, 77, 40),
    ("L1 ReferenceNet fuse", "q|kv", 78, 8, 1296, 2592, 80),
    ("L2 ReferenceOnly cond half", "q|kv", 39, 8, 324, 648, 160),
]
PLAN = "constexpr int kClusterSize[4] = {2, 2, 2, 3};"
RELEASE = '''// Lane r of the calling warp arrives on the barrier at `bar`'s offset in
// CTA r of the cluster, for r below the cluster's size.
__device__ __forceinline__ void release_to_cluster(uint64_t* bar) {
  asm volatile(
      "{\\n.reg .pred p;\\n.reg .b32 lane, n, remote;\\n"
      "mov.u32 lane, %%laneid;\\n"
      "mov.u32 n, %%cluster_nctarank;\\n"
      "setp.lt.u32 p, lane, n;\\n"
      "@p mapa.shared::cluster.u32 remote, %0, lane;\\n"
      "@p mbarrier.arrive{sem}.shared::cluster.b64 _, [remote];\\n}\\n" ::"r"(smem_addr(bar))
      : "memory");
}

'''


def cluster_size(cn: int) -> list:
    return [(PLAN, f"constexpr int kClusterSize[4] = {{{cn}, {cn}, {cn}, {cn}}};")]


SPLIT = [
    ("          if (r == cluster_rank())", "          if ((r + s) % CN == cluster_rank())"),
    ("&full_v[st], kv % CN,", "&full_v[st], (kv + kSlabs) % CN,"),
]


def consumer_release(sem: str) -> list:
    return [
        ("// Shared memory: the flash kernel's layout (Config)",
         RELEASE.replace("{sem}", sem) + "// Shared memory: the flash kernel's layout (Config)"),
        ("mbar_init(&empty_k[s], 128 * NC);", "mbar_init(&empty_k[s], 4 * NC * CN);"),
        ("mbar_init(&empty_v[s], 128 * NC);", "mbar_init(&empty_v[s], 4 * NC * CN);"),
        ("mbar_wait(&cluster_empty_k[st], ph ^ 1);", "mbar_wait(&empty_k[st], ph ^ 1);"),
        ("mbar_wait(&cluster_empty_v[st], ph ^ 1);", "mbar_wait(&empty_v[st], ph ^ 1);"),
        ("} else if (threadIdx.x == 32) {", "} else if (threadIdx.x == 32 && false) {"),
        ("auto release_k = [&](int j) { mbar_arrive(&empty_k[(kv0 + j) % NS]); };",
         "auto release_k = [&](int j) { release_to_cluster(&empty_k[(kv0 + j) % NS]); };"),
        ("auto release_v = [&](int j) { mbar_arrive(&empty_v[(kv0 + j) % NS]); };",
         "auto release_v = [&](int j) { release_to_cluster(&empty_v[(kv0 + j) % NS]); };"),
    ]


VARIANTS = {
    "final": [],
    **{f"cn{cn}": cluster_size(cn) for cn in (1, 2, 3, 4)},
    **{f"cn{cn}_split": cluster_size(cn) + SPLIT for cn in (2, 3, 4)},
    "consumer_release": consumer_release(""),
    "consumer_release_cluster_scope": consumer_release(".release.cluster"),
}


def fail(msg: str) -> None:
    print(f"chip_stream_ablation: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def build(variants: dict, nvcc: str, flags) -> dict:
    """All variants' nvcc at once; returns {name: (library path, output)}."""
    src = (ROOT / "musev_torch" / "csrc" / "flash_stream.cu").read_text()
    jobs = {}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                fail(f"variant {name}: {old!r} is not in the source once")
            text = text.replace(old, new)
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "flash_stream.cu").write_text(text)
        shutil.copy(ROOT / "musev_torch" / "csrc" / "flash_common.cuh", d)
        cmd = [nvcc, *flags, "-Xptxas", "-v", "-o", str(d / "lib.so"), str(d / "flash_stream.cu")]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    done = {}
    for name, proc in jobs.items():
        out, _ = proc.communicate()
        (OUT / name / "nvcc.txt").write_text(out)
        if proc.returncode:
            fail(f"nvcc failed for {name}:\n{out[-3000:]}")
        done[name] = (OUT / name / "lib.so", out)
    return done


def fences(lib: Path) -> dict:
    """MEMBAR and CCTL instructions in the SASS of the streaming kernels."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts = {}
    for op in re.findall(r"\b((?:MEMBAR|CCTL)\.[A-Z.]+)", sass):
        counts[op] = counts.get(op, 0) + 1
    return counts


def load(lib_path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(lib_path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.musev_flash_stream_bf16.argtypes = [p, p, p, p, i, i, i, i, i, ll, ll, ll, ll, ll, ll,
                                            ll, ll, ll, ctypes.c_float, p]
    lib.musev_flash_stream_bf16.restype = ctypes.c_int
    lib.musev_flash_stream_plan.argtypes = [i, ctypes.POINTER(ctypes.c_int)]
    lib.musev_flash_stream_plan.restype = ctypes.c_int
    lib.musev_cuda_error_string.argtypes = [i]
    lib.musev_cuda_error_string.restype = ctypes.c_char_p
    return lib


def ratio_text(x) -> str:
    return "not measured" if x is None else f"{x:.3f}"


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
    import chip_smoke as cs
    from musev_torch.ops.kernels import _build
    from musev_torch.ops.kernels import flash_stream as fs
    from musev_torch.ops.kernels.flash_attention import flash_attention

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    built = build(VARIANTS, _build._nvcc(), _build.NVCC_FLAGS)
    libs = {name: load(path) for name, (path, _) in built.items()}
    record = dict(card=card, sms=sms, variants={}, sites={})
    default_lib = fs._lib
    try:
        for name, (path, out) in built.items():
            fs._lib = lambda lib=libs[name]: lib
            regs = {k.split("flash_stream_kernel")[-1]: v
                    for k, v in cs.ptxas_report(out).items() if "flash_stream_kernel" in k}
            plans = {d: fs.plan(d) for d in cs.STREAM_HEAD_DIMS}
            record["variants"][name] = dict(ptxas=regs, fences=fences(path), plans=plans)
            print(f"{name}: ptxas {regs}; fences {record['variants'][name]['fences']}; "
                  "clusters x size per head dim: " + ", ".join(
                      f"d={d} {p['active_clusters']} x {p['cluster_size']} = "
                      f"{p['active_clusters'] * p['cluster_size']}" for d, p in plans.items())
                  + f" of {sms} SMs")

        gen = torch.Generator(device="cuda").manual_seed(0)
        for site, proj, b, h, sq, sk, d in SITES:
            q, k, v = cs.flash_inputs(torch, gen, proj, b, h, sq, sk, d)
            want = flash_attention(q, k, v).float()

            def k3():
                return flash_attention(q, k, v)

            def run():
                return fs.flash_stream(q, k, v)

            rows = {}
            for name in built:
                fs._lib = lambda lib=libs[name]: lib
                err = ((run().float() - want).norm() / want.norm()).item()
                if not err <= 1e-2:
                    fail(f"{name} disagrees with K3 at {site}: {err}")
                k3_dev, _ = cs.device_ms(torch, k3, cs.FLASH_FUNCS, 1)
                dev, _ = cs.device_ms(torch, run, ("flash_stream_kernel",), 1)
                k3_ms, ms = cs.cuda_ms(torch, k3), cs.cuda_ms(torch, run)
                ratio = None if dev is None or k3_dev is None else dev / k3_dev
                rows[name] = dict(device_ms=dev, k3_device_ms=k3_dev, device_ratio=ratio, ms=ms,
                                  k3_ms=k3_ms, ratio=ms / k3_ms, rel_l2=err)
            record["sites"][site] = rows
            print(f"{site} (B,H,sq,sk,d)={(b, h, sq, sk, d)}, device ms and / K3 just before "
                  "(events in brackets): " + ", ".join(
                      f"{key} {cs.fmt_ms(r['device_ms'])} ({ratio_text(r['device_ratio'])}) "
                      f"[{r['ms']:.3f}, {r['ratio']:.3f}]" for key, r in rows.items()))
            del q, k, v, want
    finally:
        fs._lib = default_lib
    (OUT.parent / "stream_ablation.json").write_text(json.dumps(record, indent=1))


if __name__ == "__main__":
    main()
