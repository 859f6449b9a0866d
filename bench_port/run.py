"""Run one cell of the benchmark of ``musev_torch`` once, on the machine it
is started on, and print its result as the last line of standard output.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json`` at the checkout's root; its
configuration, traffic mix, limits and metric readers are files under
``bench_port/`` found by name (``harness/spec.py``). With ``--trace 0`` the
line carries the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics from a traced window. Exits non-zero, printing no result, without as
many CUDA devices as the cell asks for, without the program, or if JAX or the
JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.time()  # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "musev_tpu")


def _environment() -> None:
    """Caches inside the checkout at fixed paths; no library loads JAX."""
    cache = ROOT / ".bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))


def loaded_forbidden() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> object:
    """The card's power limit in W from nvidia-smi, or None where it cannot be read."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    _environment()

    from bench_port.harness.spec import load_cell

    cell = load_cell(a.workload, ROOT / "BENCHMARK.json")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{a.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    try:
        import musev_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is not in this checkout: {e}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    from bench_port.harness import runner

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    limit_w = power_limit()
    head, rec, checks = runner.run(cell, a.seed, a.seconds, bool(a.trace), T0, log=log)
    metrics = {}
    for m in (cell.per_layer if a.trace else cell.end_to_end):
        value = m.reader()(rec)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=cell.chips,
                  memory_peak_bytes=rec.peak_bytes, power_limit_w=limit_w)
    for key in ("busy_s", "window_s"):
        if key in head:
            device[key] = head.pop(key)
    breakdown = head.pop("breakdown", None)
    bad = loaded_forbidden()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    result = dict(head, metrics=metrics, device=device)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    for name, (v, lim) in checks.items():
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
