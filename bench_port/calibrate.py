"""Readings that the limits of a cell's comparison are set from, on the chip
at the cell's own sizes, in one process.

    python3 bench_port/calibrate.py --workload <cell> --seeds 11 12 13 \
        --control-seeds 11 12 13 --witness-seeds 11 --out <file.json>

For each seed the program makes clip 0 of that seed's run (the run's weights
and request) and the float32 reference makes it again: the program's
readings. For each control seed the reference computed in float8 e4m3 takes
the program's place (the control: the precision below the configuration's
bfloat16), for each witness seed the reference computed in bfloat16; both
are held against the float32 reference by the same numbers. ``--kernels``
first traces one clip and lists every device kernel's time and launches.
Writes the readings to ``--out`` after every seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def per_frame(got, want) -> list:
    import torch

    got = torch.as_tensor(got, device=want.device, dtype=torch.float32)
    num = torch.linalg.vector_norm((got - want.float())[0].flatten(1), dim=1)
    return (num / torch.linalg.vector_norm(want.float()[0].flatten(1), dim=1)).tolist()


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--witness-seeds", type=int, nargs="*", default=[])
    p.add_argument("--kernels", action="store_true")
    p.add_argument("--out", required=True)
    a = p.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from bench_port.harness import runner, traffic as tr
    from bench_port.harness.spec import load_cell
    from bench_port.harness.trace import DeviceTrace
    from bench_port.harness.weights import draw
    from bench_port.reference.layers import Numerics
    from musev_torch.pipelines.pipeline import MusevPipeline

    cell = load_cell(a.workload, ROOT / "BENCHMARK.json")
    cfg, traffic = cell.config, cell.traffic
    dev, dtype = torch.device("cuda"), getattr(torch, cfg["dtype"])
    out = dict(cell=a.workload, device=torch.cuda.get_device_name(0), program=[], control=[],
               witness=[])

    def save():
        Path(a.out).write_text(json.dumps(out, indent=1))

    models = runner.port_models(cfg, draw(cfg, a.seeds[0], dev, dtype), dev, dtype)
    pipe = MusevPipeline(models)
    runner.run_clip(pipe, tr.warmup(traffic, a.seeds[0]), traffic)
    if a.kernels:
        with DeviceTrace() as t:
            runner.run_clip(pipe, tr.request(traffic, a.seeds[0], 0), traffic)
        table = {}
        for o in t.ops:
            ms, n = table.get(o.name, (0.0, 0))
            table[o.name] = (ms + o.dur_ns / 1e6, n + 1)
        out["kernels"] = sorted(([k, ms, n] for k, (ms, n) in table.items()), key=lambda r: -r[1])
        save()
    for seed in a.seeds:
        t0 = time.perf_counter()
        for name, w in draw(cfg, seed, dev, dtype).items():
            getattr(models, name).load_state_dict(w, strict=True)
        req = tr.request(traffic, seed, 0)
        latents, videos = runner.run_clip(pipe, req, traffic)
        t1 = time.perf_counter()
        runner.free(dev)
        want = runner.reference_clip(cfg, seed, req.args, dev, dtype)
        t2 = time.perf_counter()
        got = runner.compare(latents, videos, want)
        out["program"].append(dict(seed=seed, clip_s=t1 - t0, reference_s=t2 - t1,
                                   latents_per_frame=per_frame(latents, want[0]), **got))
        print("program", seed, got, f"clip {t1 - t0:.1f} s reference {t2 - t1:.1f} s", flush=True)
        save()
        for kind, seeds, precision in (("control", a.control_seeds, "fp8"),
                                       ("witness", a.witness_seeds, "bf16")):
            if seed in seeds:
                t3 = time.perf_counter()
                lat, vid = runner.reference_clip(cfg, seed, req.args, dev, dtype,
                                                 Numerics(precision))
                got = runner.compare(lat, vid, want)
                out[kind].append(dict(seed=seed, precision=precision,
                                      seconds=time.perf_counter() - t3,
                                      latents_per_frame=per_frame(lat, want[0]), **got))
                print(kind, seed, got, flush=True)
                save()
        del want
        runner.free(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
