"""What a cell is made of, found by name.

``BENCHMARK.json`` at the checkout's root names the cell's configuration and
traffic mix and lists the metrics; the files are

- ``bench_port/configs/<config>.json``: the sizes (the entry's ``file``);
- ``bench_port/traffic/<traffic>.json``: the mix's parameters;
- ``bench_port/workloads/<cell>.json``: the limits of the cell's comparison;
- ``bench_port/metrics/<metric>.py``: each metric's reader.

A cell, a configuration or a metric is added by adding files and entries;
nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str

    def reader(self):
        """The metric's ``read(record)`` from ``bench_port/metrics/<name>.py``."""
        return importlib.import_module(f"bench_port.metrics.{self.name}").read


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _metrics(entries: list, cell: str) -> List[Metric]:
    return [Metric(m["name"], m["unit"]) for m in entries if cell in m.get("workloads", [cell])]


def load_cell(name: str, benchmark: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``name`` of ``benchmark`` with its files read."""
    bench = json.loads(benchmark.read_text())
    root = benchmark.parent
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {benchmark}; it has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "bench_port" / "traffic" / f"{w['traffic']}.json").read_text())
    cell_file = json.loads((root / "bench_port" / "workloads" / f"{name}.json").read_text())
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                limits=dict(cell_file["limits"]),
                end_to_end=_metrics(bench["end_to_end"], name),
                per_layer=_metrics(bench["per_layer"], name))
