"""BENCHMARK.json against the contract's form, and the harness finding every
cell's files by name."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from bench_port.harness import spec

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_parses_with_the_contract_keys():
    b = bench()
    assert set(b) == KEYS
    assert b["command"] == ["python3", "bench_port/run.py"]
    assert b["paths"] == ["bench_port"]
    assert 1 <= b["run_seconds"] <= 51
    assert 1 <= len(b["configs"]) <= 24 and 1 <= len(b["workloads"]) <= 24
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units_use_the_allowed_characters():
    b = bench()
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["traffic"] for w in b["workloads"]] + [w["config"] for w in b["workloads"]]
    names += [k for c in b["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    texts = [w["why"] for w in b["workloads"] + b["configs"]] + [m["layer"] for m in b["per_layer"]]
    for text in texts:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_metric_moves_a_reported_metric_and_has_a_bound():
    b = bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_every_cell_finds_its_files_and_readers(cell):
    c = spec.load_cell(cell, ROOT / "BENCHMARK.json")
    assert c.config["name"] == cell.split(".")[0]
    assert set(c.limits) == {"latents_rel_l2", "frames_rel_l2"}
    assert c.traffic["clip"]["height"] == 576
    for m in c.end_to_end + c.per_layer:
        assert callable(m.reader())
    assert {m.name for m in c.end_to_end} >= {"frames_per_s", "setup_s"}
    assert c.per_layer


def test_a_cell_added_as_files_is_picked_up_without_an_edit(tmp_path):
    """A new mix and cell: new files and entries only; the harness finds them."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "bench_port", root / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    traffic = json.loads((root / "bench_port/traffic/i2v-576-24f.json").read_text())
    traffic.update(name="i2v-576-12f", clip=dict(traffic["clip"], video_length=12))
    (root / "bench_port/traffic/i2v-576-12f.json").write_text(json.dumps(traffic))
    cell = "musev_referencenet.i2v-576-12f"
    (root / f"bench_port/workloads/{cell}.json").write_text(
        json.dumps({"name": cell, "limits": {"latents_rel_l2": 0.1, "frames_rel_l2": 0.1}}))
    b["workloads"].append({"name": cell, "config": "musev_referencenet",
                           "traffic": "i2v-576-12f", "chips": 1, "why": "one window"})
    for m in b["per_layer"]:
        if "musev_referencenet.i2v-576-24f" in m["workloads"]:
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    c = spec.load_cell(cell, root / "BENCHMARK.json")
    assert c.traffic["clip"]["video_length"] == 12 and c.limits["latents_rel_l2"] == 0.1
    assert "encoders_ms_per_clip" in {m.name for m in c.per_layer}
