"""``run.py`` as the driver calls it."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
CELL = "musev_referencenet.i2v-576-24f"


def run(*args: str, timeout: int) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "bench_port/run.py", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


def test_without_a_card_it_exits_non_zero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = run("--workload", CELL, "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0",
              timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_an_unknown_cell_is_refused():
    out = run("--workload", "no.such-cell", "--seed", "1", "--seconds", "1", timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card_prints_the_contract_line():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = run("--workload", CELL, "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0",
              timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"frames_per_s", "peak_mem_gb", "setup_s"}
