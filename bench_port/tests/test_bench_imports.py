"""Nothing the benchmark loads is JAX or the JAX package, and the reference
loads nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "musev_tpu"}


def loaded_after(code: str) -> set:
    """Top-level names of the modules loaded in a fresh interpreter after ``code``."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_the_harness_and_reference_load_no_jax():
    names = loaded_after(
        "import bench_port.harness.runner, bench_port.harness.spec, bench_port.calibrate\n"
        "import bench_port.reference.pipeline\n"
        "import importlib, pathlib\n"
        "for p in pathlib.Path('bench_port/metrics').glob('*.py'):\n"
        "    importlib.import_module('bench_port.metrics.' + p.stem)\n"
        "import musev_torch.pipelines.loader, musev_torch.pipelines.pipeline")
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = loaded_after("import bench_port.reference.pipeline")
    assert "musev_torch" not in names and not names & FORBIDDEN
    for path in (ROOT / "bench_port" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            assert not {m.split(".")[0] for m in mods} & (FORBIDDEN | {"musev_torch"}), path
