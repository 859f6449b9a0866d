"""The port imports nothing of JAX or of the JAX package.

A fresh interpreter whose ``sys.meta_path`` refuses ``jax``, ``jaxlib`` and
``musev_tpu`` imports every module of ``musev_torch``. The same finder
refuses the packages the GPU machine may lack (``yaml``, ``PIL``,
``transformers``, ``safetensors``): the port imports them only on the paths
that need them, so a CSV task file still loads.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

GUARDED = """
import importlib, pkgutil, sys

REFUSED = ("jax", "jaxlib", "musev_tpu", "yaml", "PIL", "transformers", "safetensors")


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused import of {name}")
        return None


sys.meta_path.insert(0, Refuse())
import musev_torch

names = sorted(m.name for m in pkgutil.walk_packages(musev_torch.__path__, "musev_torch."))
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked

from musev_torch.configs.tasks import load_tasks

print(len(names), load_tasks(sys.argv[1]))
"""


def test_port_imports_without_jax_or_optional_packages(tmp_path):
    tasks = tmp_path / "tasks.csv"
    tasks.write_text("name,prompt\ncat,a cat walking\n")
    out = subprocess.run([sys.executable, "-c", GUARDED, str(tasks)], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, loaded = out.stdout.split(" ", 1)
    assert int(n) >= 40
    assert "'prompt': 'a cat walking'" in loaded
