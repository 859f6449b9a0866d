"""The port imports nothing of JAX or of the JAX package.

A fresh interpreter whose ``sys.meta_path`` refuses ``jax``, ``jaxlib`` and
``musev_tpu`` imports every module of ``musev_torch``. The same finder
refuses the packages the GPU machine may lack (``yaml``, ``PIL``,
``transformers``, ``safetensors``, ``gradio``): the port imports them only on the paths
that need them, so a CSV task file still loads. OpenCV, ``onnx`` and
``onnxruntime`` are refused too: the ONNX executor and the host stages
(dwpose, face embedding, SAM) have their own code for what the reference
and the JAX package take from them.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

GUARDED = """
import importlib, pkgutil, sys

REFUSED = ("jax", "jaxlib", "musev_tpu", "yaml", "PIL", "transformers", "safetensors", "cv2",
           "onnx", "onnxruntime", "gradio", "optax", "orbax")


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused import of {name}")
        return None


sys.meta_path.insert(0, Refuse())
import musev_torch

names = sorted(m.name for m in pkgutil.walk_packages(musev_torch.__path__, "musev_torch."))
assert {"musev_torch.schedulers.ancestral", "musev_torch.schedulers.lcm",
        "musev_torch.schedulers.dpm_multistep", "musev_torch.models.lora",
        "musev_torch.utils.textual_inversion", "musev_torch.onnx.runtime",
        "musev_torch.io.dwpose", "musev_torch.io.face_emb", "musev_torch.io.sam",
        "musev_torch.train", "musev_torch.parallel.mesh", "musev_torch.serve.app",
        "musev_torch.utils.checkpoint", "musev_torch.utils.inversion",
        "musev_torch.utils.logging_util", "musev_torch.utils.profiling",
        "musev_torch.parallel.context", "musev_torch.parallel.frame_parallel",
        "musev_torch.parallel.ring_attention", "musev_torch.parallel.sharding"} <= set(names), names
for name in names:
    importlib.import_module(name)
assert musev_torch.make_mesh is musev_torch.parallel.mesh.make_mesh
assert musev_torch.batch_sharding is musev_torch.parallel.mesh.batch_sharding
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
    assert int(n) >= 65
    assert "'prompt': 'a cat walking'" in loaded
