"""Build the CUDA sources under ``musev_torch/csrc`` and load them with ctypes.

Each source is one shared library with a plain C interface, compiled by
``nvcc`` for ``sm_90a`` at first use into ``musev_torch/_build`` (listed in
``.gitignore``). The library name carries a hash of the source, of the
headers under ``csrc`` that it includes, and of the flags, so an edited source
or header is rebuilt and a stale library is never loaded. Nothing is built or
loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _sources(path: Path, seen: Dict[Path, bytes]) -> Dict[Path, bytes]:
    """``path`` and every header it includes with quotes, recursively."""
    if path not in seen:
        seen[path] = text = path.read_bytes()
        for header in re.findall(rb'^\s*#\s*include\s*"([^"]+)"', text, re.M):
            _sources(path.parent / header.decode(), seen)
    return seen


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for text in _sources(CSRC / f"{name}.cu", {}).values():
        h.update(hashlib.sha256(text).digest())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp, target) or None."""
    target = library_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    # -Xptxas -v changes no code: it reports registers and spills per kernel
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, target


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every named source that is not built yet, all nvcc at once;
    every nvcc is waited for before a failure is raised. Returns nvcc's
    output (with ptxas's registers and spills) per source it compiled."""
    with _lock:
        jobs = [(n, _start_build(n)) for n in names]
        errors, outputs = [], {}
        for name, job in jobs:
            if job is None:
                continue
            proc, tmp, target = job
            out, _ = proc.communicate()
            outputs[name] = out
            if proc.returncode == 0:
                os.replace(tmp, target)
            else:
                errors.append(f"nvcc failed for {name}.cu:\n{out}")
        if errors:
            raise RuntimeError("\n".join(errors))
        return outputs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(library_path(name)))
                lib.musev_cuda_error_string.argtypes = [ctypes.c_int]
                lib.musev_cuda_error_string.restype = ctypes.c_char_p
                _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch function returned an error code."""
    if err != 0:
        msg = lib.musev_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed to launch: {msg} (code {err})")
